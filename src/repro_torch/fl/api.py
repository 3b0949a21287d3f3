"""The public FL training API: ``Trainer`` + ``TrainState`` (port of
``repro/fl/api.py``).

``TrainState`` holds all loop state: params (a dict in pytree order), the
per-device power limits, the client bank (error-feedback residuals,
lanes and participation counts), the previous round's reconstructed
update ``prev_delta`` (which ``randk_mode="server_topk"`` selects from),
the PRNG key the next call consumes, the round counter, the privacy
ledger and the channel-model carry.

PRNG contract (the reference's): ``init(key)`` draws the power limits from
``key`` and forks the run stream ``fold_in(key, 0x5047)`` and the channel
stream ``fold_in(key, 0x4348)``. ``step`` uses ``state.key`` whole as the
round key and advances by ``fold_in(key, 1)``; ``run(T)`` splits
``split(state.key, T)`` and advances by ``fold_in(key, T)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import prng
from repro_torch.configs.base import PFELSConfig
from repro_torch.core import channels, privacy
from repro_torch.fl import algorithms, rounds
from repro_torch.fl import bank as bank_lib
from repro_torch.tree import Params, Unravel

_RUN_STREAM_TAG = 0x5047  # "PG"
_CHAN_STREAM_TAG = 0x4348  # "CH"


@dataclass
class TrainState:
    """All state of the Alg. 2 server loop."""
    params: Params                    # name -> tensor, pytree order
    power_limits: torch.Tensor        # (N,) P_i, fixed per device
    bank: bank_lib.BankState          # residuals, lanes and counts
    prev_delta: torch.Tensor          # (d,) last reconstructed Delta_hat
    key: torch.Tensor                 # PRNG key the NEXT step/run consumes
    round: torch.Tensor               # int32 scalar, rounds completed
    ledger: privacy.LedgerState       # (eps, delta) accumulators
    chan: Any = None                  # channel-model carry (None here)

    @property
    def residuals(self) -> Optional[torch.Tensor]:
        """The (N, d) error-feedback memory (None without
        ``cfg.error_feedback``); it lives in the bank."""
        return self.bank.residuals


class Trainer:
    """The Alg. 2 server loop over a registry algorithm.

    ``Trainer(cfg, loss_fn, params_template, device="cuda")``: ``loss_fn
    (params, {"x", "y"}) -> (loss, aux)``; ``params_template`` defines d
    and the flat layout and is the default initial params. Every tensor
    of the state lives on ``device``. Options the port does not run yet
    raise ``NotImplementedError`` here. With ``cfg.error_feedback`` the
    bank's (N, d) residual memory is updated in place
    (``bank.ResidentBank``), so a state cannot be rerun once a later
    state was made from it.
    """

    def __init__(self, cfg: PFELSConfig, loss_fn: Callable,
                 params_template: Params,
                 device: Union[str, torch.device] = "cuda"):
        rounds.check_ported(cfg)
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.algorithm = algorithms.get_algorithm(cfg.algorithm)
        self.channel_model = channels.get_channel_model(cfg.channel.model)
        self._params_template = {n: t.to(self.device)
                                 for n, t in params_template.items()}
        self.unravel = Unravel(self._params_template)
        self.d = self.unravel.d
        self.bank = bank_lib.ResidentBank(cfg.num_clients, self.d,
                                          cfg.error_feedback, self.device)
        self._cohort_core = rounds.build_cohort_core(
            cfg, loss_fn, self.d, self.unravel)

    # ------------------------------------------------------------- state

    def init(self, key, params: Optional[Params] = None) -> TrainState:
        """Fresh TrainState: power limits drawn from ``key``, zeroed
        ledger/bank/prev_delta, and the run stream forked off ``key``."""
        key = key.to(self.device)
        params = self._params_template if params is None else {
            n: t.to(self.device) for n, t in params.items()}
        return TrainState(
            params=params,
            power_limits=rounds.init_power_limits(key, self.cfg, self.d),
            bank=self.bank.init(),
            prev_delta=torch.zeros((self.d,), dtype=torch.float32,
                                   device=self.device),
            key=prng.fold_in(key, _RUN_STREAM_TAG),
            round=torch.zeros((), dtype=torch.int32, device=self.device),
            ledger=privacy.ledger_init(self.device),
            chan=self.channel_model.init(
                prng.fold_in(key, _CHAN_STREAM_TAG), self.cfg.num_clients,
                self.cfg.channel))

    def _spend(self, ledger, metrics):
        """Ledger update + the ``eps_round`` metric."""
        if self.algorithm.privacy_spend is None:
            eps_round = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        else:
            eps_round = self.algorithm.privacy_spend(
                self.cfg, metrics["beta"], self.d).float()
            ledger = privacy.ledger_spend(ledger, eps_round)
        return ledger, dict(metrics, eps_round=eps_round)

    # ------------------------------------------------------------- loops

    def _bank_round(self, params, power_limits, bank, prev_delta, chan, ledger,
               data_x, data_y, round_key):
        """One round against the resident bank: sample the cohort, gather
        its slices, run the cohort core, write its residual slice, this
        round's bank lanes and counts back, charge the ledger."""
        ks = rounds.split_round_key(round_key)
        sel = rounds.sample_cohort(ks[rounds.ROUND_KEY_LANES["selection"]],
                                   self.cfg.num_clients,
                                   self.cfg.clients_per_round)
        res_sel = self.bank.gather(bank, sel)
        new_params, metrics, new_res_sel, delta_hat, new_chan = \
            self._cohort_core(params, power_limits[sel], data_x[sel],
                              data_y[sel], ks, res_sel, prev_delta, chan,
                              sel)
        lanes = bank_lib.cohort_lane_keys(
            ks[rounds.ROUND_KEY_LANES["bank"]], sel)
        new_bank = self.bank.scatter(bank, sel, new_res_sel, lanes)
        ledger, metrics = self._spend(ledger, metrics)
        return new_params, metrics, new_bank, delta_hat, new_chan, ledger

    def _advance(self, state: TrainState, n: int, params, bank, prev_delta,
                 ledger, chan) -> TrainState:
        return TrainState(
            params=params, power_limits=state.power_limits, bank=bank,
            prev_delta=prev_delta, key=prng.fold_in(state.key, n),
            round=state.round + n, ledger=ledger, chan=chan)

    def step(self, state: TrainState, data_x, data_y):
        """One round with ``state.key`` as the round key."""
        params, metrics, bank, delta_hat, chan, ledger = self._bank_round(
            state.params, state.power_limits, state.bank, state.prev_delta,
            state.chan, state.ledger, data_x, data_y, state.key)
        return self._advance(state, 1, params, bank, delta_hat, ledger,
                             chan), metrics

    def run(self, state: TrainState, data_x, data_y,
            rounds: Optional[int] = None,
            on_round: Optional[Callable[[int, Dict], None]] = None):
        """T rounds (T defaults to ``cfg.rounds``) as a Python loop over the
        round keys ``split(state.key, T)``. Returns ``(state, metrics)``
        with every metric stacked over the T rounds. ``on_round(t,
        metrics)``, if given, is called after each round (progress,
        per-round timing)."""
        t = self.cfg.rounds if rounds is None else int(rounds)
        params, bank, prev = state.params, state.bank, state.prev_delta
        ledger, chan = state.ledger, state.chan
        per_round = []
        for i, round_key in enumerate(prng.split(state.key, t)):
            params, metrics, bank, prev, chan, ledger = self._bank_round(
                params, state.power_limits, bank, prev, chan, ledger,
                data_x, data_y, round_key)
            per_round.append(metrics)
            if on_round is not None:
                on_round(i, metrics)
        stacked = {k: torch.stack([m[k] for m in per_round])
                   for k in per_round[0]} if per_round else {}
        return self._advance(state, t, params, bank, prev, ledger,
                             chan), stacked

    # ------------------------------------------------------- conveniences

    def ledger_totals(self, state: TrainState,
                      delta_prime: float = 1e-6) -> Dict[str, Any]:
        """Host-side (eps_T, delta_T) report from the ledger."""
        delta = self.cfg.resolved_delta()
        return {
            "basic": privacy.ledger_totals_basic(state.ledger, delta),
            "advanced": privacy.ledger_totals_advanced(state.ledger, delta,
                                                       delta_prime),
            "eps_max_round": float(state.ledger.eps_max),
            "spends": int(state.ledger.spends),
        }

    def evaluate(self, state: TrainState, xt, yt, batch: int = 256):
        """(test_loss, test_accuracy) of ``state.params``."""
        return rounds.evaluate(state.params, self.loss_fn, xt, yt,
                               batch=batch)


def replace(state: TrainState, **kw) -> TrainState:
    """``dataclasses.replace`` re-export for state surgery."""
    return dataclasses.replace(state, **kw)
