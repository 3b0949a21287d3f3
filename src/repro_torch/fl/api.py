"""The public FL training API: ``Trainer`` + ``TrainState`` (port of
``repro/fl/api.py``).

``TrainState`` holds all loop state: params (a dict in pytree order), the
per-device power limits, the client bank (error-feedback residuals,
lanes and participation counts), the previous round's reconstructed
update ``prev_delta`` (which ``randk_mode="server_topk"`` selects from),
the PRNG key the next call consumes, the round counter, the privacy
ledger and the channel-model carry (the Markov model's (N,) latent
state; None for stateless models). The round counter and the ledger's
running spend feed the compression schedule on the device.

``cfg.bank_backend`` selects where the bank lives: ``resident`` (device
tensors) or ``streamed`` (host memory, with the cohort's data made or
copied in by ``data.loader.prefetch_cohorts`` while the round before
computes). The two give bit-equal runs under the same key.

``cfg.client_sharding="cohort"`` splits each round's r clients over the
ranks of a ``torch.distributed`` group (``launch.mesh``): every rank
builds its own ``Trainer`` and holds the whole replicated state on its
own device, and every rank's state stays the same bit for bit. The
caller initialises the group (gloo for ranks that share a card or run on
the CPU, NCCL with one card a rank).

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
import torch.distributed as dist

from repro_torch import prng
from repro_torch.configs.base import PFELSConfig
from repro_torch.core import channels, compressors, privacy
from repro_torch.data import loader
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
    chan: Any = None                  # channel-model carry (None: stateless)

    @property
    def residuals(self) -> Optional[torch.Tensor]:
        """The (N, d) error-feedback memory (None without
        ``cfg.error_feedback``); it lives in the bank."""
        return self.bank.residuals


class Trainer:
    """The Alg. 2 server loop over a registry algorithm.

    ``Trainer(cfg, loss_fn, params_template, device="cuda", group=None)``:
    ``loss_fn(params, {"x", "y"}) -> (loss, aux)``; ``params_template``
    defines d and the flat layout and is the default initial params.
    Every tensor of the state lives on ``device``. ``group`` is the
    process group a sharded cohort spreads over (None: the default group;
    read only with ``client_sharding="cohort"``). With
    ``cfg.error_feedback``, or a
    compressor that requires it (``top_k_ef``), the bank's (N, d)
    residual memory is updated in place
    (``bank.ResidentBank``), so a state cannot be rerun once a later
    state was made from it. The streamed bank clones its host state once
    per ``run`` or ``step`` call, so there a state can be rerun.
    """

    def __init__(self, cfg: PFELSConfig, loss_fn: Callable,
                 params_template: Params,
                 device: Union[str, torch.device] = "cuda",
                 group: Optional[dist.ProcessGroup] = None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.algorithm = algorithms.get_algorithm(cfg.algorithm)
        self.channel_model = channels.get_channel_model(cfg.channel.model)
        self._params_template = {n: t.to(self.device)
                                 for n, t in params_template.items()}
        self.unravel = Unravel(self._params_template)
        self.d = self.unravel.d
        # carry compressors (top_k_ef) force the residual memory on, as
        # the round body's error feedback
        ef_on = cfg.error_feedback or (
            self.algorithm.aircomp and self.algorithm.sparsifies_transmit
            and compressors.carry_required(cfg))
        self.bank = bank_lib.make_bank(cfg.bank_backend, cfg.num_clients,
                                       self.d, ef_on, self.device)
        self.cohort = rounds.resolve_cohort(cfg, group)
        if self.bank.backend == "streamed" and self.cohort is not None:
            raise ValueError(
                "bank_backend='streamed' is host-driven and does not "
                "compose with client_sharding='cohort' yet — stream the "
                "bank OR shard the cohort (DESIGN.md §10)")
        self._cohort_core = rounds.build_cohort_core(
            cfg, loss_fn, self.d, self.unravel, self.cohort)

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

    def _bank_round(self, params, power_limits, bank, prev_delta, chan,
                    ledger, data_x, data_y, round_key, t):
        """One round against the resident bank: sample the cohort, gather
        its slices, run the cohort core (``t`` the absolute round counter,
        the ledger's running sum the schedule's spend), write its residual
        slice, this round's bank lanes and counts back, charge the
        ledger."""
        ks = rounds.split_round_key(round_key)
        sel = rounds.sample_cohort(ks[rounds.ROUND_KEY_LANES["selection"]],
                                   self.cfg.num_clients,
                                   self.cfg.clients_per_round)
        res_sel = self.bank.gather(bank, sel)
        new_params, metrics, new_res_sel, delta_hat, new_chan = \
            self._cohort_core(params, power_limits[sel], data_x[sel],
                              data_y[sel], ks, res_sel, prev_delta, chan,
                              sel, t, ledger.eps_sum)
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

    def step(self, state: TrainState, data_x, data_y=None):
        """One round with ``state.key`` as the round key."""
        if self.bank.backend == "streamed":
            return self._streamed_step(state, data_x, data_y)
        params, metrics, bank, delta_hat, chan, ledger = self._bank_round(
            state.params, state.power_limits, state.bank, state.prev_delta,
            state.chan, state.ledger, data_x, data_y, state.key,
            state.round)
        return self._advance(state, 1, params, bank, delta_hat, ledger,
                             chan), metrics

    def run(self, state: TrainState, data_x, data_y=None,
            rounds: Optional[int] = None,
            on_round: Optional[Callable[[int, Dict], None]] = None):
        """T rounds (T defaults to ``cfg.rounds``) as a Python loop over the
        round keys ``split(state.key, T)``. Returns ``(state, metrics)``
        with every metric stacked over the T rounds. ``on_round(t,
        metrics)``, if given, is called after each round (progress,
        per-round timing).

        Under the ``resident`` bank ``data_x``/``data_y`` are the
        population's (N, samples, ...) tensors on the device. Under
        ``streamed`` they may be tensors anywhere (kept in host memory) or
        a :class:`repro_torch.data.loader.CohortSource` with ``data_y``
        None, and only (r, ...) slices reach the device."""
        t = self.cfg.rounds if rounds is None else int(rounds)
        if self.bank.backend == "streamed":
            if t < 1:
                raise ValueError("run(rounds=0) is not meaningful with the "
                                 "streamed bank; call with rounds >= 1")
            source = loader.as_cohort_source(data_x, data_y)
            params, metrics, bank, prev, chan, ledger = \
                self._streamed_rounds(state, source,
                                      prng.split(state.key, t), on_round)
            return self._advance(state, t, params, bank, prev, ledger,
                                 chan), metrics
        params, bank, prev = state.params, state.bank, state.prev_delta
        ledger, chan = state.ledger, state.chan
        per_round = []
        for i, round_key in enumerate(prng.split(state.key, t)):
            params, metrics, bank, prev, chan, ledger = self._bank_round(
                params, state.power_limits, bank, prev, chan, ledger,
                data_x, data_y, round_key, state.round + i)
            per_round.append(metrics)
            if on_round is not None:
                on_round(i, metrics)
        stacked = {k: torch.stack([m[k] for m in per_round])
                   for k in per_round[0]} if per_round else {}
        return self._advance(state, t, params, bank, prev, ledger,
                             chan), stacked

    # ------------------------------------------------- streamed execution

    def _streamed_rounds(self, state: TrainState, source, round_keys,
                         on_round=None):
        """``len(round_keys)`` rounds with the bank in host memory: every
        round's cohort is sampled up front, the cohorts are prefetched,
        and only their data and residual slices move to the device (and
        the slices back). The bank is cloned once a call, so the O(N d)
        copy spreads over the call's rounds: prefer ``run(rounds=T)`` to a
        loop of ``step``."""
        cfg = self.cfg
        n, r = cfg.num_clients, cfg.clients_per_round
        if getattr(source, "n", n) != n:
            raise ValueError(
                f"cohort source serves {source.n} clients but "
                f"cfg.num_clients={n}: Alg. 2 line 2 samples from "
                f"cfg.num_clients, so a mismatched source would truncate "
                f"the population (and the Thm 2 r/n accounting)")
        lanes_of = rounds.ROUND_KEY_LANES
        ks_all = [rounds.split_round_key(k) for k in round_keys]
        sels = torch.stack([rounds.sample_cohort(ks[lanes_of["selection"]],
                                                 n, r) for ks in ks_all])
        sels_host = sels.cpu()

        bank = self.bank.clone(state.bank)
        params, prev, ledger = state.params, state.prev_delta, state.ledger
        chan = state.chan
        per_round = []
        cohorts = loader.prefetch_cohorts(source, sels_host,
                                          device=self.device)
        for ti, (cx, cy) in enumerate(cohorts):
            sel, ks = sels[ti], ks_all[ti]
            res_sel = self.bank.gather(bank, sels_host[ti])
            if res_sel is not None:
                res_sel = res_sel.to(self.device, non_blocking=True)
            params, metrics, new_res_sel, prev, chan = self._cohort_core(
                params, state.power_limits[sel], cx, cy, ks, res_sel, prev,
                chan, sel, state.round + ti, ledger.eps_sum)
            ledger, metrics = self._spend(ledger, metrics)
            lanes = bank_lib.cohort_lane_keys(ks[lanes_of["bank"]], sel)
            bank = self.bank.scatter(bank, sels_host[ti], new_res_sel, lanes)
            per_round.append(metrics)
            if on_round is not None:
                on_round(ti, metrics)
        stacked = {k: torch.stack([m[k] for m in per_round])
                   for k in per_round[0]}
        return params, stacked, bank, prev, chan, ledger

    def _streamed_step(self, state: TrainState, data_x, data_y=None):
        """Streamed ``step``: ``state.key`` whole is the round key, as in
        the resident ``step``."""
        source = loader.as_cohort_source(data_x, data_y)
        params, metrics, bank, prev, chan, ledger = self._streamed_rounds(
            state, source, state.key[None])
        metrics = {k: v[0] for k, v in metrics.items()}
        return self._advance(state, 1, params, bank, prev, ledger,
                             chan), metrics

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
