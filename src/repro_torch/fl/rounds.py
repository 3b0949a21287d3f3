"""The PFELS round (Alg. 2) and the paper's baselines (port of
``repro/fl/rounds.py``).

One round: split the round key into 7 lanes, sample r of n clients, run
tau steps of local training per client (plus the error-feedback residual
if enabled), step the channel model (gains, optional transmit mask) and,
for AirComp schemes, draw the compressor's support and design beta,
clip and encode, aggregate (over the simulated MAC through the fused
kernels or the unfused plain path, or digitally on the server), update
the residual memory and the server model.

Sharded cohort (``cfg.client_sharding="cohort"``, DESIGN.md §7): the r
clients are split over the ranks of a ``torch.distributed`` group
(``launch.mesh.CohortGroup``), each rank trains, clips, encodes and
power-scales its own slice, and the AirComp superposition is an
``all_reduce``. Every rank holds the whole replicated state. As in the
reference, every draw comes from the keys of the one-process round (the
per-client keys are split over all r clients and then sliced), beta and
the support are designed from the global gains before the per-shard
work, and the channel noise is drawn once and added after the sum.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.configs.base import PFELSConfig
from repro_torch.core import (aggregation, channel, channels, compressors,
                              privacy)
from repro_torch.core.clipping import row_norms
from repro_torch.fl import algorithms
from repro_torch.fl import bank as bank_lib
from repro_torch.fl.client import local_train
from repro_torch.kernels.pfels_transmit import ref as transmit_ref
from repro_torch.launch.mesh import CohortGroup, make_cohort_group
from repro_torch.tree import Unravel, ravel

# The fixed 7-lane split of each round key. Which lane feeds which draw
# is a compatibility contract with the reference: shifting a lane
# re-randomizes every stream in the round.
ROUND_KEY_LANES = {
    "selection": 0,      # Alg. 2 line 2 client sampling
    "client_train": 1,   # per-client local-training keys
    "gains": 2,          # channel-model step
    "support": 3,        # rand-k support omega_t
    "channel_noise": 4,  # receiver noise
    "bank": 5,           # ClientBank per-client lanes
    "csi": 6,            # CSI estimation error (beyond paper)
}


def split_round_key(key):
    """The per-round 7-subkey split."""
    return prng.split(key, len(ROUND_KEY_LANES))


def sample_cohort(key, n: int, r: int):
    """Alg. 2 line 2: sample r of n clients without replacement."""
    return prng.choice(key, n, (r,), replace=False)


@dataclass
class FLState:
    """The legacy shims' state (see :func:`setup`)."""
    params: Any
    power_limits: torch.Tensor       # (N,) P_i, fixed per device
    residuals: Optional[torch.Tensor] = None  # (N, d) error feedback
    round: int = 0


def setup(key, params, cfg: PFELSConfig, d: int) -> FLState:
    """Deprecated legacy state factory; prefer ``Trainer(...).init(key)``.
    Draws the same power limits from the same key."""
    warnings.warn(
        "repro_torch.fl.setup is deprecated; use "
        "repro_torch.fl.Trainer(...).init(key) (DESIGN.md §8)",
        DeprecationWarning, stacklevel=2)
    p_lim = init_power_limits(key, cfg, d)
    res = (torch.zeros((cfg.num_clients, d), dtype=torch.float32,
                       device=p_lim.device)
           if cfg.error_feedback else None)
    return FLState(params=params, power_limits=p_lim, residuals=res)


def init_power_limits(key, cfg: PFELSConfig, d: int) -> torch.Tensor:
    """(N,) per-device power limits P_i."""
    return channel.sample_power_limits(key, cfg.num_clients, d, cfg.channel)


def resolve_cohort(cfg: PFELSConfig, group: Optional[dist.ProcessGroup]
                   = None) -> Optional[CohortGroup]:
    """The shards the cohort will use (the reference's
    ``_resolve_cohort_mesh``): None with ``client_sharding="none"``, else
    the cohort of ``cfg.clients_per_round`` over ``group`` (None: the
    default group; one shard without ``torch.distributed``)."""
    if cfg.client_sharding == "none":
        return None
    if cfg.client_sharding != "cohort":
        raise ValueError(
            f"unknown client_sharding mode {cfg.client_sharding!r}")
    return make_cohort_group(cfg.clients_per_round, group)


def build_cohort_core(cfg: PFELSConfig, loss_fn: Callable, d: int,
                      unravel: Unravel,
                      cohort: Optional[CohortGroup] = None):
    """The round body on cohort slices: ``cohort_core(params, p_sel, cx,
    cy, ks, res_sel, prev_delta, chan_carry, sel, t, eps_spent) ->
    (new_params, metrics, new_res_sel, delta_hat, new_chan_carry)``, where
    ``p_sel`` (r,), ``cx``/``cy`` (r, samples, ...) and ``res_sel`` (r, d)
    or None are the sampled clients' slices, ``ks`` is the
    ``split_round_key`` output (lanes 1-4 and 6 are consumed here; the
    selection and bank lanes belong to the caller), ``chan_carry`` the
    channel model's state and ``sel`` the sampled ids. ``t`` (the round
    counter) and ``eps_spent`` (the ledger's running sum), int32 and f32
    device scalars, drive the compression schedule.

    The channel model draws the gains (and may mask transmissions); for
    AirComp schemes (pfels, wfl_*) the compressor gives the support and
    beta is designed from the gains the devices observe, with dropped
    clients lifted out of the min. Digital schemes (dp_fedavg, fedavg)
    aggregate on the server from the ``channel_noise`` lane, with beta =
    energy = 0 and d subcarriers. With error feedback (or a compressor
    that requires it) each client's residual is added to its update
    before the transmit, and the new residual is the update minus what
    was put on the air.

    With ``cohort`` of more than one shard every rank gets the whole
    cohort's slices and works on its own clients; the round's result is
    the same on every rank. AirComp schemes gather only what the round
    reads: each client's loss and update norm, and under error feedback
    the new residual rows. Digital schemes gather the (r, d) updates and
    aggregate them on every rank."""
    k_coords = max(int(round(cfg.compression_ratio * d)), 1)
    alg = algorithms.get_algorithm(cfg.algorithm)
    chan_model = channels.get_channel_model(cfg.channel.model)
    sigma0 = chan_model.noise_std(cfg.channel)
    has_mask = chan_model.may_mask(cfg.channel)
    r = cfg.clients_per_round
    aircomp = alg.aircomp
    # the compressor applies only to sparsifying AirComp schemes (pfels)
    comp = (compressors.get_compressor(cfg.compressor)
            if aircomp and alg.sparsifies_transmit else None)
    sched = cfg.schedule
    sched_on = comp is not None and compressors.schedules.is_active(sched)
    has_encode = comp is not None and comp.encode is not None
    # carry compressors (top_k_ef) force error feedback on
    ef_on = cfg.error_feedback or (comp is not None and comp.carry(cfg))
    c1_scale = comp.sensitivity(cfg, d) if comp is not None else 1.0
    # encode must see the clipped update, and error feedback needs the
    # clip scales for the residual: both apply the clip here and hand the
    # aggregator clip=None
    pre_clip = cfg.transmit_clip is not None and (ef_on or has_encode)
    n_shards = 1 if cohort is None else cohort.shards
    if comp is not None and comp.decode is not None and n_shards > 1:
        raise ValueError(
            f"compressor {comp.name!r} has a custom decode hook, which "
            f"the sharded-cohort path does not route yet; use "
            f"client_sharding='none' (DESIGN.md §13)")

    def client_updates(params, flat_params, cx, cy, ck):
        """Local training (Alg. 2 lines 5-11) of each client of the slice
        -> ((rows, d) flat updates, (rows,) losses)."""
        rows = ck.shape[0]
        flat = torch.empty((rows, d), dtype=torch.float32,
                           device=flat_params.device)
        losses = torch.empty((rows,), dtype=torch.float32,
                             device=flat_params.device)
        for i in range(rows):
            new_params, losses[i] = local_train(
                params, cx[i], cy[i], ck[i], loss_fn=loss_fn,
                steps=cfg.local_steps, lr=cfg.local_lr, clip=cfg.clip,
                momentum=cfg.momentum)
            torch.sub(ravel(new_params), flat_params, out=flat[i])
        return flat, losses

    def support_and_beta(gains_design, p_sel, prev_delta, key, t,
                         eps_spent):
        """Support omega_t and beta. Under a schedule, ``t`` and
        ``eps_spent`` anneal the live-slot column (ANDed into the
        support), the power limits and the per-round epsilon ceiling."""
        sup = compressors.as_support(
            alg.select_support(cfg, d, k_coords, prev_delta, key))
        eps_t = None
        if sched_on:
            ka = compressors.schedules.k_active(sched, cfg, k_coords, t)
            if ka is not None:
                sup = compressors.and_active(sup, ka)
            ps = compressors.schedules.power_scale(sched, cfg, t)
            if ps is not None:
                p_sel = p_sel * ps
            eps_t = compressors.schedules.epsilon_round(sched, cfg, t,
                                                        eps_spent)
        k_used = compressors.support_size(sup)
        beta = alg.design_beta(cfg, gains_design, p_sel, d, k_used,
                               epsilon=eps_t, c1_scale=c1_scale)
        return sup, beta, k_used

    def transmit_prep(flat, ks, rows):
        """The clip and encode of the clients ``rows`` of the cohort, whose
        (rows, d) updates are ``flat`` -> (the as-transmitted rows, the
        clip left to the aggregator)."""
        tx, agg_clip = flat, cfg.transmit_clip
        if pre_clip:
            tx = flat * transmit_ref.clip_scales(flat,
                                                 cfg.transmit_clip)[:, None]
            agg_clip = None
        if has_encode:
            # the per-client rounding keys fork off the support lane
            qk = prng.split(prng.fold_in(ks[ROUND_KEY_LANES["support"]],
                                         compressors.QUANT_STREAM_TAG), r)
            tx = comp.encode(cfg, tx, qk[rows])
        return tx, agg_clip

    def residual(flat, tx, sup, mask):
        """Error feedback: e_i <- u_i - A^T A q(s_i u_i), the update minus
        what was actually sent (clipped, encoded, projected on the live
        support); a dropped client sent nothing."""
        transmitted = (compressors.sparsify(tx, sup, d)
                       if alg.sparsifies_transmit else tx)
        if mask is not None:
            transmitted = transmitted * mask[:, None]
        return flat - transmitted

    def aircomp_round(flat, cr, sup, beta, ks, rows):
        """Transmit ``flat``, the (rows, d) updates of the clients
        ``rows``, over the MAC: in one process the whole cohort, else this
        rank's part of the all-reduced sum -> (delta_hat, energy, the
        as-transmitted rows, their transmit mask or None)."""
        noise_key = ks[ROUND_KEY_LANES["channel_noise"]]
        tx, agg_clip = transmit_prep(flat, ks, rows)
        mask = None if cr.tx_mask is None else cr.tx_mask[rows]
        if n_shards > 1:
            gains_mat = (cr.gains_ant if cr.gains_ant is not None
                         else cr.gains[:, None])
            mask_in = None
            if has_mask:
                mask_in = (torch.ones_like(cr.gains)[rows] if mask is None
                           else mask)
            delta_hat, energy, _ = aggregation.aircomp_aggregate_sharded(
                tx, sup.idx, gains_mat[rows], beta, noise_key, d=d,
                sigma0=sigma0, r=r, cohort=cohort,
                unbiased_rescale=cfg.unbiased_rescale,
                gains_est_local=(channels.observed_gains(cr)[rows]
                                 if cfg.channel.csi_error > 0 else None),
                clip=agg_clip, use_kernel=cfg.use_fused_kernel,
                tx_mask_local=mask_in, active=sup.active)
            return delta_hat, energy, tx, mask
        agg_kw = dict(
            d=d, sigma0=sigma0, r=r, unbiased_rescale=cfg.unbiased_rescale,
            gains_est=(cr.gains_obs if cfg.channel.csi_error > 0 else None),
            clip=agg_clip, tx_mask=cr.tx_mask, active=sup.active)
        if cfg.use_fused_kernel:
            # the transmit mask and the per-antenna gains ride the kernel
            # in-tile
            delta_hat, energy, y_agg = aggregation.aircomp_aggregate_fused(
                tx, sup.idx, cr.gains, beta, noise_key,
                gains_ant=cr.gains_ant, **agg_kw)
        else:
            delta_hat, energy, y_agg = aggregation.aircomp_aggregate(
                tx, sup.idx, cr.gains, beta, noise_key, **agg_kw)
        if comp is not None and comp.decode is not None:
            # a custom reconstruction replaces A^T y; the 1/(r beta)
            # unscale and the d/k unbiasing stay the round's
            delta_hat = comp.decode(cfg, y_agg, sup, d) / (
                aggregation.realized_r(cr.tx_mask, r) * beta)
            if cfg.unbiased_rescale:
                delta_hat = delta_hat * (d / k_coords)
        return delta_hat, energy, tx, mask

    def digital_round(flat, tx_mask, noise_key):
        """The server-side aggregate of the (r, d) updates ``flat``; a
        dropped client uploads nothing here too."""
        agg_in = flat * tx_mask[:, None] if tx_mask is not None else flat
        delta_hat = alg.server_aggregate(cfg, agg_in, noise_key, d=d, r=r)
        if tx_mask is not None:
            # the hook averaged over the nominal r: rescale to the mean of
            # the updates received, and apply no update when every client
            # dropped
            delta_hat = torch.where(
                torch.sum(tx_mask) > 0,
                delta_hat * (r / aggregation.realized_r(tx_mask, r)),
                torch.zeros_like(delta_hat))
        return delta_hat

    def cohort_core(params, p_sel, cx, cy, ks, res_sel=None,
                    prev_delta=None, chan_carry=None, sel=None, t=None,
                    eps_spent=None):
        ck = prng.split(ks[ROUND_KEY_LANES["client_train"]], r)

        new_chan_carry, cr = chan_model.step(
            chan_carry, cfg.channel, r, sel,
            ks[ROUND_KEY_LANES["gains"]], ks[ROUND_KEY_LANES["csi"]])
        if cr.tx_mask is not None and not has_mask:
            raise ValueError(
                f"channel model {chan_model.name!r} returned a tx_mask "
                f"but its may_mask(cfg) hook says False: the mask is "
                f"plumbed only where may_mask says so")

        # support omega_t and beta from the observed gains, dropped
        # clients lifted out of the min
        sup = beta = None
        k_used = d
        if aircomp:
            sup, beta, k_used = support_and_beta(
                channels.design_gains(cr), p_sel, prev_delta,
                ks[ROUND_KEY_LANES["support"]], t, eps_spent)

        # local training of this rank's clients (all r in one process),
        # plus the residual memory under error feedback
        use_ef = ef_on and res_sel is not None
        flat_params = ravel(params)
        dev = flat_params.device
        rows = cohort.clients if n_shards > 1 else slice(None)
        flat, losses = client_updates(params, flat_params, cx[rows],
                                      cy[rows], ck[rows])
        if use_ef:
            flat += res_sel[rows]

        new_res_sel = res_sel
        if aircomp:
            norms = row_norms(flat)
            delta_hat, energy, tx, mask = aircomp_round(
                flat, cr, sup, beta, ks, rows)
            if use_ef:
                new_res_sel = residual(flat, tx, sup, mask)
            if n_shards > 1:
                # (r, 2) gathered in one call; each column made
                # contiguous, so that its mean sums as the one-process
                # round's does
                losses, norms = cohort.gather_rows(torch.stack(
                    [losses, norms], dim=1)).t().contiguous()
                if use_ef:
                    new_res_sel = cohort.gather_rows(new_res_sel)
        else:
            # digital schemes shard only the training and aggregate the
            # gathered updates on every rank
            if n_shards > 1:
                flat = cohort.gather_rows(flat)
                losses = cohort.gather_rows(losses)
            norms = row_norms(flat)
            delta_hat = digital_round(flat, cr.tx_mask,
                                      ks[ROUND_KEY_LANES["channel_noise"]])
            if use_ef:
                new_res_sel = residual(flat, flat, sup, cr.tx_mask)
            beta = torch.zeros((), dtype=torch.float32, device=dev)
            energy = torch.zeros_like(beta)
        metrics: Dict[str, torch.Tensor] = {
            "train_loss": torch.mean(losses),
            "update_norm": torch.mean(norms),
            "r_realized": channels.realized_cohort_size(cr, r),
            "beta": beta, "energy": energy,
            "subcarriers": torch.as_tensor(k_used, device=dev)}

        # server update (line 16)
        return (unravel(flat_params + delta_hat), metrics, new_res_sel,
                delta_hat, new_chan_carry)

    return cohort_core


def _legacy_trainer(cfg: PFELSConfig, loss_fn: Callable, d: int,
                    unravel: Unravel, group, device):
    """The Trainer a legacy shim delegates to (imported here: api.py
    imports this module)."""
    from repro_torch.fl.api import Trainer
    return Trainer(cfg, loss_fn,
                   unravel(torch.zeros((d,), dtype=torch.float32,
                                       device=device)),
                   device=device, group=group)


def _legacy_state(trainer, params, power_limits, key, residuals,
                  prev_delta):
    """The ``TrainState`` of a shim call with ``key`` as the next round
    key. The residuals are copied (the resident bank writes its rows in
    place and the shims are functional) and read only under
    ``cfg.error_feedback``; the ledger, counter and channel carry are
    fresh (the shims refuse the schedule and stateful channels that would
    read them)."""
    from repro_torch.fl.api import TrainState
    cfg, dev = trainer.cfg, key.device
    n = cfg.num_clients
    res = (residuals.clone()
           if cfg.error_feedback and residuals is not None else None)
    return TrainState(
        params=params, power_limits=power_limits,
        bank=bank_lib.BankState(
            residuals=res,
            lanes=torch.zeros((n, 2), dtype=torch.int64, device=dev),
            counts=torch.zeros((n,), dtype=torch.int32, device=dev)),
        prev_delta=(torch.zeros((trainer.d,), dtype=torch.float32,
                                device=dev)
                    if prev_delta is None else prev_delta),
        key=key, round=torch.zeros((), dtype=torch.int32, device=dev),
        ledger=privacy.ledger_init(dev), chan=None)


def _legacy_residuals(state, residuals):
    """The shim's returned residuals, on the caller's device."""
    if state.residuals is None:
        return residuals
    return state.residuals.to(residuals.device)


def _reject_stateful_channel(cfg: PFELSConfig, shim: str):
    """The deprecated shims carry no cross-round channel state, so they
    refuse a stateful channel model (markov_fading)."""
    model = channels.get_channel_model(cfg.channel.model)
    if model.stateful(cfg.channel):
        raise ValueError(
            f"channel model {cfg.channel.model!r} is stateful and the "
            f"deprecated {shim} has nowhere to carry its cross-round "
            f"state; use repro_torch.fl.Trainer (DESIGN.md §11)")


def _reject_legacy_compression(cfg: PFELSConfig, shim: str):
    """The deprecated shims predate the compressor registry: they refuse
    a compression schedule (it needs the round counter and the ledger's
    spend) and a carry compressor without ``cfg.error_feedback`` (it needs
    the residual memory)."""
    alg = algorithms.get_algorithm(cfg.algorithm)
    if not (alg.aircomp and alg.sparsifies_transmit):
        return
    if compressors.schedules.is_active(cfg.schedule):
        raise ValueError(
            f"cfg.schedule.mode={cfg.schedule.mode!r} needs the round "
            f"counter and privacy-ledger state that the deprecated "
            f"{shim} has nowhere to carry; use repro_torch.fl.Trainer "
            f"(DESIGN.md §13)")
    if compressors.carry_required(cfg) and not cfg.error_feedback:
        raise ValueError(
            f"compressor {cfg.compressor!r} requires error-feedback "
            f"residuals but the deprecated {shim} only allocates them "
            f"with cfg.error_feedback=True; set error_feedback=True or "
            f"use repro_torch.fl.Trainer (DESIGN.md §13)")


def make_round_fn(cfg: PFELSConfig, loss_fn: Callable, d: int,
                  unravel: Unravel,
                  group: Optional[dist.ProcessGroup] = None,
                  device="cuda"):
    """Deprecated single-round entry, a thin shim over
    :class:`repro_torch.fl.api.Trainer` (``Trainer.step`` replaces it);
    bit-equal to ``step`` under the same key.

    Returns ``round_fn(params, power_limits, data_x, data_y, key,
    residuals=None, prev_delta=None)``, which returns ``(params,
    metrics)`` or, with ``cfg.error_feedback``, ``(params, metrics,
    residuals)``. ``group``: the cohort's process group under
    ``client_sharding="cohort"`` (None: the default group); ``device``
    that of the tensors the shim will be given."""
    warnings.warn(
        "repro_torch.fl.make_round_fn is deprecated; use "
        "repro_torch.fl.Trainer.step (DESIGN.md §8)", DeprecationWarning,
        stacklevel=2)
    _reject_stateful_channel(cfg, "make_round_fn")
    _reject_legacy_compression(cfg, "make_round_fn")
    trainer = _legacy_trainer(cfg, loss_fn, d, unravel, group, device)
    leaks_delta_hat = (cfg.randk_mode == "server_topk"
                       and trainer.algorithm.aircomp)
    if leaks_delta_hat:
        warnings.warn(
            "the 'delta_hat' metrics key is deprecated; read "
            "TrainState.prev_delta from Trainer.step/run instead",
            DeprecationWarning, stacklevel=2)

    def round_fn(params, power_limits, data_x, data_y, key,
                 residuals=None, prev_delta=None):
        state, metrics = trainer.step(
            _legacy_state(trainer, params, power_limits, key, residuals,
                          prev_delta), data_x, data_y)
        del metrics["eps_round"]
        if leaks_delta_hat:
            metrics["delta_hat"] = state.prev_delta
        if cfg.error_feedback:
            return (state.params, metrics,
                    _legacy_residuals(state, residuals))
        return state.params, metrics

    return round_fn


def make_training_fn(cfg: PFELSConfig, loss_fn: Callable, d: int,
                     unravel: Unravel, rounds: Optional[int] = None,
                     group: Optional[dist.ProcessGroup] = None,
                     device="cuda"):
    """Deprecated T-round driver, a thin shim over
    :class:`repro_torch.fl.api.Trainer` (``Trainer.run`` replaces it);
    bit-equal to ``run`` under the same key.

    Returns ``training_fn(params, power_limits, data_x, data_y, key,
    residuals=None, prev_delta=None) -> (params_T, metrics_T,
    residuals_T, delta_T)``, every metric stacked over the T rounds
    (``rounds``, default ``cfg.rounds``) and ``delta_T`` the last round's
    reconstructed update; ``group`` and ``device`` as in
    :func:`make_round_fn`."""
    warnings.warn(
        "repro_torch.fl.make_training_fn is deprecated; use "
        "repro_torch.fl.Trainer.run (DESIGN.md §8)", DeprecationWarning,
        stacklevel=2)
    _reject_stateful_channel(cfg, "make_training_fn")
    _reject_legacy_compression(cfg, "make_training_fn")
    t_rounds = cfg.rounds if rounds is None else rounds
    trainer = _legacy_trainer(cfg, loss_fn, d, unravel, group, device)

    def training_fn(params, power_limits, data_x, data_y, key,
                    residuals=None, prev_delta=None):
        if cfg.error_feedback and residuals is None:
            residuals = torch.zeros((cfg.num_clients, d),
                                    dtype=torch.float32, device=key.device)
        state, metrics = trainer.run(
            _legacy_state(trainer, params, power_limits, key, residuals,
                          prev_delta), data_x, data_y, rounds=t_rounds)
        del metrics["eps_round"]
        return (state.params, metrics, _legacy_residuals(state, residuals),
                state.prev_delta)

    return training_fn


def round_epsilon_spent(cfg: PFELSConfig, beta: float,
                        d: Optional[int] = None) -> float:
    """Per-round eps consumed (Thm 3 inverse) for ``beta``, with the
    channel model's post-combining noise std and, for sparsifying AirComp
    schemes, C1 scaled by the compressor's sensitivity factor: what the
    in-graph ledger charges."""
    alg = algorithms.get_algorithm(cfg.algorithm)
    s = (compressors.sensitivity_factor(cfg, d)
         if alg.aircomp and alg.sparsifies_transmit else 1.0)
    return privacy.round_epsilon(
        beta, cfg.local_lr, cfg.local_steps, cfg.clip * s,
        cfg.clients_per_round, cfg.num_clients, cfg.resolved_delta(),
        channels.effective_noise_std(cfg.channel))


@torch.no_grad()
def evaluate(params, loss_fn, xt, yt, batch: int = 256):
    """(test_loss, test_accuracy) over the held-out set."""
    n = xt.shape[0]
    accs, losses = [], []
    for i in range(0, n, batch):
        loss, aux = loss_fn(params, {"x": xt[i:i + batch],
                                     "y": yt[i:i + batch]})
        accs.append(aux["accuracy"] * min(batch, n - i))
        losses.append(loss * min(batch, n - i))
    return (float(sum(losses)) / n, float(sum(accs)) / n)
