"""The PFELS round (Alg. 2) and the paper's baselines, single device
(port of the single-device body of ``repro/fl/rounds.py``).

One round: split the round key into 7 lanes, sample r of n clients, run
tau steps of local training per client (plus the error-feedback residual
if enabled), step the channel model (gains, optional transmit mask) and,
for AirComp schemes, draw the compressor's support and design beta,
clip and encode, aggregate (over the simulated MAC through the fused
kernels or the unfused plain path, or digitally on the server), update
the residual memory and the server model.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import prng
from repro_torch.configs.base import PFELSConfig
from repro_torch.core import aggregation, channel, channels, compressors
from repro_torch.core.clipping import row_norms
from repro_torch.fl import algorithms
from repro_torch.fl.client import local_train
from repro_torch.kernels.pfels_transmit import ref as transmit_ref
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


def init_power_limits(key, cfg: PFELSConfig, d: int) -> torch.Tensor:
    """(N,) per-device power limits P_i."""
    return channel.sample_power_limits(key, cfg.num_clients, d, cfg.channel)


def check_ported(cfg: PFELSConfig) -> None:
    """Raise for an option this port does not run yet (the sharded cohort,
    ROADMAP Queue 1 item 11), naming the ROADMAP item; nothing silently
    runs something else."""
    if cfg.client_sharding != "none":
        raise NotImplementedError(
            f"not ported yet: client_sharding={cfg.client_sharding!r} "
            f"(ROADMAP Queue 1, item 11)")


def build_cohort_core(cfg: PFELSConfig, loss_fn: Callable, d: int,
                      unravel: Unravel):
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
    was put on the air."""
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

    def client_updates(params, flat_params, cx, cy, ck):
        """Local training (Alg. 2 lines 5-11) of each sampled client ->
        ((r, d) flat updates, (r,) losses)."""
        flat = torch.empty((r, d), dtype=torch.float32,
                           device=flat_params.device)
        losses = torch.empty((r,), dtype=torch.float32,
                             device=flat_params.device)
        for i in range(r):
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
        gains = cr.gains
        tx_mask = cr.tx_mask

        # support omega_t and beta from the observed gains, dropped
        # clients lifted out of the min
        sup = beta = None
        k_used = d
        if aircomp:
            sup, beta, k_used = support_and_beta(
                channels.design_gains(cr), p_sel, prev_delta,
                ks[ROUND_KEY_LANES["support"]], t, eps_spent)

        # local training, plus the residual memory under error feedback
        use_ef = ef_on and res_sel is not None
        flat_params = ravel(params)
        flat_updates, losses = client_updates(params, flat_params, cx, cy,
                                              ck)
        if use_ef:
            flat_updates += res_sel
        metrics: Dict[str, torch.Tensor] = {
            "train_loss": torch.mean(losses),
            "update_norm": torch.mean(row_norms(flat_updates)),
            "r_realized": channels.realized_cohort_size(cr, r),
        }

        noise_key = ks[ROUND_KEY_LANES["channel_noise"]]
        tx_full = flat_updates      # the as-transmitted (r, d) batch
        if aircomp:
            agg_clip = cfg.transmit_clip
            if pre_clip:
                tx_full = flat_updates * transmit_ref.clip_scales(
                    flat_updates, cfg.transmit_clip)[:, None]
                agg_clip = None
            if has_encode:
                # the per-client rounding keys fork off the support lane
                qk = prng.split(prng.fold_in(
                    ks[ROUND_KEY_LANES["support"]],
                    compressors.QUANT_STREAM_TAG), r)
                tx_full = comp.encode(cfg, tx_full, qk)
            agg_kw = dict(
                d=d, sigma0=sigma0, r=r,
                unbiased_rescale=cfg.unbiased_rescale,
                gains_est=(cr.gains_obs if cfg.channel.csi_error > 0
                           else None),
                clip=agg_clip, tx_mask=tx_mask, active=sup.active)
            if cfg.use_fused_kernel:
                # the transmit mask and the per-antenna gains ride the
                # kernel in-tile
                delta_hat, energy, y_agg = \
                    aggregation.aircomp_aggregate_fused(
                        tx_full, sup.idx, gains, beta, noise_key,
                        gains_ant=cr.gains_ant, **agg_kw)
            else:
                delta_hat, energy, y_agg = aggregation.aircomp_aggregate(
                    tx_full, sup.idx, gains, beta, noise_key, **agg_kw)
            if comp is not None and comp.decode is not None:
                # a custom reconstruction replaces A^T y; the 1/(r beta)
                # unscale and the d/k unbiasing stay the round's
                delta_hat = comp.decode(cfg, y_agg, sup, d) / (
                    aggregation.realized_r(tx_mask, r) * beta)
                if cfg.unbiased_rescale:
                    delta_hat = delta_hat * (d / k_coords)
        else:
            # digital server-side aggregation; a dropped client uploads
            # nothing here too
            agg_in = (flat_updates * tx_mask[:, None]
                      if tx_mask is not None else flat_updates)
            delta_hat = alg.server_aggregate(cfg, agg_in, noise_key, d=d,
                                             r=r)
            if tx_mask is not None:
                # the hook averaged over the nominal r: rescale to the
                # mean of the updates received, and apply no update when
                # every client dropped
                delta_hat = torch.where(
                    torch.sum(tx_mask) > 0,
                    delta_hat * (r / aggregation.realized_r(tx_mask, r)),
                    torch.zeros_like(delta_hat))
            beta = torch.zeros((), dtype=torch.float32,
                               device=flat_params.device)
            energy = torch.zeros_like(beta)
        metrics.update(beta=beta, energy=energy,
                       subcarriers=torch.as_tensor(
                           k_used, device=flat_params.device))

        # error-feedback memory: e_i <- u_i - A^T A q(s_i u_i), the update
        # minus what was actually sent (clipped, encoded, projected on the
        # live support); a dropped client sent nothing
        new_res_sel = res_sel
        if use_ef:
            transmitted = (compressors.sparsify(tx_full, sup, d)
                           if alg.sparsifies_transmit else tx_full)
            if tx_mask is not None:
                transmitted = transmitted * tx_mask[:, None]
            new_res_sel = flat_updates - transmitted

        # server update (line 16)
        return (unravel(flat_params + delta_hat), metrics, new_res_sel,
                delta_hat, new_chan_carry)

    return cohort_core


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
