"""The PFELS round (Alg. 2) and the paper's baselines, single device
(port of the single-device body of ``repro/fl/rounds.py``).

One round: split the round key into 7 lanes, sample r of n clients, run
tau steps of local training per client (plus the error-feedback residual
if enabled), draw the block-fading gains and, for AirComp schemes, the
support and beta, aggregate (over the simulated MAC through the fused
kernels or the unfused plain path, or digitally on the server), update
the residual memory and the server model.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import prng
from repro_torch.configs.base import PFELSConfig
from repro_torch.core import aggregation, channel, channels, compressors
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
    """Raise for every option this port does not run yet, naming the
    ROADMAP item that will bring it; nothing silently runs something
    else."""
    todo = []
    if cfg.bank_backend != "resident":
        todo.append((f"bank_backend={cfg.bank_backend!r}", 8))
    if cfg.channel.model != "block_fading":
        todo.append((f"channel.model={cfg.channel.model!r}", 9))
    if cfg.compressor != "rand_k":
        todo.append((f"compressor={cfg.compressor!r}", 10))
    if cfg.schedule.mode != "none":
        todo.append((f"schedule.mode={cfg.schedule.mode!r}", 10))
    if cfg.client_sharding != "none":
        todo.append((f"client_sharding={cfg.client_sharding!r}", 11))
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(
            f"{what} (ROADMAP Queue 1, item {item})" for what, item in todo))


def build_cohort_core(cfg: PFELSConfig, loss_fn: Callable, d: int,
                      unravel: Unravel):
    """The round body on cohort slices: ``cohort_core(params, p_sel, cx,
    cy, ks, res_sel, prev_delta, chan_carry, sel) -> (new_params,
    metrics, new_res_sel, delta_hat, new_chan_carry)``, where ``p_sel``
    (r,), ``cx``/``cy`` (r, samples, ...) and ``res_sel`` (r, d) or None
    are the sampled clients' slices and ``ks`` is the ``split_round_key``
    output (lanes 1-4 and 6 are consumed here; the selection and bank
    lanes belong to the caller).

    AirComp schemes (pfels, wfl_*) draw a support and a beta and
    aggregate over the simulated MAC; digital ones (dp_fedavg, fedavg)
    aggregate on the server from the ``channel_noise`` lane, with beta =
    energy = 0 and d subcarriers. With error feedback each client's
    residual is added to its update before the transmit, the transmit
    clip (if set) is applied here rather than in the aggregator, and the
    new residual is the update minus what was put on the air."""
    k_coords = max(int(round(cfg.compression_ratio * d)), 1)
    alg = algorithms.get_algorithm(cfg.algorithm)
    chan_model = channels.get_channel_model(cfg.channel.model)
    sigma0 = chan_model.noise_std(cfg.channel)
    r = cfg.clients_per_round
    aircomp = alg.aircomp
    # the compressor applies only to sparsifying AirComp schemes (pfels)
    comp = (compressors.get_compressor(cfg.compressor)
            if aircomp and alg.sparsifies_transmit else None)
    c1_scale = comp.sensitivity(cfg, d) if comp is not None else 1.0
    ef_on = cfg.error_feedback
    # error feedback needs the clip scales for the residual, so the clip
    # is applied once here and the aggregator gets clip=None
    pre_clip = cfg.transmit_clip is not None and ef_on

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

    def cohort_core(params, p_sel, cx, cy, ks, res_sel=None,
                    prev_delta=None, chan_carry=None, sel=None):
        ck = prng.split(ks[ROUND_KEY_LANES["client_train"]], r)

        new_chan_carry, cr = chan_model.step(
            chan_carry, cfg.channel, r, sel,
            ks[ROUND_KEY_LANES["gains"]], ks[ROUND_KEY_LANES["csi"]])
        gains = cr.gains

        # support omega_t and beta from the observed gains
        sup = beta = None
        k_used = d
        if aircomp:
            sup = compressors.as_support(alg.select_support(
                cfg, d, k_coords, prev_delta,
                ks[ROUND_KEY_LANES["support"]]))
            k_used = compressors.support_size(sup)
            beta = alg.design_beta(cfg, channels.design_gains(cr), p_sel, d,
                                   k_used, c1_scale=c1_scale)

        # local training, plus the residual memory under error feedback
        use_ef = ef_on and res_sel is not None
        flat_params = ravel(params)
        flat_updates, losses = client_updates(params, flat_params, cx, cy,
                                              ck)
        if use_ef:
            flat_updates += res_sel
        metrics: Dict[str, torch.Tensor] = {
            "train_loss": torch.mean(losses),
            "update_norm": torch.mean(
                torch.linalg.vector_norm(flat_updates, dim=1)),
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
            agg_kw = dict(
                d=d, sigma0=sigma0, r=r,
                unbiased_rescale=cfg.unbiased_rescale,
                gains_est=(cr.gains_obs if cfg.channel.csi_error > 0
                           else None),
                clip=agg_clip, tx_mask=cr.tx_mask, active=sup.active)
            if cfg.use_fused_kernel:
                delta_hat, energy, _ = aggregation.aircomp_aggregate_fused(
                    tx_full, sup.idx, gains, beta, noise_key,
                    gains_ant=cr.gains_ant, **agg_kw)
            else:
                delta_hat, energy, _ = aggregation.aircomp_aggregate(
                    tx_full, sup.idx, gains, beta, noise_key, **agg_kw)
        else:
            # digital server-side aggregation (the channel's transmit mask
            # and its realized-r rescale come with the dropout channel)
            delta_hat = alg.server_aggregate(cfg, flat_updates, noise_key,
                                             d=d, r=r)
            beta = torch.zeros((), dtype=torch.float32,
                               device=flat_params.device)
            energy = torch.zeros_like(beta)
        metrics.update(beta=beta, energy=energy,
                       subcarriers=torch.as_tensor(
                           k_used, device=flat_params.device))

        # error-feedback memory: e_i <- u_i - A^T A (s_i u_i), the update
        # minus what was actually sent (clipped, projected on the support)
        new_res_sel = res_sel
        if use_ef:
            transmitted = (compressors.sparsify(tx_full, sup, d)
                           if alg.sparsifies_transmit else tx_full)
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
