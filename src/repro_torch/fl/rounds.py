"""The PFELS round (Alg. 2), single device (port of the single-device
body of ``repro/fl/rounds.py``).

One round: split the round key into 7 lanes, sample r of n clients, run
tau steps of local training per client, draw the block-fading gains, the
rand-k support and the Theorem-5 beta, aggregate over the simulated MAC
(fused kernels or the unfused plain path), and update the server model.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import prng
from repro_torch.configs.base import PFELSConfig
from repro_torch.core import aggregation, channel, channels, compressors
from repro_torch.fl import algorithms
from repro_torch.fl.client import local_train
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
    """Raise for every option this slice of the port does not run, naming
    the ROADMAP queue item that will bring it; nothing silently runs
    something else."""
    todo = []
    if cfg.algorithm != "pfels":
        todo.append((f"algorithm={cfg.algorithm!r}", 7))
    if cfg.error_feedback:
        todo.append(("error_feedback=True", 7))
    if cfg.randk_mode != "exact":
        todo.append((f"randk_mode={cfg.randk_mode!r}", 7))
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
    cy, ks, prev_delta, chan_carry, sel) -> (new_params, metrics,
    delta_hat, new_chan_carry)``, where ``p_sel`` (r,), ``cx``/``cy``
    (r, samples, ...) are the sampled clients' slices and ``ks`` is the
    ``split_round_key`` output (lanes 1-4 and 6 are consumed here; the
    selection and bank lanes belong to the caller)."""
    k_coords = max(int(round(cfg.compression_ratio * d)), 1)
    alg = algorithms.get_algorithm(cfg.algorithm)
    chan_model = channels.get_channel_model(cfg.channel.model)
    sigma0 = chan_model.noise_std(cfg.channel)
    comp = compressors.get_compressor(cfg.compressor)
    c1_scale = comp.sensitivity(cfg, d)
    r = cfg.clients_per_round

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

    def cohort_core(params, p_sel, cx, cy, ks, prev_delta=None,
                    chan_carry=None, sel=None):
        ck = prng.split(ks[ROUND_KEY_LANES["client_train"]], r)

        new_chan_carry, cr = chan_model.step(
            chan_carry, cfg.channel, r, sel,
            ks[ROUND_KEY_LANES["gains"]], ks[ROUND_KEY_LANES["csi"]])
        gains = cr.gains

        # support omega_t and the Theorem-5 beta from the observed gains
        sup = compressors.as_support(alg.select_support(
            cfg, d, k_coords, prev_delta, ks[ROUND_KEY_LANES["support"]]))
        k_used = compressors.support_size(sup)
        beta = alg.design_beta(cfg, channels.design_gains(cr), p_sel, d,
                               k_used, c1_scale=c1_scale)

        flat_params = ravel(params)
        flat_updates, losses = client_updates(params, flat_params, cx, cy,
                                              ck)
        metrics: Dict[str, torch.Tensor] = {
            "train_loss": torch.mean(losses),
            "update_norm": torch.mean(
                torch.linalg.vector_norm(flat_updates, dim=1)),
            "r_realized": channels.realized_cohort_size(cr, r),
        }

        agg_kw = dict(
            d=d, sigma0=sigma0, r=r, unbiased_rescale=cfg.unbiased_rescale,
            gains_est=(cr.gains_obs if cfg.channel.csi_error > 0 else None),
            clip=cfg.transmit_clip, tx_mask=cr.tx_mask, active=sup.active)
        noise_key = ks[ROUND_KEY_LANES["channel_noise"]]
        if cfg.use_fused_kernel:
            delta_hat, energy, _ = aggregation.aircomp_aggregate_fused(
                flat_updates, sup.idx, gains, beta, noise_key,
                gains_ant=cr.gains_ant, **agg_kw)
        else:
            delta_hat, energy, _ = aggregation.aircomp_aggregate(
                flat_updates, sup.idx, gains, beta, noise_key, **agg_kw)
        metrics.update(beta=beta, energy=energy,
                       subcarriers=torch.as_tensor(
                           k_used, device=beta.device))

        # server update (line 16)
        return (unravel(flat_params + delta_hat), metrics, delta_hat,
                new_chan_carry)

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
