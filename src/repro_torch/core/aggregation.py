"""Aggregation (port of ``repro/core/aggregation.py``): in simulation
mode, AirComp through the unfused plain-torch path or the fused path
through the ``pfels_transmit`` kernels, on one process or with the
cohort's clients over the ranks of a process group (the superposition an
``all_reduce``), and the digital baselines' server-side aggregates
(DP-FedAvg, FedAvg); in production mode, the per-tensor PFELS transform
of pod-scale clients (``pfels_production_aggregate``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import prng, tracing
from repro_torch.core import channel as chan
from repro_torch.core.clipping import row_norms
from repro_torch.core.compressors import base as comp_base
from repro_torch.kernels.pfels_transmit import ref as transmit_ref
from repro_torch.launch import op_cost
from repro_torch.tree import tree_leaves, tree_unflatten


def realized_r(tx_mask, r: int):
    """The server's unscale divisor: the realized transmitter count under a
    transmit mask, floored at 1; the nominal r without one."""
    if tx_mask is None:
        return r
    return torch.clamp_min(torch.sum(tx_mask), 1.0)


def aircomp_aggregate(updates_flat, idx, gains, beta, noise_key, *,
                      d: int, sigma0: float, r: int,
                      unbiased_rescale: bool = False,
                      gains_est=None, clip: Optional[float] = None,
                      tx_mask=None, active=None):
    """Exact Alg. 2 lines 12-16, unfused.

    updates_flat: (r, d) per-client updates Delta_i; idx: (k,) support;
    gains: (r,) |h_i|. Clients transmit x_i = (beta/|h_i|) A Delta_i, the
    MAC superposes with gains, noise is added, the server reconstructs
    Delta_hat = A^T y / (r beta). gains_est: the gains the clients believe
    (imperfect CSI); clip: optional per-client l2 cap; tx_mask: optional
    (r,) 0/1 transmit indicator; active: optional (k,) live-slot column.

    Returns (delta_hat (d,), energy, y (k,))."""
    k = idx.shape[0]
    sup = comp_base.as_support(idx, active)
    if clip is not None:
        updates_flat = updates_flat * transmit_ref.clip_scales(
            updates_flat, clip)[:, None]
    proj = comp_base.project(updates_flat, sup)
    comp = gains_est if gains_est is not None else gains
    signals = (beta / comp)[:, None] * proj                         # x_i
    if tx_mask is not None:
        signals = signals * tx_mask[:, None]
    if active is None:
        # the noise's last multiply and the add fuse into one FMA, as
        # XLA's CPU backend computes the reference's receive(...) + noise:
        # y bit-equal to the reference's where the draw is, so that a
        # server-guided support breaks ties of |Delta_hat| the same way
        y = prng.normal_fma(noise_key, (k,), sigma0,
                            chan.receive(signals, gains, 0.0))      # (k,)
    else:
        noise = sigma0 * prng.normal(noise_key, (k,)) * active
        y = chan.receive(signals, gains, noise)                     # (k,)
    delta_hat = comp_base.decode_support(y, sup, d) / (
        realized_r(tx_mask, r) * beta)
    if unbiased_rescale:
        delta_hat = delta_hat * (d / k)
    energy = torch.sum(signals.float() ** 2)
    return delta_hat, energy, y


def aircomp_aggregate_fused(updates_flat, idx, gains, beta, noise_key, *,
                            d: int, sigma0: float, r: int,
                            unbiased_rescale: bool = False,
                            gains_est=None, clip: Optional[float] = None,
                            use_kernel: bool = True, tx_mask=None,
                            gains_ant=None, active=None):
    """The contract and noise draw of :func:`aircomp_aggregate`, run by
    the ``pfels_transmit`` kernels in one pass over d with no (r, d)
    sparsified or scaled intermediate. ``use_kernel=False`` runs the plain
    dense formulation instead."""
    from repro_torch.kernels.pfels_transmit.ops import fused_transmit
    return fused_transmit(
        updates_flat, idx, gains_ant if gains_ant is not None else gains,
        beta, noise_key, d=d, sigma0=sigma0, r=r, clip=clip,
        gains_est=gains_est, tx_mask=tx_mask,
        unbiased_rescale=unbiased_rescale, use_kernel=use_kernel,
        active=active)


def aircomp_aggregate_sharded(updates_local, idx, gains_local, beta,
                              noise_key, *, d: int, sigma0: float, r: int,
                              cohort, unbiased_rescale: bool = False,
                              gains_est_local=None,
                              clip: Optional[float] = None,
                              use_kernel: bool = False,
                              tx_mask_local=None, active=None):
    """Sharded-cohort variant of :func:`aircomp_aggregate` (DESIGN.md §7).

    Each rank of ``cohort`` (a ``launch.mesh.CohortGroup``) passes its
    (r_local, d) slice of the cohort's updates and its (r_local,) or
    (r_local, M) slice of the gains (and of ``gains_est_local`` and
    ``tx_mask_local``); a spare rank passes empty slices. Each computes
    its partial MAC sum and transmit energy, through the fused kernels
    (``use_kernel``) or the plain dense chain, with a zero noise vector;
    one ``all_reduce`` sums the partials, the energies and the realized
    transmitter counts over the ranks. The channel noise is drawn once
    from ``noise_key``, the draw of the one-process paths, on every rank,
    and added after the sum. ``beta`` must be designed from the global
    gains. Returns (delta_hat (d,), energy, y (k,)), the same bits on
    every rank."""
    mask, z_dense = transmit_ref.dense_noise_and_mask(idx, noise_key,
                                                      sigma0, d, active)
    u = updates_local.float().contiguous()
    zeros = torch.zeros((d,), dtype=torch.float32, device=u.device)
    if u.shape[0] == 0:
        y_part, e_part = zeros, zeros.new_zeros(())
    elif use_kernel:
        from repro_torch.kernels.pfels_transmit.ops import fused_pipeline
        y_part, e_part = fused_pipeline(
            u, mask, zeros, gains_local, beta, clip=clip,
            gains_est=gains_est_local, tx_mask=tx_mask_local)
    else:
        scales = transmit_ref.clip_scales(u, clip)
        tx, rx = transmit_ref.transmit_coeffs(gains_local, beta, scales,
                                              gains_est_local)
        rx_eff, tx_sq = transmit_ref.masked_coeffs(tx, rx, tx_mask_local)
        y_part, e_part = transmit_ref.pfels_transmit_ref(u, mask, zeros,
                                                         rx_eff, tx_sq)
    n_tx = (zeros.new_zeros(()) if tx_mask_local is None
            else torch.sum(tx_mask_local.float()))
    summed = cohort.all_reduce(torch.cat([y_part, e_part.reshape(1),
                                          n_tx.reshape(1)]))
    y_dense = summed[:d] + z_dense
    r_div = r if tx_mask_local is None else torch.clamp_min(summed[d + 1],
                                                            1.0)
    delta_hat = transmit_ref.server_unscale(y_dense, idx, beta, r_div, d,
                                            unbiased_rescale)
    return delta_hat, summed[d], y_dense[idx]


def dp_fedavg_aggregate(updates_flat, clip: float, sigma: float, noise_key,
                        *, r: int):
    """DP-FedAvg baseline (Alg. 1 lines 11/13): per-client l2 clip to C,
    the mean, and Gaussian noise N(0, (C sigma)^2 / r) per coordinate from
    one ``normal`` of size d. The noise std is f32(C sigma) / sqrt(f32 r),
    the order and types the reference's weak-typed scalars give."""
    dev = updates_flat.device
    norms = row_norms(updates_flat)[:, None]
    clipped = updates_flat / torch.clamp_min(norms / clip, 1.0)
    std = (torch.tensor(clip * sigma, dtype=torch.float32, device=dev)
           / torch.sqrt(torch.tensor(float(r), dtype=torch.float32,
                                     device=dev)))
    noise = std * prng.normal(noise_key, tuple(updates_flat.shape[1:]))
    return torch.mean(clipped, dim=0) + noise


def fedavg_aggregate(updates_flat):
    return torch.mean(updates_flat, dim=0)


# ------------------------------------------------------------- production

def pfels_production_aggregate(update_tree, masks, *, beta, r: int,
                               sigma0: float, noise_key,
                               group: Optional[dist.ProcessGroup] = None,
                               unbiased_rescale: bool = False,
                               compression_p: float = 1.0):
    """PFELS aggregation of pod-scale clients (DESIGN.md §3), per tensor
    of each client's f32 update tree: mask, scale by beta (the channel
    gain pre-inverted, so the received signal is beta A Delta), superpose
    the clients (``all_reduce`` over ``group``, one client a rank; the
    reference's psum over ``axis_name``), add the channel noise
    ``sigma0 * mask * normal`` on the transmitted coordinates (one key a
    leaf from ``split(noise_key, n_leaves)``), unscale by 1/(r beta), and
    by 1/p with ``unbiased_rescale``.

    ``group=None`` is the single-client route. There, as XLA's CPU backend
    computes the reference's ``x * beta + sigma0 * m * z``, the first
    product and the add fuse into one FMA over the rounded noise product,
    so the result is the reference's bit for bit where the draw is."""
    leaves = tree_leaves(update_tree)
    keys = prng.split(noise_key, len(leaves))
    scale = 1.0 / (r * beta)
    if unbiased_rescale:
        scale = scale / torch.full_like(scale, compression_p)
    out = []
    for x, m, k in zip(leaves, tree_leaves(masks), keys):
        mf = m.to(x.dtype)
        with tracing.span("aggregate.noise"):
            z = prng.normal(k, tuple(x.shape)).to(x.dtype)
        with tracing.span("aggregate.combine"):
            if group is None:
                out.append(prng.fma_f32(x * mf, beta, (sigma0 * mf) * z)
                           * scale)
            else:
                summed = (x * mf) * beta
                dist.all_reduce(summed, group=group)
                op_cost.charge_collective("all-reduce", summed.nbytes,
                                          dist.get_world_size(group))
                out.append((summed + (sigma0 * mf) * z) * scale)
    return tree_unflatten(update_tree, out)
