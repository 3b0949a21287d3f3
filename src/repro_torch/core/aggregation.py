"""Aggregation, simulation mode (port of the single-device part of
``repro/core/aggregation.py``): AirComp through the unfused plain-torch
path or the fused path through the ``pfels_transmit`` kernels, and the
digital baselines' server-side aggregates (DP-FedAvg, FedAvg)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import channel as chan
from repro_torch.core.compressors import base as comp_base
from repro_torch.kernels.pfels_transmit import ref as transmit_ref


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
    noise = sigma0 * prng.normal(noise_key, (k,))
    if active is not None:
        noise = noise * active
    y = chan.receive(signals, gains, noise)                         # (k,)
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


def dp_fedavg_aggregate(updates_flat, clip: float, sigma: float, noise_key,
                        *, r: int):
    """DP-FedAvg baseline (Alg. 1 lines 11/13): per-client l2 clip to C,
    the mean, and Gaussian noise N(0, (C sigma)^2 / r) per coordinate from
    one ``normal`` of size d. The noise std is f32(C sigma) / sqrt(f32 r),
    the order and types the reference's weak-typed scalars give."""
    dev = updates_flat.device
    norms = torch.linalg.vector_norm(updates_flat, dim=1, keepdim=True)
    clipped = updates_flat / torch.clamp_min(norms / clip, 1.0)
    std = (torch.tensor(clip * sigma, dtype=torch.float32, device=dev)
           / torch.sqrt(torch.tensor(float(r), dtype=torch.float32,
                                     device=dev)))
    noise = std * prng.normal(noise_key, tuple(updates_flat.shape[1:]))
    return torch.mean(clipped, dim=0) + noise


def fedavg_aggregate(updates_flat):
    return torch.mean(updates_flat, dim=0)
