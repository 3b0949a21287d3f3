"""The fused PFELS transmit pipeline (port of
``repro/kernels/pfels_transmit/ops.py``).

``fused_transmit`` has the contract of ``core.aggregation.
aircomp_aggregate`` (same key, same channel-noise draw) plus the optional
transmit clip, transmit mask and per-antenna gains. Unlike the reference
it does not pad d to 128-lane tiles: the kernels take d as it is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.pfels_transmit import ref
from repro_torch.kernels.pfels_transmit.kernel import (client_sumsq,
                                                       fused_combine)


def fused_pipeline(u: torch.Tensor, mask: torch.Tensor, z_dense: torch.Tensor,
                   gains: torch.Tensor, beta, *,
                   clip: Optional[float] = None, gains_est=None,
                   tx_mask=None):
    """Kernel-invoking core. u: (r, d) f32; mask/z_dense: (d,); gains:
    (r,) effective or (r, M) per-antenna (combined in the kernel);
    tx_mask: optional (r,) 0/1. Returns (y_dense (d,), energy), the
    received signal before the server-side 1/(r beta) unscale."""
    r = u.shape[0]
    if clip is not None:
        scales = ref.scales_from_norms(torch.sqrt(client_sumsq(u)), clip)
    else:
        scales = torch.ones((r,), dtype=torch.float32, device=u.device)
    g_mat = (gains if gains.ndim == 2 else gains[:, None]).float()
    tx, _ = ref.transmit_coeffs(gains, beta, scales, gains_est)
    txm = (torch.ones((r,), dtype=torch.float32, device=u.device)
           if tx_mask is None else tx_mask.float())
    return fused_combine(u, mask, z_dense, g_mat.contiguous(),
                         tx.float().contiguous(), txm.contiguous())


def fused_transmit(updates_flat: torch.Tensor, idx: torch.Tensor,
                   gains: torch.Tensor, beta, noise_key, *, d: int,
                   sigma0: float, r, clip: Optional[float] = None,
                   gains_est=None, tx_mask=None,
                   unbiased_rescale: bool = False, use_kernel: bool = True,
                   active=None):
    """Fused Alg. 2 lines 12-16 for the whole (r, d) update batch.
    Returns (delta_hat (d,), energy, y (k,)) like ``aircomp_aggregate``;
    ``use_kernel=False`` runs the plain dense formulation instead."""
    mask, z_dense = ref.dense_noise_and_mask(idx, noise_key, sigma0, d,
                                             active)
    u = updates_flat.float().contiguous()
    r_div = r if tx_mask is None else torch.clamp_min(torch.sum(tx_mask),
                                                      1.0)
    if use_kernel:
        y_dense, energy = fused_pipeline(
            u, mask, z_dense, gains, beta, clip=clip, gains_est=gains_est,
            tx_mask=tx_mask)
    else:
        scales = ref.clip_scales(u, clip)
        tx, rx = ref.transmit_coeffs(gains, beta, scales, gains_est)
        rx_eff, tx_sq = ref.masked_coeffs(tx, rx, tx_mask)
        y_dense, energy = ref.pfels_transmit_ref(u, mask, z_dense, rx_eff,
                                                 tx_sq)
    delta_hat = ref.server_unscale(y_dense, idx, beta, r_div, d,
                                   unbiased_rescale)
    return delta_hat, energy, y_dense[idx]
