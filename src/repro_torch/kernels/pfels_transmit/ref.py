"""Plain-torch versions of the fused PFELS transmit pipeline (Alg. 2
lines 12-15); port of ``repro/kernels/pfels_transmit/ref.py``.

These are what the CPU tests run and what the CUDA kernels are held
against on the card: per-client l2 clip -> rand_k selection (dense 0/1
mask over d) -> Theorem-5 power scaling beta/|h_i| -> MAC superposition
with the true gains -> receiver noise on the selected subcarriers.

Dense-mask formulation: with m the 0/1 indicator of omega and z_dense the
noise scattered onto omega,
    y_dense = sum_i |h_i| (beta/|h_i^est|) s_i (m * Delta_i) + z_dense
where s_i = min(1, C/||Delta_i||) is the optional transmit clip. y_dense is
zero off omega, so Delta_hat = y_dense/(r beta) directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core.clipping import row_norms


def dense_noise_and_mask(idx: torch.Tensor, noise_key, sigma0: float,
                         d: int, active: Optional[torch.Tensor] = None):
    """(mask, z_dense): the 0/1 indicator of omega and the channel noise
    ``sigma0 * normal(noise_key, (k,))`` scattered onto it — the one
    noise draw every aggregation path shares. ``active`` zeroes
    deactivated slots out of both columns."""
    noise = sigma0 * prng.normal(noise_key, (idx.shape[0],))
    mask = torch.zeros((d,), dtype=torch.float32, device=idx.device)
    if active is None:
        mask[idx] = 1.0
    else:
        noise = noise * active
        mask[idx] = active
    z_dense = torch.zeros((d,), dtype=torch.float32, device=idx.device)
    z_dense[idx] = noise
    return mask, z_dense


def server_unscale(y_dense: torch.Tensor, idx: torch.Tensor, beta, r,
                   d: int, unbiased_rescale: bool = False) -> torch.Tensor:
    """Receiver-side reconstruction Delta_hat = y_dense/(r beta), with the
    optional beyond-paper d/k unbiasing."""
    delta_hat = y_dense / (r * beta)
    if unbiased_rescale:
        delta_hat = delta_hat * (d / idx.shape[0])
    return delta_hat


def scales_from_norms(norms: torch.Tensor, clip: float) -> torch.Tensor:
    """s = min(1, C/max(||.||, 1e-12))."""
    return torch.clamp_max(
        torch.full_like(norms, clip) / torch.clamp_min(norms, 1e-12), 1.0)


def clip_scales(updates: torch.Tensor, clip: Optional[float]
                ) -> torch.Tensor:
    """Per-client s_i = min(1, C/||Delta_i||_2) over the FULL update;
    clip=None disables (s_i = 1)."""
    if clip is None:
        return torch.ones((updates.shape[0],), dtype=torch.float32,
                          device=updates.device)
    return scales_from_norms(row_norms(updates), clip)


def effective_gains(gains: torch.Tensor) -> torch.Tensor:
    """(r,) effective gains from (r,) gains (identity) or an (r, M)
    per-antenna matrix (the all-ones-beam MRC combine sum_m h_im, added
    in the reference's order)."""
    return gains if gains.ndim == 1 else prng.sum_last(gains)


def transmit_coeffs(gains, beta, scales, gains_est=None):
    """(tx, rx): tx_i = (beta/|h_i^est|) s_i; rx_i = |h_i| tx_i."""
    eff = effective_gains(gains)
    comp = gains_est if gains_est is not None else eff
    tx = (beta / comp) * scales
    return tx, eff * tx


def masked_coeffs(tx, rx, tx_mask=None):
    """(rx_eff, tx_sq) with an optional (r,) 0/1 transmit mask folded in."""
    tx_sq = tx * tx
    if tx_mask is None:
        return rx, tx_sq
    return rx * tx_mask, tx_sq * tx_mask


def pfels_transmit_ref(updates: torch.Tensor, mask: torch.Tensor,
                       noise_dense: torch.Tensor, rx_coeffs: torch.Tensor,
                       tx_sq: torch.Tensor):
    """Fused combine, dense formulation: returns (y_dense (d,), energy)
        y_dense = sum_i rx_i (m * Delta_i) + z_dense
        energy  = sum_i tx_i^2 ||m * Delta_i||^2
    """
    masked = updates.float() * mask[None, :]
    y_dense = torch.einsum("rd,r->d", masked, rx_coeffs) + noise_dense
    energy = torch.sum(tx_sq * torch.sum(masked * masked, dim=1))
    return y_dense, energy


def client_sumsq_ref(updates: torch.Tensor) -> torch.Tensor:
    """Per-client squared l2 norms, (r,): pass 1 of the clip. The plain
    version of the ``client_sumsq`` kernel."""
    u = updates.float()
    return torch.sum(u * u, dim=1)


def fused_combine_ref(u: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
                      gains_mat: torch.Tensor, tx: torch.Tensor,
                      txm: torch.Tensor):
    """The plain version of the ``fused_combine`` kernel, same contract:
    u (r, d), mask and z (d,), gains_mat (r, M), tx and txm (r,), all f32
    -> (y (d,), energy ()):
        g_i = sum_m h_im
        y_j = sum_i g_i tx_i txm_i m_j u_ij + z_j
        E   = sum_i tx_i^2 txm_i sum_j (m_j u_ij)^2
    """
    rxw = prng.sum_last(gains_mat) * tx * txm
    um = u * mask[None, :]
    y = torch.sum(um * rxw[:, None], dim=0) + z
    energy = torch.sum((tx * tx * txm) * torch.sum(um * um, dim=1))
    return y, energy
