"""Convergence-optimized power control under DP (paper §7); port of
``repro/core/power_control.py``.

Theorem 5 (PFELS):
    beta*_t = min_i min( |h_i| sqrt(d P_i) / (C1 eta tau sqrt(k)),  eps/C2 )

Baselines:
    WFL-P   (Eq. 36): beta_t = min_i |h_i| sqrt(P_i) / (C1 eta tau)
    WFL-PDP (Eq. 37): beta_t = min( WFL-P beta, eps/C2 )
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import privacy


def beta_power_cap(gains, power_limits, d: int, k, c1: float,
                   eta: float, tau: int):
    """Eq. (34c): min_i |h_i| sqrt(d P_i) / (C1 eta tau sqrt(k))."""
    sqrt_k = torch.sqrt(torch.as_tensor(k, dtype=torch.float32,
                                        device=gains.device))
    per = gains * torch.sqrt(float(d) * power_limits) / (c1 * eta * tau
                                                         * sqrt_k)
    return torch.min(per)


def beta_pfels(gains, power_limits, *, d: int, k, c1: float, eta: float,
               tau: int, epsilon, r: int, n: int, delta: float,
               sigma0: float):
    """Theorem 5: the optimal per-round alignment coefficient. ``k`` may
    be a live-slot count tensor and ``epsilon`` a per-round ceiling tensor
    (the schedules). With a number epsilon the privacy cap is host float64
    math, rounded to f32 at the ``minimum``; with a tensor it is an f32
    division, as the reference's traced ceiling gives."""
    cap_power = beta_power_cap(gains, power_limits, d, k, c1, eta, tau)
    cap_priv = privacy.beta_privacy_cap(epsilon, eta, tau, c1, r, n, delta,
                                        sigma0)
    return torch.minimum(cap_power, torch.as_tensor(
        cap_priv, dtype=torch.float32, device=cap_power.device))


def beta_wfl_p(gains, power_limits, *, c1: float, eta: float, tau: int):
    """Eq. (36): full updates (k = d), no DP constraint."""
    per = gains * torch.sqrt(power_limits) / (c1 * eta * tau)
    return torch.min(per)


def beta_wfl_pdp(gains, power_limits, *, c1: float, eta: float, tau: int,
                 epsilon: float, r: int, n: int, delta: float, sigma0: float):
    """Eq. (37): full updates and the DP constraint; the privacy cap is
    host float64 math, rounded to f32 at the ``minimum``."""
    cap_power = beta_wfl_p(gains, power_limits, c1=c1, eta=eta, tau=tau)
    cap_priv = privacy.beta_privacy_cap(epsilon, eta, tau, c1, r, n, delta,
                                        sigma0)
    return torch.minimum(cap_power, torch.tensor(
        cap_priv, dtype=torch.float32, device=cap_power.device))


def transmit_energy(beta, gains, signal_sq_norms):
    """Per-round transmit energy Sum_i ||x_i||^2 with x_i = (beta/|h_i|)
    A d_i: signal_sq_norms (r,) ||A Delta_i||^2; summed in the
    reference's order. (A number ``beta`` divides as a tensor: torch
    computes ``number / tensor`` as a reciprocal times the number.)"""
    beta = torch.as_tensor(beta, dtype=gains.dtype, device=gains.device)
    return prng.sum_last((beta / gains) ** 2 * signal_sq_norms)
