"""Convergence-optimized power control under DP (paper §7); port of the
PFELS part of ``repro/core/power_control.py``.

Theorem 5 (PFELS):
    beta*_t = min_i min( |h_i| sqrt(d P_i) / (C1 eta tau sqrt(k)),  eps/C2 )
"""
from __future__ import annotations

import torch

from repro_torch.core import privacy


def beta_power_cap(gains, power_limits, d: int, k, c1: float,
                   eta: float, tau: int):
    """Eq. (34c): min_i |h_i| sqrt(d P_i) / (C1 eta tau sqrt(k))."""
    sqrt_k = torch.sqrt(torch.as_tensor(k, dtype=torch.float32,
                                        device=gains.device))
    per = gains * torch.sqrt(float(d) * power_limits) / (c1 * eta * tau
                                                         * sqrt_k)
    return torch.min(per)


def beta_pfels(gains, power_limits, *, d: int, k: int, c1: float, eta: float,
               tau: int, epsilon: float, r: int, n: int, delta: float,
               sigma0: float):
    """Theorem 5: the optimal per-round alignment coefficient. The privacy
    cap is host float64 math, rounded to f32 at the ``minimum``."""
    cap_power = beta_power_cap(gains, power_limits, d, k, c1, eta, tau)
    cap_priv = privacy.beta_privacy_cap(epsilon, eta, tau, c1, r, n, delta,
                                        sigma0)
    return torch.minimum(cap_power, torch.tensor(
        cap_priv, dtype=torch.float32, device=cap_power.device))
