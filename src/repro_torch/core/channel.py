"""Wireless flat-fading channel model (paper §4.1, §8.1); port of
``repro/core/channel.py``.

|h_i^t| ~ Exponential(mean=0.02), clipped to [1e-4, 0.1]; constant within a
round, redrawn across rounds. Channel noise z^t ~ N(0, sigma_0^2 I_k) at the
receiver. Per-device power limit P_i from max SNR_i = P_i / (d sigma_0^2)
drawn uniformly in [2, 15] dB.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.configs.base import ChannelConfig

PAPER_D = 9_750_922  # the paper's VGG-11 dimension (§8.1)


def scaled_channel(d: int, *, paper_d: int = PAPER_D) -> ChannelConfig:
    """Fading floor scaled to the paper's operating regime at model
    dimension d: the power-cap floor goes as ``gain_min * sqrt(d)``, so the
    floor is scaled by ``sqrt(d_paper / d)``."""
    floor = 1e-4 * math.sqrt(paper_d / d)
    return ChannelConfig(gain_clip=(min(floor, 0.05), 0.1))


def sample_gains(key, n: int, cfg: ChannelConfig) -> torch.Tensor:
    """|h_i| for n devices."""
    g = prng.exponential(key, (n,)) * cfg.gain_mean
    return torch.clamp(g, cfg.gain_clip[0], cfg.gain_clip[1])


def sample_power_limits(key, n: int, d: int, cfg: ChannelConfig
                        ) -> torch.Tensor:
    """P_i from SNR_i ~ U[snr_lo, snr_hi] dB with SNR_i = P_i/(d sigma_0^2)."""
    lo, hi = cfg.snr_db_range
    snr_db = prng.uniform(key, (n,), minval=lo, maxval=hi)
    snr = torch.pow(10.0, snr_db / 10.0)
    return snr * float(d) * cfg.noise_std ** 2


def sample_noise(key, k: int, cfg: ChannelConfig) -> torch.Tensor:
    """z^t ~ N(0, sigma_0^2 I_k), the intrinsic receiver noise, on the
    key's device."""
    return cfg.noise_std * prng.normal(key, (k,))


def receive(signals: torch.Tensor, gains: torch.Tensor, noise: torch.Tensor
            ) -> torch.Tensor:
    """MAC superposition (Eq. 7/11): y = sum_i |h_i| x_i + z.
    signals: (r, k); gains: (r,); noise: (k,)."""
    return torch.einsum("rk,r->k", signals, gains) + noise


def estimate_gains(key, gains: torch.Tensor, cfg: ChannelConfig
                   ) -> torch.Tensor:
    """Imperfect CSI (beyond paper): clients observe h_est = h*(1+eps),
    eps ~ N(0, csi_error^2)."""
    if cfg.csi_error <= 0:
        return gains
    eps = cfg.csi_error * prng.normal(key, tuple(gains.shape))
    return gains * torch.clamp_min(1.0 + eps, 0.1)
