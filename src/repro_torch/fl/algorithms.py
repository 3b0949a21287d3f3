"""Transmit-scheme registry of the FL round (port of
``repro/fl/algorithms.py``). The port registers ``pfels`` (Alg. 2 +
Thm 5); the baselines wait for ROADMAP Queue 1, item 7.

An entry supplies support selection, the per-round beta design and the
per-round privacy spend charged to the ledger."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import PFELSConfig
from repro_torch.core import channels, compressors, power_control, privacy


@dataclass(frozen=True)
class Algorithm:
    """``select_support(cfg, d, k, prev_delta, key) -> Support``;
    ``design_beta(cfg, gains, power_limits, d, k_used, *, epsilon=None,
    c1_scale=1.0) -> beta``; ``privacy_spend(cfg, beta, d=None) -> eps``
    (None: the scheme is never ledgered)."""
    name: str
    select_support: Callable
    design_beta: Callable
    privacy_spend: Optional[Callable] = None


_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(name: str, alg: Algorithm) -> Algorithm:
    if name in _REGISTRY:
        raise ValueError(f"algorithm {name!r} already registered")
    _REGISTRY[name] = alg
    return alg


def get_algorithm(name: str) -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ported: "
            f"{sorted(_REGISTRY)}): ROADMAP Queue 1, item 7") from None


def _dp_epsilon_spend(cfg: PFELSConfig, beta, d=None):
    """Per-round eps consumed (Thm 3 inverse) for the realized beta,
    capped at the configured budget. C2 is host float64 math, cast to
    f32 before the product, as the reference does."""
    s = compressors.sensitivity_factor(cfg, d)
    c2 = privacy.c2_coefficient(
        cfg.local_lr, cfg.local_steps, cfg.clip * s, cfg.clients_per_round,
        cfg.num_clients, cfg.resolved_delta(),
        channels.effective_noise_std(cfg.channel))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=beta.device)
    return torch.minimum(f32(c2) * beta, f32(cfg.epsilon))


def _pfels_support(cfg: PFELSConfig, d: int, k: int, prev_delta, key):
    """Support omega_t from the configured compressor."""
    comp = compressors.get_compressor(cfg.compressor)
    return comp.select_support(cfg, d, k, prev_delta, key)


def _pfels_beta(cfg: PFELSConfig, gains, power_limits, d: int, k, *,
                epsilon=None, c1_scale: float = 1.0):
    eps = cfg.epsilon if epsilon is None else epsilon
    return power_control.beta_pfels(
        gains, power_limits, d=d, k=k, c1=cfg.clip * c1_scale,
        eta=cfg.local_lr, tau=cfg.local_steps, epsilon=eps,
        r=cfg.clients_per_round, n=cfg.num_clients,
        delta=cfg.resolved_delta(),
        sigma0=channels.effective_noise_std(cfg.channel))


register_algorithm("pfels", Algorithm(
    name="pfels", select_support=_pfels_support, design_beta=_pfels_beta,
    privacy_spend=_dp_epsilon_spend))
