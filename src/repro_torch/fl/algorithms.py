"""Transmit-scheme registry of the FL round (port of
``repro/fl/algorithms.py``): ``pfels`` (Alg. 2 + Thm 5) and the paper's
baselines ``wfl_p`` (Eq. 36), ``wfl_pdp`` (Eq. 37), ``dp_fedavg``
(Alg. 1) and ``fedavg``.

An AirComp entry (``aircomp=True``) supplies support selection and the
per-round beta design; a digital one supplies the server-side aggregate.
Either may charge a per-round privacy spend to the ledger."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import PFELSConfig
from repro_torch.core import (aggregation, channels, compressors,
                              power_control, privacy)


@dataclass(frozen=True)
class Algorithm:
    """One transmit scheme. Hooks:
    ``select_support(cfg, d, k, prev_delta, key) -> Support`` and
    ``design_beta(cfg, gains, power_limits, d, k_used, *, epsilon=None,
    c1_scale=1.0) -> beta`` (AirComp entries);
    ``server_aggregate(cfg, flat_updates, noise_key, *, d, r) -> (d,)``
    (digital entries); ``privacy_spend(cfg, beta, d=None) -> eps`` (None:
    the scheme is never ledgered). ``sparsifies_transmit`` tells the
    error-feedback memory whether the transmitted signal was restricted
    to the support or dense."""
    name: str
    aircomp: bool
    select_support: Optional[Callable] = None
    design_beta: Optional[Callable] = None
    server_aggregate: Optional[Callable] = None
    privacy_spend: Optional[Callable] = None
    sparsifies_transmit: bool = False


_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(name: str, alg: Algorithm, *,
                       overwrite: bool = False) -> Algorithm:
    """Add a transmit scheme under ``PFELSConfig.algorithm == name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"algorithm {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    if alg.aircomp and (alg.select_support is None or alg.design_beta is None):
        raise ValueError(f"aircomp algorithm {name!r} needs select_support "
                         f"and design_beta hooks")
    if not alg.aircomp and alg.server_aggregate is None:
        raise ValueError(f"non-aircomp algorithm {name!r} needs a "
                         f"server_aggregate hook")
    _REGISTRY[name] = alg
    return alg


def unregister_algorithm(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_algorithm(name: str) -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_algorithms():
    return sorted(_REGISTRY)


def _dp_epsilon_spend(cfg: PFELSConfig, beta, d=None, *,
                      compressed: bool = True):
    """Per-round eps consumed (Thm 3 inverse) for the realized beta,
    capped at the configured budget. C2 is host float64 math, cast to
    f32 before the product, as the reference does; a compressed scheme's
    C1 carries the compressor's sensitivity factor."""
    s = compressors.sensitivity_factor(cfg, d) if compressed else 1.0
    c2 = privacy.c2_coefficient(
        cfg.local_lr, cfg.local_steps, cfg.clip * s, cfg.clients_per_round,
        cfg.num_clients, cfg.resolved_delta(),
        channels.effective_noise_std(cfg.channel))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=beta.device)
    return torch.minimum(f32(c2) * beta, f32(cfg.epsilon))


def _dp_epsilon_spend_dense(cfg: PFELSConfig, beta, d=None):
    """The spend of a full-update DP scheme (wfl_pdp): no compressor in
    the transmit path, so no sensitivity factor."""
    return _dp_epsilon_spend(cfg, beta, d, compressed=False)


def _pfels_support(cfg: PFELSConfig, d: int, k: int, prev_delta, key):
    """Support omega_t from the configured compressor."""
    comp = compressors.get_compressor(cfg.compressor)
    return comp.select_support(cfg, d, k, prev_delta, key)


def _full_support(cfg: PFELSConfig, d: int, k: int, prev_delta, key):
    """Full-update baselines transmit every coordinate (k = d)."""
    return compressors.Support(torch.arange(d, device=key.device))


def _pfels_beta(cfg: PFELSConfig, gains, power_limits, d: int, k, *,
                epsilon=None, c1_scale: float = 1.0):
    eps = cfg.epsilon if epsilon is None else epsilon
    return power_control.beta_pfels(
        gains, power_limits, d=d, k=k, c1=cfg.clip * c1_scale,
        eta=cfg.local_lr, tau=cfg.local_steps, epsilon=eps,
        r=cfg.clients_per_round, n=cfg.num_clients,
        delta=cfg.resolved_delta(),
        sigma0=channels.effective_noise_std(cfg.channel))


def _wfl_p_beta(cfg: PFELSConfig, gains, power_limits, d: int, k, *,
                epsilon=None, c1_scale: float = 1.0):
    return power_control.beta_wfl_p(
        gains, power_limits, c1=cfg.clip, eta=cfg.local_lr,
        tau=cfg.local_steps)


def _wfl_pdp_beta(cfg: PFELSConfig, gains, power_limits, d: int, k, *,
                  epsilon=None, c1_scale: float = 1.0):
    eps = cfg.epsilon if epsilon is None else epsilon
    return power_control.beta_wfl_pdp(
        gains, power_limits, c1=cfg.clip, eta=cfg.local_lr,
        tau=cfg.local_steps, epsilon=eps,
        r=cfg.clients_per_round, n=cfg.num_clients,
        delta=cfg.resolved_delta(),
        sigma0=channels.effective_noise_std(cfg.channel))


def _dp_fedavg_aggregate(cfg: PFELSConfig, flat_updates, noise_key, *,
                         d: int, r: int):
    return aggregation.dp_fedavg_aggregate(
        flat_updates, cfg.clip, cfg.dp_fedavg_sigma, noise_key, r=r)


def _dp_fedavg_spend(cfg: PFELSConfig, beta, d=None):
    """Per-round eps of the server-side Gaussian mechanism (Thm 1
    inverted): the clipped-update mean has l2-sensitivity C/r and noise
    std C sigma/sqrt(r), a noise multiplier z = sigma sqrt(r), so
    eps = sqrt(2 ln(1.25/delta)) / z. No budget cap: nothing keeps this
    scheme under budget, and a capped report would under-charge."""
    z = cfg.dp_fedavg_sigma * math.sqrt(cfg.clients_per_round)
    eps = math.sqrt(2.0 * math.log(1.25 / cfg.resolved_delta())) / z
    return torch.tensor(eps, dtype=torch.float32, device=beta.device)


def _fedavg_aggregate(cfg: PFELSConfig, flat_updates, noise_key, *,
                      d: int, r: int):
    return aggregation.fedavg_aggregate(flat_updates)


register_algorithm("pfels", Algorithm(
    name="pfels", aircomp=True, select_support=_pfels_support,
    design_beta=_pfels_beta, privacy_spend=_dp_epsilon_spend,
    sparsifies_transmit=True))

register_algorithm("wfl_p", Algorithm(
    name="wfl_p", aircomp=True, select_support=_full_support,
    design_beta=_wfl_p_beta))

register_algorithm("wfl_pdp", Algorithm(
    name="wfl_pdp", aircomp=True, select_support=_full_support,
    design_beta=_wfl_pdp_beta, privacy_spend=_dp_epsilon_spend_dense))

register_algorithm("dp_fedavg", Algorithm(
    name="dp_fedavg", aircomp=False, server_aggregate=_dp_fedavg_aggregate,
    privacy_spend=_dp_fedavg_spend))

register_algorithm("fedavg", Algorithm(
    name="fedavg", aircomp=False, server_aggregate=_fedavg_aggregate))
