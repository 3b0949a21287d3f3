"""Compressor registry (port of ``repro/core/compressors/base.py``): a
compressor selects the round's support omega_t (a static-width index set
plus an optional 0/1 live-slot column), states its sensitivity factor on
C1 (the beta design and the ledger both use it), and may transform each
client's clipped update (``encode``), reconstruct on the server
(``decode``), require the bank's error-feedback memory (``carry``) or
return a live-slot column (``dynamic_support``). Extra draws derive by
``fold_in`` on the round's support lane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core import randk

# stochastic-rounding keys are split(fold_in(ks[3], QUANT_STREAM_TAG), r)
QUANT_STREAM_TAG = 0x5154  # "QT"


class Support(NamedTuple):
    """One round's transmitted coordinate set: ``idx`` (k,) coordinate
    ids; ``active`` optional (k,) 0/1 live-slot column (None = all k
    slots live)."""
    idx: torch.Tensor
    active: Optional[torch.Tensor] = None


def as_support(idx, active=None) -> Support:
    if isinstance(idx, Support):
        return idx if active is None else Support(idx.idx, active)
    return Support(idx, active)


def support_size(sup: Support):
    """The static width when every slot is live, else the live count."""
    if sup.active is None:
        return sup.idx.shape[0]
    return torch.sum(sup.active)


def and_active(sup: Support, active: torch.Tensor) -> Support:
    """Intersect an extra (k,) 0/1 column (the k schedule) into the
    support."""
    if sup.active is None:
        return Support(sup.idx, active)
    return Support(sup.idx, sup.active * active)


def project(u: torch.Tensor, sup: Support) -> torch.Tensor:
    """(..., d) -> (..., k) projection A u with the live-slot mask."""
    v = randk.project(u, sup.idx)
    return v if sup.active is None else v * sup.active


def decode_support(y: torch.Tensor, sup: Support, d: int) -> torch.Tensor:
    """(..., k) -> (..., d) server-side unprojection A^T y."""
    vals = y if sup.active is None else y * sup.active
    return randk.unproject(vals, sup.idx, d)


def sparsify(u: torch.Tensor, sup: Support, d: int) -> torch.Tensor:
    """A^T A u, (..., d) -> (..., d): what a client actually put on the
    air, dense; the error-feedback residual subtracts it."""
    return decode_support(project(u, sup), sup, d)


def dense_mask(sup: Support, d: int) -> torch.Tensor:
    """(d,) 0/1 indicator of the live support (the fused kernel's mask
    column)."""
    ones = (torch.ones(sup.idx.shape, dtype=torch.float32,
                       device=sup.idx.device)
            if sup.active is None else sup.active)
    out = torch.zeros((d,), dtype=torch.float32, device=sup.idx.device)
    out[sup.idx] = ones
    return out


@dataclass(frozen=True)
class Compressor:
    """One compression scheme. Hooks:
    ``select_support(cfg, d, k, prev_delta, key) -> Support`` (``key`` the
    round's support lane, ``prev_delta`` the last round's reconstructed
    update); ``sensitivity(cfg, d)`` the static multiplier on the norm
    bound; ``encode(cfg, updates (r, d), keys (r, 2)) -> (r, d)`` applied
    after the transmit clip (None: identity); ``decode(cfg, y (k,), sup,
    d) -> (d,)`` (None: :func:`decode_support`); ``carry(cfg)`` whether
    the scheme needs error-feedback residuals whatever
    ``cfg.error_feedback`` says; ``dynamic_support(cfg)`` whether
    ``select_support`` may return an ``active`` column."""
    name: str
    select_support: Callable
    sensitivity: Callable = lambda cfg, d: 1.0
    encode: Optional[Callable] = None
    decode: Optional[Callable] = None
    carry: Callable = lambda cfg: False
    dynamic_support: Callable = lambda cfg: False


_REGISTRY: Dict[str, Compressor] = {}


def register_compressor(name: str, comp: Compressor) -> Compressor:
    """Add a scheme under ``PFELSConfig.compressor == name``."""
    if name in _REGISTRY:
        raise ValueError(f"compressor {name!r} already registered")
    if comp.select_support is None:
        raise ValueError(f"compressor {name!r} needs a select_support hook")
    _REGISTRY[name] = comp
    return comp


def unregister_compressor(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_compressor(name: str) -> Compressor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown compressor {name!r}; registered: "
            f"{sorted(_REGISTRY)} (add new schemes via "
            f"repro_torch.core.compressors.register_compressor)") from None


def list_compressors():
    return sorted(_REGISTRY)


def sensitivity_factor(cfg, d: Optional[int] = None) -> float:
    """The configured compressor's static sensitivity multiplier, the one
    value the beta design and the ledger must agree on."""
    return float(get_compressor(cfg.compressor).sensitivity(cfg, d))


def carry_required(cfg) -> bool:
    """Whether the configured compressor forces error-feedback residuals
    on (``top_k_ef``), whatever ``cfg.error_feedback`` says."""
    return bool(get_compressor(cfg.compressor).carry(cfg))
