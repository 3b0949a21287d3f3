"""Compressor registry (port of ``repro/core/compressors/base.py``): a
compressor selects the round's support omega_t and states its
sensitivity factor on C1. The port registers ``rand_k``; the other
schemes wait for ROADMAP Queue 1, item 10."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core import randk


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


@dataclass(frozen=True)
class Compressor:
    """``select_support(cfg, d, k, prev_delta, key) -> Support``;
    ``sensitivity(cfg, d)`` the static multiplier on the norm bound."""
    name: str
    select_support: Callable
    sensitivity: Callable = lambda cfg, d: 1.0


_REGISTRY: Dict[str, Compressor] = {}


def register_compressor(name: str, comp: Compressor) -> Compressor:
    if name in _REGISTRY:
        raise ValueError(f"compressor {name!r} already registered")
    _REGISTRY[name] = comp
    return comp


def get_compressor(name: str) -> Compressor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ported: "
            f"{sorted(_REGISTRY)}): ROADMAP Queue 1, item 10") from None


def list_compressors():
    """The ported compressors' names (the reference's others wait for
    ROADMAP Queue 1, item 10)."""
    return sorted(_REGISTRY)


def sensitivity_factor(cfg, d: Optional[int] = None) -> float:
    return float(get_compressor(cfg.compressor).sensitivity(cfg, d))
