"""Gradient / update clipping (paper Assumption 1 via [21]); port of
``repro/core/clipping.py``."""
from __future__ import annotations

import torch

from repro_torch.tree import Params, leaf_names


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the leaves' sums of squares, summed in leaf order."""
    total = None
    for n in leaf_names(tree):
        s = torch.sum(torch.square(tree[n].float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Params, clip: float):
    """x <- x * min(1, C/max(||x||, 1e-12)). Returns (clipped, pre-clip
    norm)."""
    nrm = global_norm(tree)
    scale = torch.clamp_max(
        torch.full_like(nrm, clip) / torch.clamp_min(nrm, 1e-12), 1.0)
    return {n: (x * scale).to(x.dtype) for n, x in tree.items()}, nrm
