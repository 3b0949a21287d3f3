"""rand_k sparsification (paper Eq. 9, Lemma 1, Lemma 10); port of the
"exact" mode of ``repro/core/randk.py``: omega is a uniformly random
k-subset of [d], shared by every client (AirComp alignment)."""
from __future__ import annotations

import torch

from repro_torch import prng


def sample_indices(key, d: int, k: int) -> torch.Tensor:
    """omega: a uniformly random k-subset of [d] (without replacement)."""
    return prng.permutation(key, d)[:k]


def project(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A^t x: gather the k selected coordinates. x: (d,) -> (k,)."""
    return x[..., idx]


def unproject(y: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    """(A^t)^T y: scatter k values back into d dims (zeros elsewhere).
    y: (..., k) -> (..., d)."""
    out = torch.zeros(tuple(y.shape[:-1]) + (d,), dtype=y.dtype,
                      device=y.device)
    out[..., idx] = y
    return out
