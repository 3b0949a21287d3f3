"""rand_k sparsification (paper Eq. 9, Lemma 1, Lemma 10); port of
``repro/core/randk.py``. Two modes:

- "exact": omega is a uniformly random k-subset of [d], shared by every
  client (AirComp alignment); the simulation's rounds use it.
- "mask": one seeded Bernoulli(p) mask per tensor of a params tree, the
  large-model formulation of the production step (``launch/steps.py``).
  The same key gives the same masks on every client (the shared-seed
  broadcast of A^t), and the reference's masks bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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


def sparsify(x: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    """(A^t)^T A^t x: keep only the selected coordinates of x (the
    reference's signature; ``compressors.sparsify`` takes a ``Support``)."""
    return unproject(project(x, idx), idx, d)


# ------------------------------------------------------------- mask mode

def mask_tree(key, tree, p: float):
    """A Bernoulli(p) bool mask per leaf of ``tree``, the leaf's shape,
    one key each from ``split(key, n_leaves)`` in pytree leaf order."""
    leaves = tree_leaves(tree)
    keys = prng.split(key, len(leaves))
    return tree_unflatten(tree, [prng.bernoulli(k, p, tuple(x.shape))
                                 for k, x in zip(keys, leaves)])


def apply_mask_tree(tree, masks):
    return tree_map(lambda x, m: x * m.to(x.dtype), tree, masks)


def compression_ratio_of(k: int, d: int) -> float:
    return k / d


def lambda_k(k: int, d: int) -> float:
    """lambda_k := 1 - k/d (Thm 4 compression-error coefficient)."""
    return 1.0 - k / d
