"""Plain PyTorch versions of the threefry kernels: ``repro_torch.prng``'s
own code. The CPU route of ``kernel.sample`` and ``kernel.combine`` runs
them; on the card they are what the kernels are held against, bit for
bit."""
from __future__ import annotations

import torch

from repro_torch import prng


def sample_ref(key: torch.Tensor, n: int, kind: str, p=None
               ) -> torch.Tensor:
    """``kind`` ("uniform", "bernoulli" or "normal") of n values, as
    ``prng.uniform`` (f32, [0, 1)), ``prng.bernoulli`` (bool) and
    ``prng.normal`` (f32) draw them: (n,) for one key, (M, n) for a batch
    of M keys."""
    if kind == "normal":
        return prng._hash_counts(key, n, prng._bits_to_normal, torch.float32)
    u = prng._hash_counts(key, n, prng._bits_to_unit, torch.float32)
    if kind == "uniform":
        return u
    return u < torch.tensor(prng._f32(p), dtype=torch.float32,
                            device=u.device)


def combine_ref(x: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
                beta: torch.Tensor, sigma0: float, scale: torch.Tensor
                ) -> torch.Tensor:
    """One leaf of ``core.aggregation.pfels_production_aggregate``'s
    single-client route: ``fma_f32(x * mf, beta, (sigma0 * mf) * z) *
    scale``, z = ``prng.normal(key, x.shape)`` (drawn by the plain code on
    every device) and mf the bool mask in x's dtype."""
    mf = mask.to(x.dtype)
    z = sample_ref(key, x.numel(), "normal").reshape(x.shape)
    return prng.fma_f32(x * mf, beta, (sigma0 * mf) * z) * scale
