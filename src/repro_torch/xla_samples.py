"""Inputs on which the port's XLA-CPU f32 functions (``repro_torch.prng``)
are held to XLA's own: stratified samples of f32 values.

``tests/test_torch_prng.py`` holds each function to ``jax.jit`` of the
reference op on these inputs, and ``chip_smoke.py``'s ``draws`` phase
holds the card's results on the same inputs to the CPU's.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# name: (the prng function, the draws' range, the branch points |x|)
FUNCTIONS: Dict[str, Tuple[str, Tuple[float, float], Tuple[float, ...]]] = {
    "log1p": ("log1p_f32", (-1.0, 0.0), (0.41421357, 1.0)),
    "exp": ("exp_f32", (-88.8, 0.0),
            (87.8, 88.8, 87.33655, 88.37626, 87.68)),
    "erf": ("erf_f32", (-6.0, 6.0), (3.7439213,)),
    "erfc": ("erfc_f32", (-6.0, 6.0), (1.0, 2.0, 9.419280)),
    "ndtr": ("ndtr_f32", (-6.0, 6.0), (1.0, 1.4142135)),
    "rsqrt": ("rsqrt_f32", (0.5, 64.0), (1.0, 4.0)),
    "erf_inv": ("erfinv_f32", (-1.0, 1.0), (0.99662524, 0.64359425)),
}

SPECIALS = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40,
                     2.0 ** -126, -2.0 ** -126, 1.1754942e-38,
                     -1.1754942e-38, 1.0, -1.0, np.inf, -np.inf, np.nan,
                     np.finfo(np.float32).max, -np.finfo(np.float32).max],
                    np.float32)


def bits_between(lo: float, hi: float, n: int, rng) -> np.ndarray:
    """n f32 in [lo, hi], uniform in bit pattern on each side of zero (so
    every binade alike)."""
    out = []
    if lo < 0:
        top = int(np.float32(lo).view(np.uint32))
        bot = 0x80000000 if hi >= 0 else int(np.float32(hi).view(np.uint32))
        out.append(rng.integers(bot, top + 1, n // 2 if hi >= 0 else n,
                                dtype=np.uint64))
    if hi >= 0:
        bot = 0 if lo <= 0 else int(np.float32(lo).view(np.uint32))
        top = int(np.float32(hi).view(np.uint32))
        out.append(rng.integers(bot, top + 1, n // 2 if lo < 0 else n,
                                dtype=np.uint64))
    return np.concatenate(out).astype(np.uint32).view(np.float32)


def stratified(lo: float, hi: float, branches: Sequence[float] = (),
               n: int = 1 << 20, seed: int = 0) -> np.ndarray:
    """About n f32: half uniform in bit pattern over [lo, hi], half over
    the whole finite line, the 64 floats on each side of every branch
    point (and of its negative), and ``SPECIALS``."""
    rng = np.random.default_rng(seed)
    near = []
    for b in branches:
        for v in (b, -b):
            c = int(np.float32(v).view(np.uint32))
            near.append((np.arange(c - 64, c + 65) & 0xFFFFFFFF).astype(
                np.uint32).view(np.float32))
    big = float(np.finfo(np.float32).max)
    return np.concatenate([bits_between(lo, hi, n // 2, rng),
                           bits_between(-big, big, n // 2, rng),
                           *near, SPECIALS])


def sample(name: str, n: int = 1 << 20, seed: int = 0) -> np.ndarray:
    """The stratified inputs of ``FUNCTIONS[name]``."""
    _, (lo, hi), branches = FUNCTIONS[name]
    return stratified(lo, hi, branches, n, seed)
