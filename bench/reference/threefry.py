"""JAX's Threefry-2x32 draws (non-partitionable mode) in plain torch
int64 ops, written from JAX's published algorithm: the stream, ``split``,
and the uniform, Bernoulli, normal and exponential samplers.

The integer parts (the hash, ``split``, the uniform's mantissa, the
Bernoulli comparison) give JAX's bits exactly. The float samplers
compute their transform (``erfinv``, ``log1p``) in f64 and round to f32
once, so they lie within an f32 rounding or two of JAX's f32 code,
independent of how the program reproduces it.

A key is a pair of Python ints (two uint32 words)."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 22
Key = Tuple[int, int]


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def _hash(k0: int, k1: int, x0, x1):
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def stream(key: Key, n: int, device, transform=None,
           dtype=torch.int64) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))``: the counts padded with one 0 to an
    even length, halved, hashed as pairs (i, i + half), the two output
    halves concatenated and cut to n. ``transform`` maps each chunk of
    words to ``dtype``."""
    half = (n + 1) // 2
    out = torch.empty((n,), dtype=dtype, device=device)
    for a in range(0, half, _CHUNK):
        b = min(half, a + _CHUNK)
        x0 = torch.arange(a, b, dtype=torch.int64, device=device)
        x1 = x0 + half
        x1[x1 >= n] = 0
        o0, o1 = _hash(key[0], key[1], x0, x1)
        if transform is not None:
            o0, o1 = transform(o0), transform(o1)
        out[a:b] = o0
        hi = min(n, half + b)
        if hi > half + a:
            out[half + a:hi] = o1[:hi - half - a]
    return out


def split(key: Key, num: int = 2) -> List[Key]:
    w = stream(key, 2 * num, "cpu").tolist()
    return [(w[2 * i], w[2 * i + 1]) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """The key hashed with the counter pair (0, data)."""
    x0 = torch.tensor([0], dtype=torch.int64)
    x1 = torch.tensor([int(data) & M32], dtype=torch.int64)
    o0, o1 = _hash(key[0], key[1], x0, x1)
    return int(o0[0]), int(o1[0])


def randint(key: Key, shape, lo: int, hi: int, device) -> torch.Tensor:
    """Integers in [lo, hi) from two 32-bit words each (higher and lower
    from the two keys of split(key)), combined modulo the span as JAX
    does."""
    n = math.prod(shape)
    span = hi - lo
    kh, kl = split(key)
    higher = stream(kh, n, device)
    lower = stream(kl, n, device)
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    off = ((higher % span) * mult + (lower % span)) & M32
    return (lo + off % span).reshape(shape)


def permutation(key: Key, n: int, device) -> torch.Tensor:
    """JAX's shuffle of 0..n-1: ceil(3 ln n / ln(2^32 - 1)) rounds, each
    a stable sort by fresh 32-bit words."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(math.ceil(3 * math.log(max(1, n)) / math.log(M32))):
        key, sub = split(key)
        x = x[torch.sort(stream(sub, n, device), stable=True).indices]
    return x


def _unit(b: torch.Tensor) -> torch.Tensor:
    """Words -> f32 in [0, 1): the 23 high bits as a mantissa in [1, 2),
    minus one."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape, device) -> torch.Tensor:
    n = math.prod(shape)
    return stream(key, n, device, _unit, torch.float32).reshape(shape)


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """``uniform < p``, with p rounded to f32."""
    p32 = torch.tensor(p, dtype=torch.float32).item()
    return uniform(key, shape, device) < p32


_NORMAL_LO = -1.0 + 2.0 ** -24        # nextafter(-1, 0) in f32


def _normal(b: torch.Tensor) -> torch.Tensor:
    # u 2 + lo is exact in f64; rounded to f32 once, as JAX's FMA does
    v = (_unit(b).double() * 2.0 + _NORMAL_LO).float().double()
    v = torch.clamp_min(v, _NORMAL_LO)
    return (math.sqrt(2.0) * torch.erfinv(v)).float()


def normal(key: Key, shape, device) -> torch.Tensor:
    """sqrt(2) erfinv(U(nextafter(-1, 0), 1))."""
    n = math.prod(shape)
    return stream(key, n, device, _normal, torch.float32).reshape(shape)


def exponential(key: Key, shape, device) -> torch.Tensor:
    """-log1p(-U[0, 1))."""
    n = math.prod(shape)
    return stream(key, n, device,
                  lambda b: (-torch.log1p(-_unit(b).double())).float(),
                  torch.float32).reshape(shape)


def uniform_range(key: Key, shape, lo: float, hi: float, device
                  ) -> torch.Tensor:
    """``max(lo, u (hi - lo) + lo)`` in f64, rounded to f32."""
    u = uniform(key, shape, device).double()
    return torch.clamp_min(u * (hi - lo) + lo, lo).float()
