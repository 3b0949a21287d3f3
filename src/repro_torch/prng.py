"""JAX's threefry-2x32 PRNG in torch, non-partitionable mode.

The port draws exactly the numbers ``jax.random`` draws under
``jax.threefry_partitionable(False)`` (the mode the reference's committed
goldens were made in), so every stream of a round can be held against the
reference: the 7-lane round split, client sampling, the rand-k support,
the gains, the receiver noise, the minibatch indices and the init.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(``torch.uint32`` lacks most ops, so every word op masks with
``0xFFFFFFFF``). Keys are passed explicitly; nothing is global. All ops
are plain tensor ops on the key's device.

What is exact and what is not:

- ``split``, ``fold_in``, ``bits``, ``uniform``, ``randint``,
  ``permutation`` and ``choice`` are integer (or exactly-rounded) ops and
  match bit for bit.
- ``uniform`` with a range other than [0, 1) and the erfinv polynomial
  round ``a * b + c`` once, as XLA's CPU backend fuses them into FMAs
  (:func:`fma_f32`).
- ``normal`` goes through XLA's f32 erfinv polynomial (Giles), ported
  op for op below; ``torch.log1p`` differs from XLA's ``log1p`` in the
  last ulp for some inputs, which leaves a gap of a few ulp on about one
  value in a hundred, and a larger one on the rare value that lands on
  the other side of the polynomial's branch at w = 5 (pinned in
  ``tests/test_torch_prng.py``). ``exponential`` is ``-log1p(-u)`` with
  the same caveat.
"""
from __future__ import annotations

import math
import struct
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# counter pairs hashed per chunk: keeps the int64 temporaries of a large
# draw (the 153M-value image noise) to a few hundred MB
CHUNK = 1 << 23

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape):
    if isinstance(shape, int):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under
    the key words (k1, k2); all uint32 values carried in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _key_words(key: torch.Tensor):
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"expected one key: int64 tensor of shape (2,), got "
                         f"{key.dtype} {tuple(key.shape)}")
    return key[0], key[1]


def _hash_counts(key: torch.Tensor, n: int,
                 transform: Optional[Callable] = None,
                 dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))`` as JAX computes it: the n counts are
    halved into pairs (i, i + ceil(n/2)) (an odd n pads the second half
    with a 0 count), hashed, and the two output halves concatenated.
    ``transform`` maps each chunk of uint32 words (int64) to the output
    dtype, so a large float draw never holds all of its bits at once."""
    k1, k2 = _key_words(key)
    half = (n + 1) // 2
    out = torch.empty((n,), dtype=dtype, device=key.device)
    for a in range(0, half, CHUNK):
        b = min(half, a + CHUNK)
        x0 = torch.arange(a, b, dtype=torch.int64, device=key.device)
        x1 = x0 + half
        if b + half > n:            # the padded count of an odd n
            x1[-1] = 0
        o0, o1 = _threefry2x32(k1, k2, x0, x1)
        if transform is not None:
            o0, o1 = transform(o0), transform(o1)
        out[a:b] = o0
        hi = min(n, half + b)
        out[half + a:hi] = o1[:hi - half - a]
    return out


# ------------------------------------------------------------------ keys

def PRNGKey(seed: int, device: Union[str, torch.device] = "cuda"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is an int32, so
    the key is ``[0, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def key_from_words(words, device: Union[str, torch.device] = "cuda"
                   ) -> torch.Tensor:
    """A key (or key array) from uint32 words, e.g. a JAX key as numpy."""
    return torch.as_tensor(np.asarray(words, dtype=np.int64) & MASK32,
                           device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys."""
    return _hash_counts(key, 2 * int(num)).reshape(int(num), 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``. ``data`` may be an int or an integer tensor,
    in which case the result holds one key per element (the vmapped fold
    the bank's cohort lanes use)."""
    k1, k2 = _key_words(key)
    if isinstance(data, torch.Tensor):
        x1 = data.to(device=key.device, dtype=torch.int64) & MASK32
        o0, o1 = _threefry2x32(k1, k2, torch.zeros_like(x1), x1)
        return torch.stack([o0, o1], dim=-1)
    x1 = torch.tensor([int(data) & MASK32], dtype=torch.int64,
                      device=key.device)
    o0, o1 = _threefry2x32(k1, k2, torch.zeros_like(x1), x1)
    return torch.cat([o0, o1])


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 values in an int64 tensor."""
    shape = _shape(shape)
    return _hash_counts(key, math.prod(shape)).reshape(shape)


# --------------------------------------------------------------- samplers

def _bits_to_unit(b: torch.Tensor) -> torch.Tensor:
    """uint32 words -> f32 in [0, 1): the 23 high bits as the mantissa of a
    float in [1, 2), minus one — JAX's bit-exact construction."""
    fb = ((b >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as XLA's CPU backend contracts
    it: the f32 product is exact in f64, so only the sum rounds (then to
    f32; the double rounding differs from a true FMA only on exact ties)."""
    return (a.double() * b + c).float()


def _f32(x: float) -> float:
    """x rounded to the nearest f32."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _affine(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(lo, u * (hi - lo) + lo)`` with lo, hi and hi - lo in f32."""
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(hi - lo)
    return torch.clamp_min(fma_f32(u, span, lo), lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (f32)."""
    shape = _shape(shape)
    if minval == 0.0 and maxval == 1.0:
        u = _hash_counts(key, math.prod(shape), _bits_to_unit, torch.float32)
        return u.reshape(shape)
    u = _hash_counts(key, math.prod(shape),
                     lambda b: _affine(_bits_to_unit(b), minval, maxval),
                     torch.float32)
    return u.reshape(shape)


# XLA's f32 erfinv (Giles, "Approximating the erfinv function"), as the
# CHLO decomposition emits it: coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, op for op (``w = -log1p(-x*x)``)."""
    w = -torch.log1p(x * (-x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))

    p = coeff(0)
    for i in range(1, 9):
        p = fma_f32(p, w.double(), coeff(i).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = -1.0 + 2.0 ** -24          # nextafter(-1, 0) in f32
_SQRT2_F32 = _f32(math.sqrt(2.0))


def _bits_to_normal(b: torch.Tensor) -> torch.Tensor:
    return _SQRT2_F32 * erfinv_f32(_affine(_bits_to_unit(b), _NORMAL_LO, 1.0))


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` (f32): sqrt(2) erfinv(U(nextafter(-1, 0), 1))."""
    shape = _shape(shape)
    z = _hash_counts(key, math.prod(shape), _bits_to_normal, torch.float32)
    return z.reshape(shape)


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential`` (f32): -log1p(-U[0, 1))."""
    return -torch.log1p(-uniform(key, shape))


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` for int32, returned as int64 (torch's index
    type): two 32-bit draws combined modulo the span, with JAX's uint32
    wrap-around. Spans up to 2^31 (every int32 range)."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    k = split(key)
    higher = bits(k[0], shape)
    lower = bits(k[1], shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = ((higher % span) * multiplier + (lower % span)) & MASK32
    return minval + offset % span


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: JAX's sort-based shuffle — a
    stable sort by fresh 32-bit keys, ceil(3 ln n / ln(2^32 - 1)) times."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, n), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (),
           replace: bool = True) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` without ``p``."""
    shape = _shape(shape)
    m = math.prod(shape)
    if not replace:
        if m > n:
            raise ValueError(f"cannot take {m} of {n} without replacement")
        return permutation(key, n)[:m].reshape(shape)
    return randint(key, shape, 0, n)
