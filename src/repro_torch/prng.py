"""JAX's threefry-2x32 PRNG in torch, non-partitionable mode.

The port draws exactly the numbers ``jax.random`` draws under
``jax.threefry_partitionable(False)`` (the mode the reference's committed
goldens were made in), so every stream of a round can be held against the
reference: the 7-lane round split, client sampling, the rand-k support,
the gains, the receiver noise, the minibatch indices and the init.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(``torch.uint32`` lacks most ops, so every word op masks with
``0xFFFFFFFF``). Keys are passed explicitly; nothing is global. All ops
are plain tensor ops on the key's device. The samplers also take a batch
of keys of shape (M, 2) and then draw as ``jax.vmap`` over the keys
would: one row a key.

What is exact and what is not:

- ``split``, ``fold_in``, ``bits``, ``uniform``, ``bernoulli``,
  ``randint``, ``permutation`` and ``choice`` are integer (or
  exactly-rounded) ops and match bit for bit.
- ``uniform`` with a range other than [0, 1) and the erfinv polynomial
  round ``a * b + c`` once, as XLA's CPU backend fuses them into FMAs
  (:func:`fma_f32`).
- ``gamma``, ``loggamma`` and ``dirichlet`` follow JAX's Marsaglia-Tsang
  code step for step (a key per element, the same rejection loops); they
  inherit the ``normal`` and ``log`` gaps below, and a rejection test
  that flips on one of them changes a whole sample. How close they come
  is measured in ``tests/test_torch_prng.py``. ``choice`` with ``p``
  adds a ``cumsum`` whose sums XLA orders its own way.
- ``uniform``, ``normal`` and ``gumbel`` also draw in bfloat16, as JAX
  draws a dtype of fewer than 8 mantissa bits: one byte a value (each
  32-bit word of the stream split into four, low byte first), the
  mantissa from its 7 high bits, and every op rounded to bf16 after it
  as XLA's CPU backend rounds it (upcast to f32, one op, round to
  nearest even); ``erf_inv`` and ``log`` run in f32 on the upcast value
  and round once. A bf16 draw takes one of 128 values, and all 128 are
  held to JAX's in ``tests/test_torch_prng.py``: they match bit for
  bit.
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
    """The two words of one key (shape (2,)), or the (M, 1) word columns
    of a batch of keys (shape (M, 2)), which draws as ``jax.vmap`` over
    the keys would."""
    if key.dtype != torch.int64 or key.ndim not in (1, 2) \
            or key.shape[-1] != 2:
        raise ValueError(f"expected a key (int64, shape (2,)) or a batch of "
                         f"keys (shape (M, 2)), got {key.dtype} "
                         f"{tuple(key.shape)}")
    if key.ndim == 1:
        return key[0], key[1]
    return key[:, 0:1], key[:, 1:2]


def _hash_counts(key: torch.Tensor, n: int,
                 transform: Optional[Callable] = None,
                 dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))`` as JAX computes it: the n counts are
    halved into pairs (i, i + ceil(n/2)) (an odd n pads the second half
    with a 0 count), hashed, and the two output halves concatenated.
    ``transform`` maps each chunk of uint32 words (int64) to the output
    dtype, so a large float draw never holds all of its bits at once.
    A batch of M keys gives (M, n), each row its key's draw."""
    k1, k2 = _key_words(key)
    lead = key.shape[:-1]
    half = (n + 1) // 2
    step = max(1, CHUNK // max(1, math.prod(lead)))
    out = torch.empty(lead + (n,), dtype=dtype, device=key.device)
    for a in range(0, half, step):
        b = min(half, a + step)
        x0 = torch.arange(a, b, dtype=torch.int64, device=key.device)
        x1 = x0 + half
        if b + half > n:            # the padded count of an odd n
            x1[-1] = 0
        o0, o1 = _threefry2x32(k1, k2, x0, x1)
        if transform is not None:
            o0, o1 = transform(o0), transform(o1)
        out[..., a:b] = o0
        hi = min(n, half + b)
        out[..., half + a:hi] = o1[..., :hi - half - a]
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
    """``jax.random.split``: (num, 2) keys; (M, num, 2) for M keys."""
    return _hash_counts(key, 2 * int(num)).reshape(
        key.shape[:-1] + (int(num), 2))


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
    """``jax.random.bits`` (32-bit): uint32 values in an int64 tensor.
    A batch of M keys gives (M,) + shape."""
    shape = _shape(shape)
    return _hash_counts(key, math.prod(shape)).reshape(key.shape[:-1] + shape)


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


def _bits8(key: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's 8-bit draw of n values: ceil(n / 4) words of the stream, each
    split into four bytes, low byte first (``bits.view(uint8)[:n]``)."""
    words = _hash_counts(key, -(-n // 4))
    b = torch.stack([(words >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return b.flatten(-2)[..., :n]


def _bf16(v: float) -> float:
    """v rounded to the nearest bf16 (through f32, as a cast of a Python
    float gives it)."""
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16))


def _rnd(x: torch.Tensor) -> torch.Tensor:
    """An f32 result rounded to bf16: XLA's CPU backend computes a bf16 op
    in f32 and rounds after it."""
    return x.to(torch.bfloat16)


def _uniform_bf16(key: torch.Tensor, n: int, minval: float,
                  maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), jnp.bfloat16, minval, maxval)``:
    ``max(lo, u * (hi - lo) + lo)``, each op rounded to bf16."""
    fb = ((_bits8(key, n) >> 1) | 0x3F80).to(torch.int16)
    u = _rnd(fb.view(torch.bfloat16).float() - 1.0)
    lo, hi = _bf16(minval), _bf16(maxval)
    span = _bf16(hi - lo)
    u = _rnd(_rnd(u.float() * span).float() + lo)
    return torch.clamp_min(u, lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """``jax.random.uniform`` in f32 or bf16."""
    shape = _shape(shape)
    if dtype == torch.bfloat16:
        u = _uniform_bf16(key, math.prod(shape), minval, maxval)
    elif dtype != torch.float32:
        raise TypeError(f"uniform draws float32 or bfloat16, not {dtype}")
    elif minval == 0.0 and maxval == 1.0:
        u = _hash_counts(key, math.prod(shape), _bits_to_unit, torch.float32)
    else:
        u = _hash_counts(key, math.prod(shape),
                         lambda b: _affine(_bits_to_unit(b), minval, maxval),
                         torch.float32)
    return u.reshape(key.shape[:-1] + shape)


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


# XLA's CPU f32 log: Cephes' polynomial for log(1 + x) on [sqrt(1/2) - 1,
# sqrt(2) - 1], evaluated in three interleaved parts with FMAs
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU, op for op: x = m 2^e with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1, and log(2) e
    added in two parts. It agrees with the correctly rounded log on about
    92% of inputs and with XLA's own on every input tried (300,000 in
    [1e-6, 10]); ``torch.log`` agrees with XLA's on about 92%. Zero,
    negative, infinite and NaN inputs give what ``torch.log`` gives."""
    m, e = torch.frexp(x)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    e = e - small.float()
    z = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z2 = z * z
    z3 = z2 * z
    c = [float(_f32(v)) for v in _LOG_P]
    y0 = fma_f32(fma_f32(z, c[0], c[1]), z.double(), c[2])
    y1 = fma_f32(fma_f32(z, c[3], c[4]), z.double(), c[5])
    y2 = fma_f32(fma_f32(z, c[6], c[7]), z.double(), c[8])
    y = fma_f32(fma_f32(y0, z3.double(), y1), z3.double(), y2)
    y = fma_f32(y, z3.double(), e * _f32(_LOG_Q1))
    out = fma_f32(e, _f32(_LOG_Q2), (z - z2 * 0.5) + y)
    special = ~torch.isfinite(x) | (x <= 0)
    return torch.where(special, torch.log(x), out)


_NORMAL_LO = -1.0 + 2.0 ** -24          # nextafter(-1, 0) in f32
_SQRT2_F32 = _f32(math.sqrt(2.0))
_NORMAL_LO_BF16 = -1.0 + 2.0 ** -8      # nextafter(-1, 0) in bf16
_SQRT2_BF16 = _bf16(math.sqrt(2.0))


def _bits_to_erfinv(b: torch.Tensor) -> torch.Tensor:
    return erfinv_f32(_affine(_bits_to_unit(b), _NORMAL_LO, 1.0))


def _bits_to_normal(b: torch.Tensor) -> torch.Tensor:
    return _SQRT2_F32 * _bits_to_erfinv(b)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in f32 or bf16: sqrt(2) erfinv(U(nextafter(-1,
    0), 1)). In bf16 the erfinv runs in f32 on the bf16 uniform and
    rounds once; the product with bf16(sqrt 2) rounds again."""
    shape = _shape(shape)
    if dtype == torch.bfloat16:
        u = _uniform_bf16(key, math.prod(shape), _NORMAL_LO_BF16, 1.0)
        z = _rnd(_rnd(erfinv_f32(u.float())).float() * _SQRT2_BF16)
    elif dtype == torch.float32:
        z = _hash_counts(key, math.prod(shape), _bits_to_normal,
                         torch.float32)
    else:
        raise TypeError(f"normal draws float32 or bfloat16, not {dtype}")
    return z.reshape(key.shape[:-1] + shape)


def normal_fma(key: torch.Tensor, shape: Shape, scale: float,
               addend: torch.Tensor) -> torch.Tensor:
    """``addend + scale * normal(key, shape)`` as XLA's CPU backend
    computes it where the reference adds a scaled draw to another array
    (the receiver noise onto the superposed signal): the erfinv value
    times one constant, ``f32(sqrt 2) * f32(scale)`` folded in f32, added
    with one rounding."""
    shape = _shape(shape)
    w = _hash_counts(key, math.prod(shape), _bits_to_erfinv, torch.float32)
    c = _f32(_SQRT2_F32 * _f32(scale))
    return fma_f32(w.reshape(key.shape[:-1] + shape), c, addend)


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential`` (f32): -log1p(-U[0, 1))."""
    return -torch.log1p(-uniform(key, shape))


def bernoulli(key: torch.Tensor, p: float, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (bool): ``uniform(key, shape) < p``, with
    p rounded to f32 first as JAX does."""
    u = uniform(key, shape)
    return u < torch.tensor(_f32(p), dtype=torch.float32, device=u.device)


_F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in f32 or bf16, in its default ``mode="low"``:
    ``-log(-log(U[tiny, 1)))``, the logs XLA's CPU ``log``
    (:func:`log_f32`); in bf16 each log runs in f32 on the bf16 value and
    rounds to bf16. A batch of M keys gives (M,) + shape."""
    shape = _shape(shape)
    if dtype == torch.bfloat16:
        u = _uniform_bf16(key, math.prod(shape), _F32_TINY, 1.0)
        g = -_rnd(log_f32((-_rnd(log_f32(u.float()))).float()))
    elif dtype == torch.float32:
        g = _hash_counts(
            key, math.prod(shape),
            lambda b: -log_f32(-log_f32(_affine(_bits_to_unit(b), _F32_TINY,
                                                1.0))), torch.float32)
    else:
        raise TypeError(f"gumbel draws float32 or bfloat16, not {dtype}")
    return g.reshape(key.shape[:-1] + shape)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, with
    replacement and the default ``mode`` ("low"): the argmax of
    ``gumbel(key, logits.shape) + logits`` (the first index of a tie),
    the Gumbel drawn and added in the logits' dtype (f32 or bf16) as JAX
    draws it. A batch of M keys with logits (M, V) draws one index a
    row, as ``jax.vmap`` over both would."""
    g = gumbel(key, logits.shape[key.ndim - 1:], dtype=logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` for int32, returned as int64 (torch's index
    type): two 32-bit draws combined modulo the span, with JAX's uint32
    wrap-around. Spans up to 2^31 (every int32 range)."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    k = split(key)
    higher = bits(k[..., 0, :], shape)
    lower = bits(k[..., 1, :], shape)
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
           replace: bool = True, p: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace, p)``. With ``p`` (and
    ``replace``): the inverse CDF, ``searchsorted(cumsum(p), cdf[-1] *
    (1 - U))`` on the left side. A batch of M keys with p of shape
    (M, n) draws as ``jax.vmap`` over both."""
    shape = _shape(shape)
    m = math.prod(shape)
    if p is not None:
        if not replace:
            raise NotImplementedError("choice with p and replace=False "
                                      "(JAX's Gumbel top-k) is not ported")
        cdf = torch.cumsum(p.float(), dim=-1)
        u = uniform(key, shape).reshape(key.shape[:-1] + (m,))
        r = cdf[..., -1:] * (1.0 - u)
        return torch.searchsorted(cdf, r).reshape(
            key.shape[:-1] + shape)
    if not replace:
        if m > n:
            raise ValueError(f"cannot take {m} of {n} without replacement")
        return permutation(key, n)[:m].reshape(shape)
    return randint(key, shape, 0, n)


# ------------------------------------------------------------------ gamma

def _f32_const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _gamma_one(keys: torch.Tensor, alpha: torch.Tensor, log_space: bool
               ) -> torch.Tensor:
    """JAX's ``_gamma_one`` (Marsaglia-Tsang) for M keys and M alphas at
    once. Each element keeps its own key stream; the two rejection loops
    run masked over every element, one ``.any()`` a trip, and an element
    whose loop has ended keeps its values, as a vmapped ``while_loop``
    keeps them. ``a * b + c`` rounds once where XLA's CPU backend
    contracts it into an FMA."""
    one = _f32_const(1.0, alpha)
    third = _f32_const(1.0 / 3.0, alpha)
    boost_mask = alpha >= one
    a = torch.where(boost_mask, alpha, alpha + one)
    d = a - third
    c = third / torch.sqrt(d)

    ks = split(keys)
    key, subkey = ks[:, 0], ks[:, 1]
    x_sq = torch.zeros_like(alpha)
    v_cube = torch.ones_like(alpha)
    u = torch.full_like(alpha, 2.0)

    def rejected(x_sq, v_cube, u):
        squeeze = fma_f32(x_sq * x_sq, -_f32(0.0331), 1.0)
        rhs = fma_f32(d, (one - v_cube) + log_f32(v_cube), x_sq * 0.5)
        return (u >= squeeze) & (log_f32(u) >= rhs)

    active = rejected(x_sq, v_cube, u)
    while bool(active.any()):
        k3 = split(key, 3)
        new_key, x_key, u_key = k3[:, 0], k3[:, 1], k3[:, 2]
        x = torch.zeros_like(alpha)
        v = -torch.ones_like(alpha)
        inner = v <= 0
        while bool(inner.any()):
            k2 = split(x_key)
            z = normal(k2[:, 1], ())
            x = torch.where(inner, z, x)
            v = torch.where(inner, fma_f32(z, c, 1.0), v)
            x_key = torch.where(inner[:, None], k2[:, 0], x_key)
            inner = v <= 0
        x_sq = torch.where(active, x * x, x_sq)
        v_cube = torch.where(active, v * v * v, v_cube)
        u = torch.where(active, uniform(u_key, ()), u)
        key = torch.where(active[:, None], new_key, key)
        active = active & rejected(x_sq, v_cube, u)
    if log_space:
        log_samples = torch.log1p(-uniform(subkey, ()))
        log_boost = torch.where(boost_mask | (log_samples == 0),
                                torch.zeros_like(alpha),
                                log_samples * (one / alpha))
        return (log_f32(d) + log_f32(v_cube)) + log_boost
    samples = one - uniform(subkey, ())
    boost = torch.where(boost_mask, one, torch.pow(samples, one / alpha))
    return d * v_cube * boost


def _gamma(key: torch.Tensor, a, shape: Optional[Shape], log_space: bool
           ) -> torch.Tensor:
    """JAX's ``_gamma_impl``: ``a`` broadcast to ``shape`` and one key a
    element, ``split(key, prod(shape))`` in row-major order."""
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = tuple(a.shape) if shape is None else _shape(shape)
    a = torch.broadcast_to(a, shape).reshape(-1)
    m = math.prod(shape)
    if m == 0:
        return torch.empty(shape, dtype=torch.float32, device=key.device)
    keys = split(key, m)
    return _gamma_one(keys, a, log_space).reshape(shape)


def gamma(key: torch.Tensor, a, shape: Optional[Shape] = None
          ) -> torch.Tensor:
    """``jax.random.gamma`` (f32, unit rate)."""
    return _gamma(key, a, shape, log_space=False)


def loggamma(key: torch.Tensor, a, shape: Optional[Shape] = None
             ) -> torch.Tensor:
    """``jax.random.loggamma``: log of a Gamma(a) sample, drawn in log
    space (so small ``a`` does not underflow)."""
    return _gamma(key, a, shape, log_space=True)


def dirichlet(key: torch.Tensor, alpha, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.dirichlet``: ``softmax(loggamma(key, alpha, shape +
    (n,)), -1)``, with JAX's softmax (exp of x - max, over its sum)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    lg = loggamma(key, alpha, _shape(shape) + tuple(alpha.shape[-1:]))
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)
