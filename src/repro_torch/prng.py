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

Every sampler matches bit for bit on the CPU, and the same ops give the
same bits on the GPU:

- ``split``, ``fold_in``, ``bits``, ``uniform``, ``bernoulli``,
  ``randint``, ``permutation`` and ``choice`` are integer (or
  exactly-rounded) ops.
- The float samplers run XLA's CPU f32 code op for op: its ``log``,
  ``log1p``, ``exp``, ``erf``, ``erfc``, ``rsqrt`` and ``erf_inv`` (not
  torch's, which differ in the last bit on up to half of the inputs),
  ``a * b + c`` rounded once where XLA's backend contracts it into an
  FMA (:func:`fma_f32`), denormals flushed as XLA flushes them, glibc's
  ``powf`` for the gamma boost, and sums in XLA's order (:func:`sum_last`).
  ``tests/test_torch_prng.py`` holds each function on a stratified
  sample and each sampler on draws; ``tests/sweep_torch_xla_math.py``
  sweeps every f32 of the draws' ranges.
- ``gamma``, ``loggamma`` and ``dirichlet`` follow JAX's Marsaglia-Tsang
  code step for step (a key per element, the same rejection loops).
- ``uniform``, ``normal`` and ``gumbel`` also draw in bfloat16, as JAX
  draws a dtype of fewer than 8 mantissa bits: one byte a value (each
  32-bit word of the stream split into four, low byte first), the
  mantissa from its 7 high bits, and every op rounded to bf16 after it
  as XLA's CPU backend rounds it (upcast to f32, one op, round to
  nearest even); ``erf_inv`` and ``log`` run in f32 on the upcast value
  and round once.
- Where the reference's jitted code folds a draw's scale into its
  constant and contracts the sum it feeds, :func:`normal_fma` and
  :func:`normal_scaled` do the same.
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


def _fma_sum(a: torch.Tensor, b, c):
    """``a * b + c`` in f64, a fresh tensor: the f32 product is exact in
    f64 and the sum rounds once, to f64. ``b`` may be an f64 tensor (a
    value cast once for a chain of steps); the product then runs in f64
    without casting ``a`` first. Returns the sum and ``a`` as multiplied."""
    if not (isinstance(b, torch.Tensor) and b.dtype == torch.float64
            and b.dim() > 0):
        a = a.double()
    t = a * b
    if isinstance(c, torch.Tensor) and \
            torch.broadcast_shapes(t.shape, c.shape) != t.shape:
        return t + c, a
    return t.add_(c), a


def _fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded to f64, then to f32. The double rounding
    differs from one rounding only where the f64 sum falls exactly on a
    midpoint between two f32 values, which the draws' transforms never
    meet on their inputs (every 23-bit uniform mantissa, swept in
    ``tests/sweep_torch_xla_math.py``); everything else uses
    :func:`fma_f32`."""
    return _fma_sum(a, b, c)[0].float()


_MIDPOINT_MASK, _MIDPOINT = (1 << 29) - 1, 1 << 28   # the 29 bits f32 drops
_FMA_SLICE = 1 << 20


def _flat(x, shape):
    """A number or 0-dim tensor as it is; a tensor flattened in the
    broadcast ``shape`` (a copy only where it broadcasts)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    if tuple(x.shape) != tuple(shape):
        x = torch.broadcast_to(x, shape)
    return x.reshape(-1)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as XLA's CPU backend contracts
    it into an FMA: the sum in f64 (:func:`_fma_sum`); where it falls
    exactly on a midpoint between two f32 values but the exact sum does
    not (its error, by Knuth's two-sum), it moves one f64 ulp toward the
    exact sum, so the rounding to f32 is the FMA's. The check runs on
    slices of 2^20 elements, so it adds no full-size temporary."""
    t, a = _fma_sum(a, b, c)
    t = t.contiguous()
    flat = t.view(-1)
    fa, fb, fc = (_flat(v, t.shape) for v in (a, b, c))
    for lo in range(0, flat.numel(), _FMA_SLICE):
        sl = slice(lo, lo + _FMA_SLICE)
        s = flat[sl]
        prod = (fa if fa.dim() == 0 else fa[sl]) * (
            fb if not isinstance(fb, torch.Tensor) or fb.dim() == 0
            else fb[sl])
        cs = fc[sl] if isinstance(fc, torch.Tensor) and fc.dim() else fc
        v = s - prod
        err = (prod - (s - v)) + (cs - v)
        mid = (s.view(torch.int64) & _MIDPOINT_MASK) == _MIDPOINT
        s.copy_(torch.where(mid & (err != 0),
                            torch.nextafter(s, err * math.inf), s))
    return t.float()


def _f32(x: float) -> float:
    """x rounded to the nearest f32."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _affine(u: torch.Tensor, minval: float, maxval: float,
            fma=fma_f32) -> torch.Tensor:
    """``max(lo, u * (hi - lo) + lo)`` with lo, hi and hi - lo in f32."""
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(hi - lo)
    return torch.clamp_min(fma(u, span, lo), lo)


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


# ------------------------------------------- XLA's CPU f32 elementary ops
#
# XLA's CPU backend computes log, log1p, exp, erf, erfc, rsqrt and erf_inv
# with its own f32 code, runs with denormals flushed (DAZ and FTZ: a
# subnormal input reads as a zero of its sign, a subnormal result is
# written as one), and contracts ``a * b + c`` into an FMA where LLVM's
# x86 backend does. Each function below is that code, op for op, in IEEE
# f32 ops (``+ - * /``, ``sqrt``, ``floor``, selects and bit ops) and
# :func:`fma_f32`, which round alike on the CPU and the GPU.

_F32_TINY = float(np.finfo(np.float32).tiny)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """A subnormal f32 as the zero of its sign (XLA's DAZ and FTZ)."""
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 ``sqrt`` (XLA's): through f64, since
    ``torch.sqrt`` on the CPU is off by an ulp on some inputs."""
    return torch.sqrt(x.double()).float()


def _horner(x: torch.Tensor, p, coeffs, fma=fma_f32) -> torch.Tensor:
    """Horner's rule ``p = p * x + c`` over ``coeffs``, each step one
    rounding (an FMA); ``p`` starts as a tensor or a constant; ``x`` may
    be the f64 cast of the f32 value."""
    xd = x.double()
    for c in coeffs:
        p = fma(xd, p, _f32(c)) if isinstance(p, float) else \
            fma(p, xd, _f32(c))
    return p


# XLA's f32 erfinv (Giles, "Approximating the erfinv function"), as the
# CHLO decomposition emits it: coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_poly(x: torch.Tensor, fma=fma_f32) -> torch.Tensor:
    """The polynomial of ``erf_inv`` (x not subnormal): ``w =
    -log1p(-x*x)`` (the product rounded, then XLA's log1p), Giles'
    polynomial of w's side of 5."""
    w = -_log1p(x * (-x), fma)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)

    def coeff(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))

    p = coeff(0)
    for i in range(1, 9):
        p = fma(p, w.double(), coeff(i).double())
    return p


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv`` on the draws' inputs (none within a factor 2 of the
    smallest normal, every one swept): the polynomial times x, its FMAs
    through f64 (:func:`_fma_f64`)."""
    return torch.where(x.abs() == 1.0, x * math.inf,
                       _erfinv_poly(x, _fma_f64) * x)


def _mul_ftz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b`` flushed as XLA's CPU flushes it: to a zero where the
    exact product lies below the smallest normal, also where it rounds up
    to it (the exact product, in f64, rounds once to f32)."""
    exact = a.double() * b.double()
    return torch.where(exact.abs() < _F32_TINY, exact * 0.0, exact).float()


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, op for op."""
    x = _flush(x)
    return torch.where(x.abs() == 1.0, x * math.inf,
                       _mul_ftz(_erfinv_poly(x), x))


# XLA's CPU f32 log: Cephes' polynomial for log(1 + x) on [sqrt(1/2) - 1,
# sqrt(2) - 1], evaluated in three interleaved parts with FMAs
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _log(x: torch.Tensor, fma=fma_f32) -> torch.Tensor:
    """``log`` on inputs that are not subnormal (see :func:`log_f32`)."""
    m, e = torch.frexp(x)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    e = e - small.float()
    z = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z2 = z * z
    c = [float(_f32(v)) for v in _LOG_P]
    zd, z3d = z.double(), (z2 * z).double()
    y0 = fma(fma(zd, c[0], c[1]), zd, c[2])
    y1 = fma(fma(zd, c[3], c[4]), zd, c[5])
    y2 = fma(fma(zd, c[6], c[7]), zd, c[8])
    y = fma(fma(y0, z3d, y1), z3d, y2)
    y = fma(y, z3d, e * _f32(_LOG_Q1))
    out = fma(e, _f32(_LOG_Q2), (z - z2 * 0.5) + y)
    special = ~torch.isfinite(x) | (x <= 0)
    return torch.where(special, torch.log(x), out)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU, op for op: x = m 2^e with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1, and log(2) e
    added in two parts. It agrees with the correctly rounded log on about
    92% of inputs and with XLA's own on every input (``torch.log`` agrees
    with XLA's on about 92%). A subnormal input reads as zero (-inf out);
    zero, negative, infinite and NaN inputs give what ``torch.log``
    gives."""
    return _log(_flush(x))


# XLA's CPU f32 log1p: Cephes' rational approximation below |x| < sqrt(2)
# - 1, log(1 + x) (the sum rounded) above it
_LOG1P_NUM = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
              57.112965, 20.039553)
_LOG1P_DEN = (15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
              60.11866)
_LOG1P_SMALL = 0.41421357


def _log1p(x: torch.Tensor, fma=fma_f32) -> torch.Tensor:
    """``log1p`` on inputs that are not subnormal (see :func:`log1p_f32`).
    Both branches run on every value, as in XLA's code; the temporaries
    are freed as they die, since the draws run it on chunks of 2^23."""
    t = x * 0.0                 # XLA's code keeps the 0 * x term (NaN at inf)
    xd = x.double()
    num = _horner(xd, t + _f32(_LOG1P_NUM[0]), _LOG1P_NUM[1:], fma)
    den = _horner(xd, t.add_(1.0), _LOG1P_DEN, fma)
    del t, xd
    ratio = num.div_(den)
    del den
    x2 = x * x
    small = x + fma(x2, -0.5, (x * x2).mul_(ratio))
    del ratio, x2
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small, _log(x + 1.0, fma))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` (HLO ``log-plus-one``) on the CPU, op for op:
    below |x| = sqrt(2) - 1 ``x - x^2/2 + x^3 P(x)/Q(x)`` (Cephes' degree
    6/6 rational, Horner with FMAs, the ``-x^2/2`` added with one
    rounding), above it :func:`log_f32` of the rounded ``1 + x``."""
    return _flush(_log1p(_flush(x)))


# XLA's CPU f32 exp: Cephes' expf (x = n ln 2 + r, ln 2 in two parts, a
# degree-5 polynomial in r, times 2^n built in the exponent bits)
_EXP_LO, _EXP_HI = -87.8, 88.8
_EXP_LOG2E = 1.442695
_EXP_P = (0.00019875691, 0.0013981999, 0.008333452, 0.041665796,
          0.16666666, 0.5)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp`` on the CPU, op for op: x clamped to [-87.8,
    88.8], n = floor(x log2(e) + 1/2) (one rounding) clamped to [-127,
    127], r = x - n ln 2 with ln 2 in two parts (FMAs), ``1 + (r + r^2
    P(r))`` times 2^n (zero where n = -127)."""
    x = torch.clamp(_flush(x), _f32(_EXP_LO), _f32(_EXP_HI))
    n = torch.clamp(torch.floor(fma_f32(x, _f32(_EXP_LOG2E), 0.5)),
                    -127.0, 127.0)
    nd = n.double()
    r = fma_f32(nd, -_f32(_LOG_Q2), x)
    r = fma_f32(nd, -_f32(_LOG_Q1), r)
    p = _horner(r, _f32(_EXP_P[0]), _EXP_P[1:])
    y = fma_f32(p, (r * r).double(), r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(y * scale)


# XLA's CPU f32 erf: Eigen's rational approximation on [-3.7439213,
# 3.7439213] (x P(x^2) / Q(x^2), Horner with FMAs)
_ERF_CLAMP = 3.7439213
_ERF_P = (0.00022905065, 0.003408291, 0.050955694, 0.18520832, 1.1283791)
_ERF_Q = (-1.1791603e-07, 2.3547966e-05, 0.0010179626, 0.01407047,
          0.11098505, 0.49746925, 1.0)


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf`` on the CPU, op for op."""
    x = torch.clamp(_flush(x), -_f32(_ERF_CLAMP), _f32(_ERF_CLAMP))
    x2 = x * x
    return _flush((x * _horner(x2, _f32(_ERF_P[0]), _ERF_P[1:]))
                  / _horner(x2, _f32(_ERF_Q[0]), _ERF_Q[1:]))


# StableHLO's f32 erfc decomposition (Cephes' erfcf): 1 - x P(x^2) below
# |x| = 1; above it exp(-x^2) / |x| times a polynomial in 1 / x^2, one
# for |x| < 2 and one above, zero past x^2 = 88.7228394, 2 minus it for
# x < 0
_ERFC_SMALL = (7.85386146e-05, -0.000801019371, 0.00518832775,
               -0.0268538129, 0.112835854, -0.37612626, 1.12837911)
_ERFC_LT2 = (0.0232682, -0.138703942, 0.368742466, -0.582473278,
             0.621000469, -0.494451523, 0.340488, -0.274112701,
             0.563825965)
_ERFC_GE2 = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
             0.42184633, -0.282076746, 0.564189494)
_ERFC_UNDERFLOW = 88.7228394


def erfc_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erfc`` on the CPU, op for op (``1 - x P`` with one
    rounding; every Horner step an FMA; ``exp`` is :func:`exp_f32`)."""
    x = _flush(x)
    ax = x.abs()
    x2 = x * x
    small = fma_f32(-x.double(), _horner(x2, _f32(_ERFC_SMALL[0]),
                                         _ERFC_SMALL[1:]), 1.0)
    z = 1.0 / x2
    big = (exp_f32(-x2) * (1.0 / ax)) * torch.where(
        ax < 2.0, _horner(z, _f32(_ERFC_LT2[0]), _ERFC_LT2[1:]),
        _horner(z, _f32(_ERFC_GE2[0]), _ERFC_GE2[1:]))
    big = torch.where(x2 > _f32(_ERFC_UNDERFLOW), torch.zeros_like(big), big)
    big = torch.where(x < 0, 2.0 - big, big)
    return _flush(torch.where(ax < 1.0, small, big))


_HALF_SQRT2 = _f32(0.5 * _f32(math.sqrt(2.0)))


def ndtr_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.ndtr`` in f32: with w = x sqrt(1/2) (rounded),
    ``(1 + erf(w)) / 2`` where |w| < sqrt(1/2), else ``(2 - erfc(|w|)) /
    2`` for w > 0 and ``erfc(|w|) / 2`` below, through :func:`erf_f32` and
    :func:`erfc_f32`."""
    w = _flush(x) * _HALF_SQRT2
    z = w.abs()
    y = torch.where(z < _HALF_SQRT2, 1.0 + erf_f32(w),
                    torch.where(w > 0, 2.0 - erfc_f32(z), erfc_f32(z)))
    return _flush(0.5 * y)


def _rsqrt_estimate(x: torch.Tensor) -> torch.Tensor:
    """x86's ``rsqrtps`` on a positive normal f32: 1/sqrt of the midpoint
    of x's bucket (its exponent's parity and 10 high mantissa bits),
    rounded to 13 bits. Equal to the instruction on every input tried
    (2^24 random positive normals)."""
    b = x.view(torch.int32)
    e = (b >> 23) - 127
    k = ((b >> 13) & 0x3FF).double()
    mid = (1.0 + (k + 0.5) / 1024.0) * (1 + (e & 1)).double()
    y = torch.round((1.0 / torch.sqrt(mid)) * 8192.0) / 8192.0
    scale = ((1023 - (e >> 1)).to(torch.int64) << 52).view(torch.float64)
    return (y * scale).float()


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``rsqrt`` on the CPU: the ``rsqrtps`` estimate, then two
    Newton steps ``y + (-y/2) (x y y - 1)`` (``x y`` rounded, the rest two
    FMAs); anything but a positive normal takes the estimate alone, which
    is the exact ``1/sqrt`` of its flushed input (inf, 0 or NaN)."""
    x = _flush(x)
    normal = (x > 0) & torch.isfinite(x)
    y = _rsqrt_estimate(torch.where(normal, x, torch.ones_like(x)))
    for _ in range(2):
        e = fma_f32(x * y, y.double(), -1.0)
        y = fma_f32(y * -0.5, e.double(), y)
    return torch.where(normal, y, torch.rsqrt(x))


# glibc's powf (the CPU ``pow`` XLA calls, FMA build): log2(x) from a
# 16-entry table of (1/c, log2 c) and a degree-5 polynomial, 2^(y log2 x)
# from a 32-entry table of 2^(j/32) and a cubic, all in f64
_POWF_LOG2 = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
_POWF_LOG2_POLY = ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
                   "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
                   "0x1.71547652ab82bp+0")
_POWF_EXP2 = (
    "0x1.0000000000000p+0", "0x1.059b0d3158574p+0", "0x1.0b5586cf9890fp+0",
    "0x1.11301d0125b51p+0", "0x1.172b83c7d517bp+0", "0x1.1d4873168b9aap+0",
    "0x1.2387a6e756238p+0", "0x1.29e9df51fdee1p+0", "0x1.306fe0a31b715p+0",
    "0x1.371a7373aa9cbp+0", "0x1.3dea64c123422p+0", "0x1.44e086061892dp+0",
    "0x1.4bfdad5362a27p+0", "0x1.5342b569d4f82p+0", "0x1.5ab07dd485429p+0",
    "0x1.6247eb03a5585p+0", "0x1.6a09e667f3bcdp+0", "0x1.71f75e8ec5f74p+0",
    "0x1.7a11473eb0187p+0", "0x1.82589994cce13p+0", "0x1.8ace5422aa0dbp+0",
    "0x1.93737b0cdc5e5p+0", "0x1.9c49182a3f090p+0", "0x1.a5503b23e255dp+0",
    "0x1.ae89f995ad3adp+0", "0x1.b7f76f2fb5e47p+0", "0x1.c199bdd85529cp+0",
    "0x1.cb720dcef9069p+0", "0x1.d5818dcfba487p+0", "0x1.dfc97337b9b5fp+0",
    "0x1.ea4afa2a490dap+0", "0x1.f50765b6e4540p+0")
_POWF_EXP2_POLY = ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                   "0x1.62e42ff0c52d6p-1")
_POWF_SHIFT = float.fromhex("0x1.8p+47")     # rounds to a multiple of 1/32


def _fma_double(a: torch.Tensor, b, c) -> torch.Tensor:
    """f64 ``a * b + c`` with (almost always) one rounding: the product
    split exactly (Dekker), the sum with its error (Knuth), the two error
    terms added last."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    p = a * b
    sa, sb = a * 134217729.0, b * 134217729.0
    ah, bh = sa - (sa - a), sb - (sb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    t = (p - (s - v)) + (c - v)
    return s + (t + e)


def _powf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """glibc's ``powf(x, y)`` for positive normal f32 x and finite f32 y
    (the gamma sampler's boost), with XLA's FTZ on the result."""
    dev = x.device
    f = float.fromhex
    ix = x.view(torch.int32).to(torch.int64)
    tmp = (ix - 0x3F330000) & MASK32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = torch.where(top >= 2 ** 31, top - 2 ** 32, top) >> 23
    z = ((ix - top) & MASK32).to(torch.int32).view(torch.float32).double()
    invc = torch.tensor([f(a) for a, _ in _POWF_LOG2], dtype=torch.float64,
                        device=dev)[i]
    logc = torch.tensor([f(b) for _, b in _POWF_LOG2], dtype=torch.float64,
                        device=dev)[i]
    a = [f(v) for v in _POWF_LOG2_POLY]
    r = _fma_double(z, invc, -1.0)
    r2 = r * r
    q = _fma_double(r, a[4], logc + k.double())
    q = _fma_double(r2, _fma_double(r, a[2], a[3]), q)
    log2x = _fma_double(_fma_double(r, a[0], a[1]), r2 * r2, q)
    ylogx = torch.clamp_min(y.double() * log2x, -150.0)
    kd = (ylogx + _POWF_SHIFT) - _POWF_SHIFT
    kn = (kd * 32.0).to(torch.int64)
    s = torch.tensor([f(v) for v in _POWF_EXP2], dtype=torch.float64,
                     device=dev)[kn & 31] \
        * ((((kn >> 5) + 1023) << 52).view(torch.float64))
    r = ylogx - kd
    c = [f(v) for v in _POWF_EXP2_POLY]
    out = _fma_double(_fma_double(r, c[0], c[1]), r * r, _fma_double(r, c[2], 1.0)) * s
    return _flush(torch.where(ylogx <= -150.0, 0.0, out).float())


_NORMAL_LO = -1.0 + 2.0 ** -24          # nextafter(-1, 0) in f32
_SQRT2_F32 = _f32(math.sqrt(2.0))
_NORMAL_LO_BF16 = -1.0 + 2.0 ** -8      # nextafter(-1, 0) in bf16
_SQRT2_BF16 = _bf16(math.sqrt(2.0))


def _bits_to_erfinv(b: torch.Tensor) -> torch.Tensor:
    return _erfinv(_affine(_bits_to_unit(b), _NORMAL_LO, 1.0, _fma_f64))


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
        z = _rnd(_rnd(_erfinv(u.float())).float() * _SQRT2_BF16)
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


def normal_scaled(key: torch.Tensor, shape: Shape, scale: float
                  ) -> torch.Tensor:
    """``scale * normal(key, shape)`` as XLA's CPU backend computes it
    where the product is one term of a sum whose other product it
    contracts (the Markov latent's ``rho z + sqrt(1 - rho^2) xi``): the
    erfinv value times ``f32(sqrt 2) * f32(scale)`` folded in f32."""
    shape = _shape(shape)
    w = _hash_counts(key, math.prod(shape), _bits_to_erfinv, torch.float32)
    return w.reshape(key.shape[:-1] + shape) * _f32(_SQRT2_F32 * _f32(scale))


def _bits_to_exponential(b: torch.Tensor) -> torch.Tensor:
    return -_log1p(-_bits_to_unit(b), _fma_f64)


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential`` (f32): -log1p(-U[0, 1)), XLA's log1p."""
    shape = _shape(shape)
    return _hash_counts(key, math.prod(shape), _bits_to_exponential,
                        torch.float32).reshape(key.shape[:-1] + shape)


def bernoulli(key: torch.Tensor, p: float, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (bool): ``uniform(key, shape) < p``, with
    p rounded to f32 first as JAX does."""
    u = uniform(key, shape)
    return u < torch.tensor(_f32(p), dtype=torch.float32, device=u.device)


def _bits_to_gumbel(b: torch.Tensor) -> torch.Tensor:
    u = _affine(_bits_to_unit(b), _F32_TINY, 1.0, _fma_f64)
    return -_log(-_log(u, _fma_f64), _fma_f64)


def gumbel(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in f32 or bf16, in its default ``mode="low"``:
    ``-log(-log(U[tiny, 1)))``, the logs XLA's CPU ``log``
    (:func:`log_f32`); in bf16 each log runs in f32 on the bf16 value and
    rounds to bf16. A batch of M keys gives (M,) + shape."""
    shape = _shape(shape)
    if dtype == torch.bfloat16:
        u = _uniform_bf16(key, math.prod(shape), _F32_TINY, 1.0)
        g = -_rnd(_log((-_rnd(_log(u.float(), _fma_f64))).float(),
                       _fma_f64))
    elif dtype == torch.float32:
        g = _hash_counts(key, math.prod(shape), _bits_to_gumbel,
                         torch.float32)
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
    c = third * rsqrt_f32(d)         # XLA rewrites 1/3 / sqrt(d)

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
        log_samples = _log1p(-uniform(subkey, ()))
        log_boost = torch.where(boost_mask | (log_samples == 0),
                                torch.zeros_like(alpha),
                                log_samples * (one / alpha))
        return (log_f32(d) + log_f32(v_cube)) + log_boost
    samples = one - uniform(subkey, ())
    boost = torch.where(boost_mask, one, _powf(samples, one / alpha))
    return _flush(d * v_cube * boost)


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


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """A sum over the last axis in XLA's CPU order: left to right from the
    first element; an axis longer than 32 first summed in windows of 32
    (zero-padded evenly at both ends), the window sums then summed so."""
    n = x.shape[-1]
    if n > 32:
        m = -(-n // 32) * 32
        lo = (m - n) // 2
        x = torch.nn.functional.pad(x, (lo, m - n - lo))
        return sum_last(sum_last(x.reshape(x.shape[:-1] + (m // 32, 32))))
    acc = x[..., 0]
    for j in range(1, n):
        acc = acc + x[..., j]
    return acc


def dirichlet(key: torch.Tensor, alpha, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.dirichlet``: ``softmax(loggamma(key, alpha, shape +
    (n,)), -1)``, with JAX's softmax (XLA's exp of x - max, over its sum
    added in XLA's order)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    lg = loggamma(key, alpha, _shape(shape) + tuple(alpha.shape[-1:]))
    e = exp_f32(lg - lg.amax(dim=-1, keepdim=True))
    return _flush(e / sum_last(e).unsqueeze(-1))
