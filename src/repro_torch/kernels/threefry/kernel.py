"""Wrappers of the hand-written Hopper kernels of JAX's threefry-2x32
draws (``repro_torch/csrc/threefry.cu``). They replace no Pallas kernel:
they replace the JAX package's ``jax.random`` draws, which XLA fuses on
the TPU and ``repro_torch.prng`` computes one element-wise op at a time.

``sample`` draws ``prng.uniform`` (f32, [0, 1)), ``prng.bernoulli`` and
``prng.normal`` (f32) in one launch; ``combine`` is one leaf of the
single-client PFELS production aggregate with its channel noise drawn in
registers. Both give ``ref.py``'s bits (``prng``'s own code).

The tensors' device is the route: CPU tensors run the plain version
(``ref.py``); CUDA tensors launch the kernel or raise; ``meta`` tensors
get the kernel's outputs as meta tensors and charge the active
``launch.op_cost`` counter with the kernel's bytes (the CUDA launch
charges them too). The wrapper checks dtypes, shapes and contiguity,
allocates the output, makes one launch on the tensors' device and its
current stream, raises if the launch reports an error, and adds one to
its entry in ``LAUNCHES``. The key words, beta and the scale stay on the
card: the kernels read them through pointers.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import (_f32, current_stream, host_scalar,
                                        route)
from repro_torch.kernels.threefry import ref
from repro_torch.launch import op_cost

SOURCE = "threefry"
KINDS = ("uniform", "bernoulli", "normal")
# counts are uint32: a draw of 2^32 values or more has no JAX layout
MAX_N = (1 << 32) - 1

LAUNCHES: Dict[str, int] = {"threefry_sample": 0, "threefry_combine": 0}

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_LIB: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sample_work(rows: int, n: int, kind: str):
    """(bytes, FLOPs) of one ``sample``: the keys read, the values written
    (4 bytes, 1 for bernoulli's bools). The hash is integer work and the
    normal's steps are element-wise, which ``op_cost`` counts as no
    FLOPs."""
    return rows * 16 + rows * n * (1 if kind == "bernoulli" else 4), 0.0


def combine_work(n: int):
    """(bytes, FLOPs) of one ``combine``: x (f32) and the mask (bool) read
    and out written once, the key, beta and the scale read."""
    return 9 * n + 24, 0.0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        lib.threefry_sample.argtypes = [ctypes.c_int, ctypes.c_int, _P, _L,
                                        _L, _L, ctypes.c_float, _P, _P]
        lib.threefry_sample.restype = ctypes.c_int
        lib.threefry_combine.argtypes = [ctypes.c_int, _P, _P, _P, _P, _P,
                                         ctypes.c_float, _P, _L, _P]
        lib.threefry_combine.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def _check_n(n: int) -> int:
    n = int(n)
    if not 0 <= n <= MAX_N:
        raise ValueError(f"a threefry draw takes 0 to 2^32 - 1 values, "
                         f"got {n}")
    return n


def _check_key(key: torch.Tensor, batch_ok: bool) -> None:
    if key.dtype != torch.int64 or key.ndim not in ((1, 2) if batch_ok
                                                    else (1,)) \
            or key.shape[-1] != 2:
        raise ValueError(f"expected a key (int64, shape (2,))"
                         f"{' or a batch of keys (M, 2)' if batch_ok else ''}"
                         f", got {key.dtype} {tuple(key.shape)}")
    if key.stride(-1) != 1:
        raise ValueError("a key's two words must be adjacent in memory")


def _scalar_operand(name: str, t) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
            or t.numel() != 1:
        raise TypeError(f"{name} must be a one-element float32 tensor")


def sample(key: torch.Tensor, n: int, kind: str, p=None) -> torch.Tensor:
    """n values of ``kind`` ("uniform", "bernoulli" with threshold ``p``,
    or "normal") from ``key`` (2,), or from each key of a batch (M, 2):
    (n,) or (M, n), f32 (bool for bernoulli)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "bernoulli" and p is None:
        raise ValueError("bernoulli needs its probability p")
    n = _check_n(n)
    where = route(key)
    if where == "cpu":
        return ref.sample_ref(key, n, kind, p)
    _check_key(key, batch_ok=True)
    lead = tuple(key.shape[:-1])
    rows = math.prod(lead)
    out = torch.empty(lead + (n,), device=key.device, dtype=(
        torch.bool if kind == "bernoulli" else torch.float32))
    if where == "meta":
        op_cost.charge_kernel("threefry_sample", *sample_work(rows, n, kind))
        return out
    if rows == 0 or n == 0:
        return out
    dev = key.get_device()
    thr = _f32(p) if kind == "bernoulli" else 0.0
    _raise_on(_lib().threefry_sample(
        dev, KINDS.index(kind), key.data_ptr(),
        key.stride(0) if key.ndim == 2 else 0, rows, n, thr, out.data_ptr(),
        current_stream(dev)), "threefry_sample")
    LAUNCHES["threefry_sample"] += 1
    op_cost.charge_kernel("threefry_sample", *sample_work(rows, n, kind))
    return out


def combine(x: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
            beta: torch.Tensor, sigma0: float, scale: torch.Tensor
            ) -> torch.Tensor:
    """``fma_f32(x * mf, beta, (sigma0 * mf) * z) * scale`` with z =
    ``prng.normal(key, x.shape)`` drawn in registers: x f32, mask bool of
    x's shape, key (2,), beta and scale one-element f32 tensors, sigma0 a
    number (rounded to f32). Returns x's shape, f32."""
    n = _check_n(x.numel())
    where = route(x, mask, key, beta, scale)
    if where == "cpu":
        return ref.combine_ref(x, mask, key, beta, sigma0, scale)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.shape != x.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("x and mask must be contiguous")
    _check_key(key, batch_ok=False)
    _scalar_operand("beta", beta)
    _scalar_operand("scale", scale)
    if isinstance(sigma0, torch.Tensor):
        raise TypeError("sigma0 must be a number")
    out = torch.empty_like(x)
    if where == "meta":
        op_cost.charge_kernel("threefry_combine", *combine_work(n))
        return out
    if n == 0:
        return out
    dev = x.get_device()
    _raise_on(_lib().threefry_combine(
        dev, x.data_ptr(), mask.data_ptr(), key.data_ptr(), beta.data_ptr(),
        scale.data_ptr(), host_scalar(sigma0, torch.float32),
        out.data_ptr(), n, current_stream(dev)), "threefry_combine")
    LAUNCHES["threefry_combine"] += 1
    op_cost.charge_kernel("threefry_combine", *combine_work(n))
    return out
