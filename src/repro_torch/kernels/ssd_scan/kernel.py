"""Wrapper of the hand-written Hopper kernels of the Mamba2 SSD chunk scan
(``repro_torch/csrc/ssd_scan.cu``), which replace the Pallas TPU kernel
``ssd_scan`` of ``repro/kernels/ssd_scan/kernel.py``.

The tensor's device is the route: a CPU tensor runs the plain version
(``ref.ssd_chunked``); a CUDA tensor launches a kernel or raises; a
``meta`` tensor gets the kernel's outputs as meta tensors and charges the
active ``launch.op_cost`` counter with ``work`` (the CUDA launch charges
it too). The dtype of x, B and C picks the kernel: bf16 (what serving
runs) the tensor-core one, whose rounding ``ref.split_bf16_route``
emulates; f32 the CUDA-core one. The wrapper checks device, dtypes, shapes and strides,
refuses a chunk that does not divide the sequence or does not fit the
block's shared memory (the TPU kernel falls back to one chunk of the whole
sequence; this one does not), allocates the outputs with ``torch.empty``,
launches on the current stream (switching the device only when the
tensor's is not current), raises if the launch reports an error, and adds
one to ``LAUNCHES["ssd_scan"]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Set, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import current_stream, route
from repro_torch.kernels.ssd_scan import ref
from repro_torch.launch import op_cost

SOURCE = "ssd_scan"
DIMS = (32, 64, 128)            # the P and N the kernel is built for
MAX_CHUNK = 128

LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
# (device index, bf16, chunk, P, N) that fit a block's shared memory
_FITS: Set[Tuple[int, int, int, int, int]] = set()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def work(b, s, h, p, n, chunk, elem):
    """(bytes, FLOPs) of one scan: each input read once (x, B and C in
    ``elem`` bytes, dt and A in f32), y and the final state written once
    (f32); C B^T once a chunk (its causal half), and for each head the
    intra-chunk product (causal half), the carried-in term and the state
    update."""
    n_bytes = (b * s * h * p * elem + b * s * h * 4 + h * 4
               + 2 * b * s * n * elem + b * s * h * p * 4 + b * h * p * n * 4)
    nc = s // chunk
    tri = chunk * (chunk + 1) / 2
    flops = b * nc * (2 * tri * n + h * (2 * tri * p + 4 * chunk * p * n))
    return n_bytes, flops


def _work_of(x, b, chunk):
    bsz, s, h, p = x.shape
    return work(bsz, s, h, p, b.shape[-1], chunk, x.element_size())


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_smem_bytes.argtypes = [_I, _I, _I, _I]
        lib.ssd_scan_smem_bytes.restype = _LL
        lib.ssd_scan_stages.argtypes = [_I, _I, _I]
        lib.ssd_scan_stages.restype = _I
        lib.ssd_scan_max_smem.argtypes = []
        lib.ssd_scan_max_smem.restype = _I
        lib.ssd_scan_launch.argtypes = ([_I, _P, _P, _P, _P, _P, _P, _P]
                                        + [_I] * 6 + [_LL] * 7 + [_P])
        lib.ssd_scan_launch.restype = _I
        lib._typed = True
    return lib


def check_shapes(x, dt, a, b, c, chunk: int) -> None:
    """The contract both routes hold: shapes, a chunk that divides S."""
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 3 \
            or c.ndim != 3:
        raise ValueError("expected x (B,S,H,P), dt (B,S,H), a (H,), "
                         "b and c (B,S,N)")
    bsz, s, h, _ = x.shape
    n = b.shape[-1]
    for name, t, shape in (("dt", dt, (bsz, s, h)), ("a", a, (h,)),
                           ("b", b, (bsz, s, n)), ("c", c, (bsz, s, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if chunk < 1 or s % chunk != 0:
        raise ValueError(f"chunk {chunk} does not divide the sequence {s}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128):
    """x (B,S,H,P), dt (B,S,H) f32, a (H,) f32 (negative decay rates),
    b and c (B,S,N) -> (y (B,S,H,P) f32, final state (B,H,P,N) f32), from
    a zero initial state."""
    check_shapes(x, dt, a, b, c, chunk)
    where = route(x, dt, a, b, c)
    if where == "cpu":
        return ref.ssd_chunked(x, dt, a, b, c, chunk)
    p, n = x.shape[-1], b.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share a dtype of float32 or "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("dt and a must be float32")
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"the kernel takes P and N in {DIMS}, got P={p}, "
                         f"N={n}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks up to {MAX_CHUNK}, got "
                         f"{chunk}")
    if x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("x, b and c must have a unit innermost stride")
    if not (dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("dt and a must be contiguous")
    if where == "meta":
        op_cost.charge_kernel("ssd_scan", *_work_of(x, b, chunk))
        bsz, s, h, _ = x.shape
        return (x.new_empty((bsz, s, h, p), dtype=torch.float32),
                x.new_empty((bsz, h, p, n), dtype=torch.float32))
    lib = _lib()
    if x.get_device() == torch.cuda.current_device():
        return _launch(lib, x, dt, a, b, c, chunk)
    with torch.cuda.device(x.device):
        return _launch(lib, x, dt, a, b, c, chunk)


def _launch(lib, x, dt, a, b, c, chunk):
    """The checked launch on x's device, which is the current one."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    dev = x.get_device()
    bf16 = int(x.dtype == torch.bfloat16)
    if (dev, bf16, chunk, p, n) not in _FITS:
        need = lib.ssd_scan_smem_bytes(bf16, chunk, p, n)
        have = lib.ssd_scan_max_smem()
        if need > have:
            raise ValueError(f"chunk {chunk} at P={p}, N={n} needs {need} "
                             f"bytes of shared memory; a block has {have}")
        _FITS.add((dev, bf16, chunk, p, n))
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_launch(
        bf16, x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s, h, p, n, chunk,
        x.stride(0), x.stride(1), x.stride(2), b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA error {err} at launch")
    LAUNCHES["ssd_scan"] += 1
    op_cost.charge_kernel("ssd_scan", *_work_of(x, b, chunk))
    return y, state


def shared_memory(chunk: int, p: int, n: int, dtype=torch.bfloat16) -> dict:
    """The shared memory a block of the ``dtype`` route takes for
    ``chunk`` on the current device (the bf16 route's ring as deep as the
    device allows), and that ring's depth."""
    lib = _lib()
    bf16 = int(dtype == torch.bfloat16)
    return {"bytes": lib.ssd_scan_smem_bytes(bf16, chunk, p, n),
            "stages": lib.ssd_scan_stages(chunk, p, n) if bf16 else None}
