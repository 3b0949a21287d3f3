"""Wrapper of the hand-written Hopper kernels of the global l2-norm clip
(``repro_torch/csrc/clip_norm.cu``), which replace the two Pallas TPU
kernels of ``repro/kernels/clip_norm/kernel.py`` (``clip_norm``: the
sum-of-squares pass, then the scale pass).

The tensor's device is the route: a CPU tensor runs the plain version
(``ref.clip_norm_ref``); a CUDA tensor launches the kernels or raises.
The wrapper checks dtype (f32 or bf16), shape (R, 128) and contiguity,
allocates the output, the per-block partial sums and the norm with
``torch.empty``, launches on the current stream (sum-of-squares
partials, their fixed-order sum, then the scale pass, which reads the
norm from device memory: no host sync), raises if a launch reports an
error, and adds one to ``LAUNCHES["clip_norm"]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import on_cpu
from repro_torch.kernels.clip_norm import ref

SOURCE = "clip_norm"
LANES = 128
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"clip_norm": 0}

_P = ctypes.c_void_p


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.clip_norm_chunk.argtypes = []
        lib.clip_norm_chunk.restype = ctypes.c_int
        lib.clip_norm_launch.argtypes = [ctypes.c_int, _P, _P, _P, _P,
                                         ctypes.c_longlong, ctypes.c_float,
                                         _P]
        lib.clip_norm_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def clip_norm(x_rows: torch.Tensor, clip: float):
    """x_rows: (R, 128) f32 or bf16 -> (x_rows * min(1, C/max(||x||,
    1e-12)) in x_rows' dtype, ||x|| as an f32 0-dim tensor)."""
    if x_rows.ndim != 2 or x_rows.shape[1] != LANES:
        raise ValueError(f"x_rows must be (R, {LANES}), got "
                         f"{tuple(x_rows.shape)}")
    if on_cpu(x_rows):
        return ref.clip_norm_ref(x_rows, clip)
    if x_rows.dtype not in DTYPES:
        raise TypeError(f"x_rows must be float32 or bfloat16, got "
                        f"{x_rows.dtype}")
    if not x_rows.is_contiguous():
        raise ValueError("x_rows must be contiguous")
    n = x_rows.numel()
    if n == 0:
        raise ValueError("x_rows is empty")
    lib = _lib()
    chunk = lib.clip_norm_chunk()
    dev = x_rows.device
    out = torch.empty_like(x_rows)
    partial = torch.empty((-(-n // chunk),), dtype=torch.float32, device=dev)
    nrm = torch.empty((1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.clip_norm_launch(int(x_rows.dtype == torch.bfloat16),
                                   x_rows.data_ptr(), out.data_ptr(),
                                   partial.data_ptr(), nrm.data_ptr(), n,
                                   float(clip), stream)
    if err != 0:
        raise RuntimeError(f"clip_norm: CUDA error {err} at launch")
    LAUNCHES["clip_norm"] += 1
    return out, nrm[0]
