"""Wrapper of the hand-written Hopper kernel of the global l2-norm clip
(``repro_torch/csrc/clip_norm.cu``), which replaces the two Pallas TPU
kernels of ``repro/kernels/clip_norm/kernel.py`` (``clip_norm``: the
sum-of-squares pass, then the scale pass).

The tensor's device is the route: a CPU tensor runs the plain version
(``ref.clip_norm_ref``); a CUDA tensor launches the kernel or raises.
The wrapper checks dtype (f32 or bf16), shape (R, 128) and contiguity,
allocates the output and one scratch tensor (the norm, then one partial
sum for each block of the resident grid), makes one cooperative launch on
the current stream (switching the device only when the tensor's is not
the current one), raises if the launch reports an error, and adds one to
``LAUNCHES["clip_norm"]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import current_stream, on_cpu
from repro_torch.kernels.clip_norm import ref

SOURCE = "clip_norm"
LANES = 128
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"clip_norm": 0}

_P = ctypes.c_void_p
# floats of scratch a launch needs, by device index
_SCRATCH_LEN: Dict[int, int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.clip_norm_scratch_len.argtypes = []
        lib.clip_norm_scratch_len.restype = ctypes.c_int
        lib.clip_norm_launch.argtypes = [ctypes.c_int, _P, _P, _P,
                                         ctypes.c_longlong, ctypes.c_float,
                                         _P]
        lib.clip_norm_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(lib, x_rows: torch.Tensor, clip: float):
    dev = x_rows.get_device()
    n_scratch = _SCRATCH_LEN.get(dev)
    if n_scratch is None:
        n_scratch = _SCRATCH_LEN[dev] = lib.clip_norm_scratch_len()
        if n_scratch < 2:
            raise RuntimeError(f"clip_norm: no resident blocks on {dev}")
    out = torch.empty_like(x_rows)
    scratch = x_rows.new_empty((n_scratch,), dtype=torch.float32)
    err = lib.clip_norm_launch(int(x_rows.dtype == torch.bfloat16),
                               x_rows.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), x_rows.numel(),
                               float(clip), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"clip_norm: CUDA error {err} at launch")
    LAUNCHES["clip_norm"] += 1
    return out, scratch[0]


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
    if x_rows.numel() == 0:
        raise ValueError("x_rows is empty")
    lib = _lib()
    if x_rows.get_device() == torch.cuda.current_device():
        return _launch(lib, x_rows, clip)
    with torch.cuda.device(x_rows.device):
        return _launch(lib, x_rows, clip)
