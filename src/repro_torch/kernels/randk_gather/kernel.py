"""Wrapper of the hand-written Hopper kernel of the rand-k row gather with
the power scale (``repro_torch/csrc/randk_gather.cu``), which replaces the
Pallas TPU kernel ``randk_gather`` of
``repro/kernels/randk_gather/kernel.py``.

The tensor's device is the route: a CPU tensor runs the plain version
(``ref.randk_gather_ref``); a CUDA tensor launches the kernel or raises.
The wrapper checks dtypes (delta f32 or bf16, indices int32), shapes and
contiguity, casts the scale to delta's dtype on the device, allocates the
output with ``torch.empty``, launches on the current stream, raises if
the launch reports an error, and adds one to ``LAUNCHES["randk_gather"]``.
Indices must lie in [0, R): the kernel writes NaN for a row outside, the
plain version raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import on_cpu, scalar_like
from repro_torch.kernels.randk_gather import ref

SOURCE = "randk_gather"
LANES = 128
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"randk_gather": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.randk_gather_launch.argtypes = [ctypes.c_int, _P, _P, _P, _P,
                                            _LL, _LL, _P]
        lib.randk_gather_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_shapes(delta_rows: torch.Tensor, idx_rows: torch.Tensor) -> None:
    if delta_rows.ndim != 2 or delta_rows.shape[1] != LANES:
        raise ValueError(f"delta_rows must be (R, {LANES}), got "
                         f"{tuple(delta_rows.shape)}")
    if idx_rows.ndim != 1:
        raise ValueError(f"idx_rows must be (k_rows,), got "
                         f"{tuple(idx_rows.shape)}")


def randk_gather(delta_rows: torch.Tensor, idx_rows: torch.Tensor,
                 scale) -> torch.Tensor:
    """delta_rows: (R, 128) f32 or bf16; idx_rows: (k_rows,) int32;
    scale: a number or a one-element tensor. Returns (k_rows, 128)
    ``delta_rows[idx_rows] * scale`` in delta's dtype."""
    check_shapes(delta_rows, idx_rows)
    if on_cpu(delta_rows, idx_rows):
        return ref.randk_gather_ref(delta_rows, idx_rows, scale)
    if delta_rows.dtype not in DTYPES:
        raise TypeError(f"delta_rows must be float32 or bfloat16, got "
                        f"{delta_rows.dtype}")
    if idx_rows.dtype != torch.int32:
        raise TypeError(f"idx_rows must be int32, got {idx_rows.dtype}")
    if not (delta_rows.is_contiguous() and idx_rows.is_contiguous()):
        raise ValueError("delta_rows and idx_rows must be contiguous")
    rows, k_rows = delta_rows.shape[0], idx_rows.shape[0]
    if rows < 1 or k_rows < 1:
        raise ValueError(f"empty operand: delta_rows "
                         f"{tuple(delta_rows.shape)}, k_rows {k_rows}")
    s = scalar_like(scale, delta_rows)
    out = torch.empty((k_rows, LANES), dtype=delta_rows.dtype,
                      device=delta_rows.device)
    with torch.cuda.device(delta_rows.device):
        stream = torch.cuda.current_stream(delta_rows.device).cuda_stream
        err = _lib().randk_gather_launch(
            int(delta_rows.dtype == torch.bfloat16), delta_rows.data_ptr(),
            idx_rows.data_ptr(), s.data_ptr(), out.data_ptr(), rows, k_rows,
            stream)
    if err != 0:
        raise RuntimeError(f"randk_gather: CUDA error {err} at launch")
    LAUNCHES["randk_gather"] += 1
    return out
