"""Wrapper of the hand-written Hopper kernel of the rand-k row gather with
the power scale (``repro_torch/csrc/randk_gather.cu``), which replaces the
Pallas TPU kernel ``randk_gather`` of
``repro/kernels/randk_gather/kernel.py``.

The tensor's device is the route: a CPU tensor runs the plain version
(``ref.randk_gather_ref``); a CUDA tensor launches the kernel or raises;
a ``meta`` tensor gets the kernel's output as a meta tensor and charges
the active ``launch.op_cost`` counter with ``work`` (the CUDA launch
charges it too). The wrapper checks dtypes (delta f32 or bf16, indices int32), shapes and
contiguity. The scale reaches the kernel cast to delta's dtype, as the
TPU kernel casts it (``_route.scalar_arg``): a number is rounded on the
host and passed by value; a tensor of delta's dtype or of f32 on delta's
device is passed by pointer (the kernel rounds an f32 scale to delta's
dtype, as the cast would), any other is converted first. So a call with
a number or an f32 tensor is one device kernel. The wrapper allocates the output with ``torch.empty`` and makes
one launch on the current stream (the device switched only when delta's
is not the current one); it raises if the launch reports an error, and
adds one to ``LAUNCHES["randk_gather"]``. Indices must lie in [0, R):
the kernel writes NaN for a row outside, the plain version raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import current_stream, route, scalar_arg
from repro_torch.kernels.randk_gather import ref
from repro_torch.launch import op_cost

SOURCE = "randk_gather"
LANES = 128
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"randk_gather": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def work(k_rows: int, elem: int):
    """(bytes, FLOPs) of one gather of k_rows rows of 128 lanes of
    ``elem`` bytes: the rows read and written once, the int32 indices and
    the scale read; a scale an element."""
    return 2 * k_rows * LANES * elem + 4 * k_rows + elem, 1.0 * k_rows * LANES


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.randk_gather_launch.argtypes = [ctypes.c_int, _P, _P, _P,
                                            ctypes.c_int, ctypes.c_float, _P,
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
    where = route(delta_rows, idx_rows)
    if where == "cpu":
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
    n_work = work(k_rows, delta_rows.element_size())
    if where == "meta":
        op_cost.charge_kernel("randk_gather", *n_work)
        return delta_rows.new_empty((k_rows, LANES))
    s, s_f32, s_val = scalar_arg(scale, delta_rows, "scale", f32_ok=True)
    out = torch.empty((k_rows, LANES), dtype=delta_rows.dtype,
                      device=delta_rows.device)
    if delta_rows.get_device() == torch.cuda.current_device():
        err = _launch(delta_rows, idx_rows, s, s_f32, s_val, out)
    else:
        with torch.cuda.device(delta_rows.device):
            err = _launch(delta_rows, idx_rows, s, s_f32, s_val, out)
    if err != 0:
        raise RuntimeError(f"randk_gather: CUDA error {err} at launch")
    LAUNCHES["randk_gather"] += 1
    op_cost.charge_kernel("randk_gather", *n_work)
    return out


def _launch(delta_rows, idx_rows, s, s_f32, s_val, out) -> int:
    return _lib().randk_gather_launch(
        int(delta_rows.dtype == torch.bfloat16), delta_rows.data_ptr(),
        idx_rows.data_ptr(), None if s is None else s.data_ptr(), s_f32,
        s_val, out.data_ptr(),
        delta_rows.shape[0], idx_rows.shape[0],
        current_stream(delta_rows.get_device()))
