"""Wrapper of the hand-written Hopper kernel of the AirComp server combine
(``repro_torch/csrc/aircomp_combine.cu``), which replaces the Pallas TPU
kernel ``aircomp_combine`` of ``repro/kernels/aircomp_combine/kernel.py``.

The TPU kernel aliases theta from input to output; this wrapper updates
``theta_rows`` in place, on either route, and returns it. The tensor's
device is the route: a CPU tensor runs the plain update
(``ref.add_rows_``); a CUDA tensor launches the kernel or raises; a
``meta`` tensor is returned as it is, and the active ``launch.op_cost``
counter is charged with ``work`` (the CUDA launch charges it too). The
wrapper checks dtypes (theta and y f32 or bf16 alike, indices int32),
shapes and contiguity. 1/(r beta) reaches the kernel cast to y's dtype,
as the TPU kernel casts it (``_route.scalar_arg``): a number is rounded
on the host and passed by value; a tensor is passed by pointer,
converted first only if its dtype or device differs. One launch on the
current stream (the device switched only when theta's is not the
current one); it raises if the launch reports an error, and adds one to
``LAUNCHES["aircomp_combine"]``.

Duplicate rows accumulate on both routes. The kernel adds each element
with an atomic reduction: with unique rows (what
``row_indices_from_coords`` draws) its result is bit-equal to the plain
version and the same from run to run; with duplicates the adds to one
element round in an order that varies, so it matches the plain version
within about one rounding of the element per extra add
(``csrc/aircomp_combine.cu``). Indices must lie in [0, R): the kernel
drops a row outside, the plain version raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import current_stream, route, scalar_arg
from repro_torch.kernels.aircomp_combine import ref
from repro_torch.launch import op_cost

SOURCE = "aircomp_combine"
LANES = 128
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"aircomp_combine": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def work(k_rows: int, elem: int):
    """(bytes, FLOPs) of one combine of k_rows rows of 128 lanes of
    ``elem`` bytes: the theta rows read and written and the y rows read
    once, the int32 indices and the scale read; a multiply-add an
    element."""
    return (3 * k_rows * LANES * elem + 4 * k_rows + elem,
            2.0 * k_rows * LANES)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.aircomp_combine_launch.argtypes = [ctypes.c_int, _P, _P, _P, _P,
                                               ctypes.c_float, _LL, _LL, _P]
        lib.aircomp_combine_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_shapes(theta_rows: torch.Tensor, y_rows: torch.Tensor,
                 idx_rows: torch.Tensor) -> None:
    if theta_rows.ndim != 2 or theta_rows.shape[1] != LANES:
        raise ValueError(f"theta_rows must be (R, {LANES}), got "
                         f"{tuple(theta_rows.shape)}")
    if idx_rows.ndim != 1 or tuple(y_rows.shape) != (idx_rows.shape[0],
                                                     LANES):
        raise ValueError(f"y_rows must be (k_rows, {LANES}) and idx_rows "
                         f"(k_rows,), got {tuple(y_rows.shape)} and "
                         f"{tuple(idx_rows.shape)}")


def aircomp_combine(theta_rows: torch.Tensor, y_rows: torch.Tensor,
                    idx_rows: torch.Tensor, inv_rbeta) -> torch.Tensor:
    """theta_rows: (R, 128), updated in place; y_rows: (k_rows, 128) of
    theta's dtype; idx_rows: (k_rows,) int32; inv_rbeta: 1/(r beta), a
    number or a one-element tensor. Returns theta_rows."""
    check_shapes(theta_rows, y_rows, idx_rows)
    where = route(theta_rows, y_rows, idx_rows)
    if where == "cpu":
        return ref.add_rows_(theta_rows, y_rows, idx_rows, inv_rbeta)
    if theta_rows.dtype not in DTYPES or y_rows.dtype != theta_rows.dtype:
        raise TypeError(f"theta_rows and y_rows must share a dtype of "
                        f"float32 or bfloat16, got {theta_rows.dtype} and "
                        f"{y_rows.dtype}")
    if idx_rows.dtype != torch.int32:
        raise TypeError(f"idx_rows must be int32, got {idx_rows.dtype}")
    if not (theta_rows.is_contiguous() and y_rows.is_contiguous()
            and idx_rows.is_contiguous()):
        raise ValueError("theta_rows, y_rows and idx_rows must be "
                         "contiguous")
    rows, k_rows = theta_rows.shape[0], idx_rows.shape[0]
    if rows < 1 or k_rows < 1:
        raise ValueError(f"empty operand: theta_rows "
                         f"{tuple(theta_rows.shape)}, k_rows {k_rows}")
    n_work = work(k_rows, theta_rows.element_size())
    if where == "meta":
        op_cost.charge_kernel("aircomp_combine", *n_work)
        return theta_rows
    inv, _, inv_val = scalar_arg(inv_rbeta, y_rows, "inv_rbeta")
    if theta_rows.get_device() == torch.cuda.current_device():
        err = _launch(theta_rows, y_rows, idx_rows, inv, inv_val)
    else:
        with torch.cuda.device(theta_rows.device):
            err = _launch(theta_rows, y_rows, idx_rows, inv, inv_val)
    if err != 0:
        raise RuntimeError(f"aircomp_combine: CUDA error {err} at launch")
    LAUNCHES["aircomp_combine"] += 1
    op_cost.charge_kernel("aircomp_combine", *n_work)
    return theta_rows


def _launch(theta_rows, y_rows, idx_rows, inv, inv_val) -> int:
    return _lib().aircomp_combine_launch(
        int(theta_rows.dtype == torch.bfloat16), theta_rows.data_ptr(),
        y_rows.data_ptr(), idx_rows.data_ptr(),
        None if inv is None else inv.data_ptr(), inv_val,
        theta_rows.shape[0], idx_rows.shape[0],
        current_stream(theta_rows.get_device()))
