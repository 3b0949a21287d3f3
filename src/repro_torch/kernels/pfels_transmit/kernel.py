"""Wrappers of the hand-written Hopper kernels of the fused PFELS transmit
(``repro_torch/csrc/pfels_transmit.cu``), which replace the Pallas TPU
kernels ``client_sumsq`` and ``fused_combine`` of
``repro/kernels/pfels_transmit/kernel.py``.

Each wrapper takes the tensor's device as the route: a CPU tensor runs
the plain version (``ref.py``); a CUDA tensor launches the kernel or
raises; a ``meta`` tensor gets the kernel's outputs as meta tensors and
charges the active ``launch.op_cost`` counter with the kernel's work
(``sumsq_work``, ``combine_work``; the CUDA launch charges it too). It
checks device, dtype (f32), shape and contiguity, allocates the outputs
and the partial sums (``client_sumsq``: one ``torch.empty``;
``fused_combine``: y, and the energy with the partials in a small buffer
of their own, so that an energy a caller keeps, as ``Trainer.run`` keeps
every round's metrics, does not hold y's storage), makes one launch on
the tensor's device and its current stream, raises if the launch reports
an error, and adds one to its entry in ``LAUNCHES``. The library's tile
widths and grids are asked once for each device; the launches' two
counters (see the ``.cu`` header) are made once for each device and
stream. The CUDA route is kept short on the host, since at one client a
rank the kernels run for tens of microseconds.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import current_stream, route
from repro_torch.kernels.pfels_transmit import ref
from repro_torch.launch import op_cost

SOURCE = "pfels_transmit"

LAUNCHES: Dict[str, int] = {"client_sumsq": 0, "fused_combine": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB: Optional[ctypes.CDLL] = None
# (sumsq tile columns, sumsq grid, combine tile columns, combine grid)
# by device index
_GEOMETRY: Dict[int, Tuple[int, int, int, int]] = {}
# the two counters of the launches on a (device index, stream)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sumsq_work(r: int, d: int):
    """(bytes, FLOPs) of ``client_sumsq`` on (r, d) f32: u read once,
    the r sums written; a square and an add an element."""
    return (r * d + r) * 4, 2.0 * r * d


def combine_work(r: int, d: int, m_ant: int):
    """(bytes, FLOPs) of ``fused_combine``: u, mask, z and the gains,
    tx and txm read once, y and the energy written; per element of u a
    mask, a scale, an add into y, and a square, a scale and an add into
    the energy."""
    return (r * d + 3 * d + r * m_ant + 2 * r + 1) * 4, 6.0 * r * d


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        for name in ("pfels_sumsq_tile_cols", "pfels_combine_tile_cols"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.pfels_resident_blocks.argtypes = [_I, _I]
        lib.pfels_resident_blocks.restype = _I
        lib.pfels_client_sumsq.argtypes = [_I, _P, _P, _P, _P, _I, _L, _I,
                                           _I, _P]
        lib.pfels_client_sumsq.restype = _I
        lib.pfels_fused_combine.argtypes = [_I, _P, _P, _P, _P, _I, _P, _P,
                                            _P, _P, _P, _P, _I, _L, _I, _P]
        lib.pfels_fused_combine.restype = _I
        _LIB = lib
    return _LIB


def _geometry(dev: int):
    geo = _GEOMETRY.get(dev)
    if geo is None:
        lib = _lib()
        geo = (lib.pfels_sumsq_tile_cols(), lib.pfels_resident_blocks(dev, 0),
               lib.pfels_combine_tile_cols(),
               lib.pfels_resident_blocks(dev, 1))
        if min(geo) < 1:
            raise RuntimeError(f"pfels_transmit: no resident blocks on "
                               f"device {dev}")
        _GEOMETRY[dev] = geo
    return geo


def _ticket(dev: int, stream: int) -> int:
    t = _TICKETS.get((dev, stream))
    if t is None:
        t = _TICKETS[(dev, stream)] = torch.zeros(
            (2,), dtype=torch.int32, device=torch.device("cuda", dev))
    return t.data_ptr()


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype is torch.float32 and t.shape == shape and t.is_contiguous():
        return
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def _on_one_card(tensors) -> bool:
    """All on one CUDA device (else ``route`` sorts them out)."""
    dev = tensors[0].get_device()
    return all(t.is_cuda and t.get_device() == dev for t in tensors)


def client_sumsq(u: torch.Tensor) -> torch.Tensor:
    """u: (r, d) f32 -> (r,) per-client sums of squares."""
    if u.ndim != 2:
        raise ValueError(f"u must be (r, d), got {tuple(u.shape)}")
    where = route(u) if u.device.type != "cuda" else "cuda"
    if where == "cpu":
        return ref.client_sumsq_ref(u)
    r, d = u.shape
    if r < 1 or d < 1:
        raise ValueError(f"empty update batch {tuple(u.shape)}")
    _check("u", u, (r, d))
    if where == "meta":
        op_cost.charge_kernel("client_sumsq", *sumsq_work(r, d))
        return u.new_empty((r,))
    dev = u.get_device()
    tile, most = _geometry(dev)[:2]
    n_tiles = -(-d // tile)
    stride = -(-n_tiles // 4) * 4
    head = -(-r // 4) * 4
    # out (r,), then the (r, stride) tile partials, 16-byte aligned
    buf = u.new_empty((head + r * stride,))
    stream = current_stream(dev)
    ptr = buf.data_ptr()
    _raise_on(_LIB.pfels_client_sumsq(
        dev, u.data_ptr(), ptr, ptr + 4 * head, _ticket(dev, stream), r, d,
        stride, min(most, r * n_tiles), stream), "client_sumsq")
    LAUNCHES["client_sumsq"] += 1
    op_cost.charge_kernel("client_sumsq", *sumsq_work(r, d))
    return buf[:r]


def fused_combine(u: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
                  gains_mat: torch.Tensor, tx: torch.Tensor,
                  txm: torch.Tensor):
    """u (r, d), mask and z (d,), gains_mat (r, M), tx and txm (r,), all
    f32 -> (y (d,), energy ()). See ``ref.fused_combine_ref``."""
    if u.ndim != 2 or gains_mat.ndim != 2:
        raise ValueError("u and gains_mat must be 2-D")
    args = (u, mask, z, gains_mat, tx, txm)
    where = "cuda" if _on_one_card(args) else route(*args)
    if where == "cpu":
        return ref.fused_combine_ref(*args)
    r, d = u.shape
    m_ant = gains_mat.shape[1]
    if r < 1 or d < 1 or m_ant < 1:
        raise ValueError(f"empty operand: u {tuple(u.shape)}, gains "
                         f"{tuple(gains_mat.shape)}")
    for name, t, shape in zip(("u", "mask", "z", "gains_mat", "tx", "txm"),
                              args, ((r, d), (d,), (d,), (r, m_ant), (r,),
                                     (r,))):
        _check(name, t, shape)
    if where == "meta":
        op_cost.charge_kernel("fused_combine", *combine_work(r, d, m_ant))
        return u.new_empty((d,)), u.new_empty(())
    dev = u.get_device()
    tile, most = _geometry(dev)[2:]
    grid = min(most, -(-d // tile))
    y = u.new_empty((d,))
    # the energy, then the grid's energy partials 16 bytes on
    small = u.new_empty((4 + grid,))
    stream = current_stream(dev)
    ptr = small.data_ptr()
    _raise_on(_LIB.pfels_fused_combine(
        dev, u.data_ptr(), mask.data_ptr(), z.data_ptr(),
        gains_mat.data_ptr(), m_ant, tx.data_ptr(), txm.data_ptr(),
        y.data_ptr(), ptr, ptr + 16, _ticket(dev, stream), r, d, grid,
        stream), "fused_combine")
    LAUNCHES["fused_combine"] += 1
    op_cost.charge_kernel("fused_combine", *combine_work(r, d, m_ant))
    return y, small[0]
