"""Wrappers of the hand-written Hopper kernels of the fused PFELS transmit
(``repro_torch/csrc/pfels_transmit.cu``), which replace the Pallas TPU
kernels ``client_sumsq`` and ``fused_combine`` of
``repro/kernels/pfels_transmit/kernel.py``.

Each wrapper takes the tensor's device as the route: a CPU tensor runs
the plain version (``ref.py``); a CUDA tensor launches the kernel or
raises. It checks device, dtype (f32), shape and contiguity, allocates
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and adds one to its entry in
``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import on_cpu
from repro_torch.kernels.pfels_transmit import ref

SOURCE = "pfels_transmit"
# columns of one client_sumsq block (256 threads x 32 columns)
SUMSQ_CHUNK = 8192

LAUNCHES: Dict[str, int] = {"client_sumsq": 0, "fused_combine": 0}

_P = ctypes.c_void_p


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.pfels_combine_cols_per_block.argtypes = []
        lib.pfels_combine_cols_per_block.restype = ctypes.c_int
        lib.pfels_client_sumsq.argtypes = [_P, _P, _P, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           _P]
        lib.pfels_client_sumsq.restype = ctypes.c_int
        lib.pfels_fused_combine.argtypes = [_P, _P, _P, _P, ctypes.c_int,
                                            _P, _P, _P, _P, _P, ctypes.c_int,
                                            ctypes.c_longlong, _P]
        lib.pfels_fused_combine.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def client_sumsq(u: torch.Tensor) -> torch.Tensor:
    """u: (r, d) f32 -> (r,) per-client sums of squares."""
    if u.ndim != 2:
        raise ValueError(f"u must be (r, d), got {tuple(u.shape)}")
    if on_cpu(u):
        return ref.client_sumsq_ref(u)
    r, d = u.shape
    if r < 1 or d < 1:
        raise ValueError(f"empty update batch {tuple(u.shape)}")
    _check("u", u, (r, d))
    n_chunks = -(-d // SUMSQ_CHUNK)
    partial = torch.empty((r, n_chunks), dtype=torch.float32, device=u.device)
    out = torch.empty((r,), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _lib().pfels_client_sumsq(u.data_ptr(), partial.data_ptr(),
                                        out.data_ptr(), r, d, SUMSQ_CHUNK,
                                        stream)
    _raise_on(err, "client_sumsq")
    LAUNCHES["client_sumsq"] += 1
    return out


def fused_combine(u: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
                  gains_mat: torch.Tensor, tx: torch.Tensor,
                  txm: torch.Tensor):
    """u (r, d), mask and z (d,), gains_mat (r, M), tx and txm (r,), all
    f32 -> (y (d,), energy ()). See ``ref.fused_combine_ref``."""
    if u.ndim != 2 or gains_mat.ndim != 2:
        raise ValueError("u and gains_mat must be 2-D")
    if on_cpu(u, mask, z, gains_mat, tx, txm):
        return ref.fused_combine_ref(u, mask, z, gains_mat, tx, txm)
    r, d = u.shape
    m_ant = gains_mat.shape[1]
    if r < 1 or d < 1 or m_ant < 1:
        raise ValueError(f"empty operand: u {tuple(u.shape)}, gains "
                         f"{tuple(gains_mat.shape)}")
    for name, t, shape in (("u", u, (r, d)), ("mask", mask, (d,)),
                           ("z", z, (d,)), ("gains_mat", gains_mat,
                                            (r, m_ant)),
                           ("tx", tx, (r,)), ("txm", txm, (r,))):
        _check(name, t, shape)
    lib = _lib()
    n_blocks = -(-d // lib.pfels_combine_cols_per_block())
    y = torch.empty((d,), dtype=torch.float32, device=u.device)
    e_partial = torch.empty((n_blocks,), dtype=torch.float32,
                            device=u.device)
    energy = torch.empty((1,), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.pfels_fused_combine(
            u.data_ptr(), mask.data_ptr(), z.data_ptr(), gains_mat.data_ptr(),
            m_ant, tx.data_ptr(), txm.data_ptr(), y.data_ptr(),
            e_partial.data_ptr(), energy.data_ptr(), r, d, stream)
    _raise_on(err, "fused_combine")
    LAUNCHES["fused_combine"] += 1
    return y, energy[0]
