"""Wrapper of the hand-written Hopper kernel of the flash-attention forward
(``repro_torch/csrc/flash_attn.cu``), which replaces the Pallas TPU kernel
``flash_attention_fwd`` of ``repro/kernels/flash_attn/kernel.py``.

The tensor's device is the route: a CPU tensor runs the plain version
(``ref.attention_ref``); a CUDA tensor launches the kernel or raises; a
``meta`` tensor gets the kernel's output as a meta tensor and charges the
active ``launch.op_cost`` counter with ``work`` (the CUDA launch charges
it too). The dtype picks the kernel's design: bf16 runs on the tensor
cores (wgmma, TMA loads; P is rounded to bf16 before P V), f32 on the
CUDA cores. The wrapper checks device, dtypes, shapes, contiguity and
(bf16: TMA) 16-byte alignment, allocates the output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and adds one to ``LAUNCHES["flash_attention_fwd"]``.

Both routes refuse the inputs on which the TPU kernel and its oracle part
ways: a query row with no key to attend to (causal with Sq > Skv, or a
window below 1), where the kernel's online softmax averages every value
and the oracle returns NaN.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._route import route
from repro_torch.kernels.flash_attn import ref
from repro_torch.launch import op_cost

SOURCE = "flash_attn"
HEAD_DIMS = (64, 80, 96, 128, 160)   # the Dh the kernel is built for

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def work(b, sq, skv, h, hkv, dh, window, elem, causal=True):
    """(bytes, FLOPs) of one call: q, k and v read once, the output
    written once; a multiply-add over Dh for the scores and one for the
    values for each (query, key) pair the mask keeps (every pair with
    ``causal=False`` and no window). Query row i sits at position
    i + Skv - Sq."""
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = pos + 1 if causal else np.full_like(pos, skv)
    lo = (np.zeros_like(pos) if window is None
          else np.maximum(0, pos - window + 1))
    pairs = int(np.maximum(0, hi - lo).sum())
    n_bytes = (2 * b * sq * h * dh + 2 * b * skv * hkv * dh) * elem
    return n_bytes, 4.0 * b * h * dh * pairs


def _work_of(q, k, causal, window):
    b, sq, h, dh = q.shape
    return work(b, sq, k.shape[1], h, k.shape[2], dh, window,
                q.element_size(), causal)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.flash_attn_fwd_launch.argtypes = ([_I, _P, _P, _P, _P]
                                              + [_I] * 6
                                              + [ctypes.c_float, _I, _I, _P])
        lib.flash_attn_fwd_launch.restype = _I
        lib._typed = True
    return lib


def check_shapes(q, k, v, causal: bool, window: Optional[int]) -> None:
    """The contract both routes hold."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected q (B,Sq,H,Dh), k and v (B,Skv,Hkv,Dh)")
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, skv, hkv, dh) or tuple(v.shape) != tuple(
            k.shape):
        raise ValueError(f"k and v must be (B, Skv, Hkv, Dh) = "
                         f"({b}, Skv, Hkv, {dh}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if h % hkv != 0:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if causal and sq > skv:
        raise ValueError(f"causal attention with Sq={sq} > Skv={skv} leaves "
                         f"rows with no key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's
    dtype. Query head h reads KV head h // (H / Hkv); query row i sits at
    position i + Skv - Sq."""
    check_shapes(q, k, v, causal, window)
    where = route(q, k, v)
    if where == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {HEAD_DIMS}, got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if where == "meta":
            continue
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if where == "meta":
        op_cost.charge_kernel("flash_attention_fwd",
                              *_work_of(q, k, causal, window))
        return out
    scale = 1.0 / math.sqrt(dh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attn_fwd_launch(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, sq, skv, h, hkv, dh, scale,
            int(causal), 0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {err} at "
                           f"launch")
    LAUNCHES["flash_attention_fwd"] += 1
    op_cost.charge_kernel("flash_attention_fwd",
                          *_work_of(q, k, causal, window))
    return out
