"""The route a kernel wrapper takes (the tensors' device), the stream it
launches on, and the scalar operands it hands a kernel."""
from __future__ import annotations

import math
import struct

import torch


def route(*tensors) -> str:
    """The route of a kernel wrapper, from its tensors' one device:
    ``"cpu"`` (the plain version runs), ``"cuda"`` (the kernel launches)
    or ``"meta"`` (shapes only: the wrapper returns its kernel's outputs
    as meta tensors and charges the active ``launch.op_cost`` counter with
    the kernel's work). Raises for mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def scalar_like(value, t: torch.Tensor) -> torch.Tensor:
    """``value`` (a number or a one-element tensor) as a (1,) tensor of
    ``t``'s dtype on ``t``'s device: a kernel's scalar operand, cast to
    the data's dtype first, as the TPU kernels cast it (a number past
    f32's range is inf of its sign). A number is written by a fill, with
    no host-to-device copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=t.device, dtype=t.dtype).reshape(1)
    if t.dtype == torch.float32:  # torch.full refuses what a cast saturates
        value = _f32(value)
    return torch.full((1,), value, dtype=t.dtype, device=t.device)


def current_stream(device_index: int) -> int:
    """The raw handle of the current CUDA stream of a device, as a Python
    int for ctypes (the call Triton's launchers make: it builds no Stream
    object)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _f32(value) -> float:
    """``value`` rounded to f32 (nearest even) as a Python float; past
    f32's range, inf of its sign, as a cast gives it."""
    try:
        return struct.unpack("<f", struct.pack("<f", value))[0]
    except OverflowError:  # rounds past f32's largest finite value
        return math.inf if value > 0 else -math.inf


def host_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (f32 or bf16) on the host, as
    ``scalar_like`` rounds a number: to f32 (nearest even; past f32's
    range to inf of its sign, as the cast gives), then for bf16 to nearest
    even on the upper 16 bits, NaN kept. Returned as a Python float, exact
    in f32, for a kernel to take by value."""
    f32 = _f32(value)
    if dtype == torch.float32:
        return f32
    if dtype != torch.bfloat16:
        raise TypeError(f"no host rounding to {dtype}")
    if f32 != f32:
        return f32
    bits = struct.unpack("<I", struct.pack("<f", f32))[0]
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def scalar_arg(value, t: torch.Tensor, name: str, f32_ok: bool = False):
    """A row kernel's scalar operand ``value`` (a number or a one-element
    tensor), cast to ``t``'s dtype as ``scalar_like`` casts it, as
    ``(tensor, is_f32, val)`` for its entry point. A number is rounded on
    the host (``host_scalar``) and passed by value (tensor None). A tensor
    is passed by pointer, converted to ``t``'s dtype and device only when
    it lies elsewhere or holds another dtype; with ``f32_ok`` (the kernel
    rounds an f32 scalar to ``t``'s dtype itself) an f32 one on ``t``'s
    device is passed as it is, ``is_f32`` 1 when ``t`` is not f32. The
    caller holds the tensor until the launch (a converted one has no
    other owner). Raises unless a tensor holds one value."""
    if not isinstance(value, torch.Tensor):
        return None, 0, host_scalar(value, t.dtype)
    if value.numel() != 1:
        raise ValueError(f"{name} must hold one value, got "
                         f"{tuple(value.shape)}")
    ok = (t.dtype, torch.float32) if f32_ok else (t.dtype,)
    if value.device != t.device or value.dtype not in ok:
        value = value.to(device=t.device, dtype=t.dtype)
    return value, int(value.dtype != t.dtype), 0.0
