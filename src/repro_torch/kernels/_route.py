"""The route a kernel wrapper takes (the tensors' device), the stream it
launches on, and the scalar operands it hands a kernel."""
from __future__ import annotations

import struct

import torch


def on_cpu(*tensors) -> bool:
    """True for CPU tensors (the plain version runs), False for CUDA ones
    (the kernel launches); raises for mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def scalar_like(value, t: torch.Tensor) -> torch.Tensor:
    """``value`` (a number or a one-element tensor) as a (1,) tensor of
    ``t``'s dtype on ``t``'s device: a kernel's scalar operand, cast to
    the data's dtype first, as the TPU kernels cast it. A number is
    written by a fill, with no host-to-device copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=t.device, dtype=t.dtype).reshape(1)
    return torch.full((1,), value, dtype=t.dtype, device=t.device)


def current_stream(device_index: int) -> int:
    """The raw handle of the current CUDA stream of a device, as a Python
    int for ctypes (the call Triton's launchers make: it builds no Stream
    object)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def host_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (f32 or bf16) on the host, as
    ``scalar_like`` rounds a number: to f32 (nearest even), then for bf16
    to nearest even on the upper 16 bits, NaN kept. Returned as a Python
    float, exact in f32, for a kernel to take by value."""
    f32 = struct.unpack("<f", struct.pack("<f", value))[0]
    if dtype == torch.float32:
        return f32
    if dtype != torch.bfloat16:
        raise TypeError(f"no host rounding to {dtype}")
    if f32 != f32:
        return f32
    bits = struct.unpack("<I", struct.pack("<f", f32))[0]
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return struct.unpack("<f", struct.pack("<I", bits))[0]
