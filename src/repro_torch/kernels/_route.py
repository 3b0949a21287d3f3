"""The route a kernel wrapper takes (the tensors' device), and the scalar
operands it hands a kernel."""
from __future__ import annotations

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
