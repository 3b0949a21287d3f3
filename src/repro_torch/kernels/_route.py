"""The route a kernel wrapper takes: the tensors' device."""
from __future__ import annotations


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
