"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates without
sparsity, at its 700 W power limit). A roofline share or MFU is stated
against these, with the card's power limit printed beside it."""
from __future__ import annotations

import shutil
import subprocess

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12      # outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_flops: float, flop_per_s: float) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flop_per_s)


def card_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or what stopped
    the reading."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip() or out.stderr.strip()
