"""Entry point of the flat-vector l2 clip (port of
``repro/kernels/clip_norm/ops.py``): pad d to whole 128-lane rows, clip
through the kernel (or, with ``use_kernel=False``, the plain version on
any device), and cut the pad off again."""
from __future__ import annotations

import torch

from repro_torch.kernels.clip_norm.kernel import LANES, clip_norm
from repro_torch.kernels.clip_norm.ref import clip_norm_ref


def clip_flat(x_flat: torch.Tensor, clip: float, *, use_kernel: bool = True):
    """x_flat: (d,) f32 or bf16 -> (clipped (d,), ||x|| f32 scalar)."""
    d = x_flat.shape[0]
    pad = (-d) % LANES
    x = torch.nn.functional.pad(x_flat, (0, pad)) if pad else x_flat
    rows = x.reshape(-1, LANES).contiguous()
    out, nrm = (clip_norm if use_kernel else clip_norm_ref)(rows, clip)
    out = out.reshape(-1)
    return (out[:d] if pad else out), nrm
