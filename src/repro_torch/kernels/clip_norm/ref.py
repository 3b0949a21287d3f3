"""Plain PyTorch version of the global l2-norm clip (port of
``repro/kernels/clip_norm/ref.py``): x <- x * min(1, C/||x||)
(Assumption 1). The CPU route of ``kernel.clip_norm`` runs it; on the card
it is the version the kernel is held against."""
from __future__ import annotations

import torch


def clip_norm_ref(x: torch.Tensor, clip: float):
    """x: any shape, f32 or bf16 -> (x * min(1, C/max(||x||, 1e-12)) in
    x's dtype, ||x|| as an f32 scalar). The sum of squares is taken in
    f32, and the scale formed in f32."""
    nrm = torch.sqrt(torch.sum(torch.square(x.float())))
    # full_like, not ``clip / t``: torch computes a Python number over a
    # tensor as a reciprocal times the number, which rounds differently
    scale = torch.clamp_max(
        torch.full_like(nrm, clip) / torch.clamp_min(nrm, 1e-12), 1.0)
    return (x.float() * scale).to(x.dtype), nrm
