"""Learning-rate schedules (port of ``repro/optim/schedules.py``): each
maps a step (a number or a tensor) to an f32 0-dim tensor."""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        mult = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return _f32(lr * mult)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = _f32(step)
        wu = lr * torch.clamp_max(step / max(warmup, 1), 1.0)
        return torch.where(step < warmup, wu, cos(step - warmup))
    return f
