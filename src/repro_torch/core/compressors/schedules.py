"""DP-aware compression schedules (port of
``repro/core/compressors/schedules.py``), evaluated from the round
counter ``t`` and the ledger's running spend ``eps_spent``, both device
tensors, so that no round reads them on the host.

Each knob returns None when the schedule leaves it alone:

- ``k_active``: the live fraction of the k budget anneals linearly from
  1 to ``k_end_ratio`` over ``cfg.rounds``, as a 0/1 column over the
  static-width support;
- ``power_scale``: a multiplier on the power limits P_i, 1 to
  ``power_end``;
- ``epsilon_round`` (mode "budget"): the per-round epsilon ceiling of
  the Theorem-5 privacy cap, ``clip((eps_total - eps_spent) /
  rounds_left, eps_floor, cfg.epsilon)`` with ``eps_total = cfg.epsilon
  cfg.rounds``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import CompressionSchedule


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _progress(t: torch.Tensor, rounds: int) -> torch.Tensor:
    """Anneal position in [0, 1]: 0 at round 0, 1 at the last round, and
    held there past ``cfg.rounds``."""
    span = float(max(rounds - 1, 1))
    return torch.clamp(_f32(t, t) / span, 0.0, 1.0)


def k_active(sched: CompressionSchedule, cfg, k_budget: int,
             t: torch.Tensor) -> Optional[torch.Tensor]:
    """(k_budget,) 0/1 live-slot column for round ``t``."""
    if sched.mode == "none" or sched.k_end_ratio >= 1.0:
        return None
    frac = 1.0 + (sched.k_end_ratio - 1.0) * _progress(t, cfg.rounds)
    k_t = torch.clamp_min(torch.floor(frac * k_budget), 1.0)
    return (torch.arange(k_budget, device=t.device) < k_t).float()


def power_scale(sched: CompressionSchedule, cfg, t: torch.Tensor):
    """The P_i multiplier for round ``t``."""
    if sched.mode == "none" or sched.power_end == 1.0:
        return None
    return 1.0 + (sched.power_end - 1.0) * _progress(t, cfg.rounds)


def epsilon_round(sched: CompressionSchedule, cfg, t: torch.Tensor,
                  eps_spent: torch.Tensor):
    """The per-round epsilon ceiling (mode "budget")."""
    if sched.mode != "budget":
        return None
    total = float(cfg.epsilon) * float(cfg.rounds)
    left = torch.clamp_min(_f32(cfg.rounds, t) - _f32(t, t), 1.0)
    remaining = torch.clamp_min(total - _f32(eps_spent, t), 0.0)
    return torch.clamp(remaining / left, sched.eps_floor, cfg.epsilon)


def is_active(sched: CompressionSchedule) -> bool:
    """Whether the schedule changes anything at all."""
    return sched.mode != "none"
