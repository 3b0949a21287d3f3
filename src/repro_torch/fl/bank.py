"""ClientBank: per-client persistent state (port of the resident backend
of ``repro/fl/bank.py``): the error-feedback residual memory (N, d) f32
when ``cfg.error_feedback`` is set, each client's latest PRNG lane key
(``fold_in(ks[5], client_id)``) and its participation count. The
streamed backend (ROADMAP Queue 1, item 8) is not ported yet;
``rounds.check_ported`` refuses it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import prng


@dataclass
class BankState:
    """``residuals`` (n, d) f32 (None: no error feedback); ``lanes`` (n, 2)
    key words (zeros until first participation); ``counts`` (n,) int32."""
    residuals: Optional[torch.Tensor]
    lanes: torch.Tensor
    counts: torch.Tensor


def cohort_lane_keys(bank_key, sel):
    """The round's per-client bank lanes ``fold_in(ks[5], client_id)``."""
    return prng.fold_in(bank_key, sel)


class ResidentBank:
    """Dense device tensors. Lanes and counts are updated functionally;
    the residual memory is updated in place, because a copy per round
    would double the largest tensor of the run (36.9 GB at the paper's
    VGG-11 width with N = 1000): a state handed to a round shares its
    residuals with the state the round returns."""

    backend = "resident"

    def __init__(self, n: int, d: int, error_feedback: bool,
                 device="cuda"):
        self.n, self.d, self.error_feedback = n, d, error_feedback
        self.device = device

    def init(self) -> BankState:
        return BankState(
            residuals=(torch.zeros((self.n, self.d), dtype=torch.float32,
                                   device=self.device)
                       if self.error_feedback else None),
            lanes=torch.zeros((self.n, 2), dtype=torch.int64,
                              device=self.device),
            counts=torch.zeros((self.n,), dtype=torch.int32,
                               device=self.device))

    def gather(self, bank: BankState, sel) -> Optional[torch.Tensor]:
        """The cohort's (r, d) residual slice, or None without EF."""
        if bank.residuals is None:
            return None
        return bank.residuals[sel]

    def scatter(self, bank: BankState, sel, new_residuals,
                lanes) -> BankState:
        """Write the cohort's updated residual slice and this round's lane
        keys back, and bump its participation counts. ``sel`` must be
        unique (``sample_cohort`` draws without replacement): a repeated
        client would keep only one of its residual rows."""
        res = bank.residuals
        if res is not None and new_residuals is not None:
            if torch.unique(sel).numel() != sel.numel():
                raise ValueError("the cohort repeats a client: its "
                                 "residual rows would overwrite each other")
            res[sel] = new_residuals
        new_lanes = bank.lanes.clone()
        new_lanes[sel] = lanes
        new_counts = bank.counts.clone()
        new_counts[sel] += 1
        return BankState(residuals=res, lanes=new_lanes, counts=new_counts)
