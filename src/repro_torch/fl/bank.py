"""ClientBank: per-client persistent state (port of the resident backend
of ``repro/fl/bank.py``): each client's latest PRNG lane key
(``fold_in(ks[5], client_id)``) and its participation count. The
error-feedback residuals (ROADMAP Queue 1, item 7) and the streamed
backend (item 8) are not ported yet; ``rounds.check_ported`` refuses
both."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import prng


@dataclass
class BankState:
    """``residuals`` (None: no error feedback); ``lanes`` (n, 2) key words
    (zeros until first participation); ``counts`` (n,) int32."""
    residuals: Optional[Any]
    lanes: torch.Tensor
    counts: torch.Tensor


def cohort_lane_keys(bank_key, sel):
    """The round's per-client bank lanes ``fold_in(ks[5], client_id)``."""
    return prng.fold_in(bank_key, sel)


class ResidentBank:
    """Dense device tensors, updated functionally each round."""

    backend = "resident"

    def __init__(self, n: int, device="cuda"):
        self.n, self.device = n, device

    def init(self) -> BankState:
        return BankState(
            residuals=None,
            lanes=torch.zeros((self.n, 2), dtype=torch.int64,
                              device=self.device),
            counts=torch.zeros((self.n,), dtype=torch.int32,
                               device=self.device))

    def scatter(self, bank: BankState, sel, lanes) -> BankState:
        """Write this round's lane keys for the cohort and bump its
        participation counts."""
        new_lanes = bank.lanes.clone()
        new_lanes[sel] = lanes
        new_counts = bank.counts.clone()
        new_counts[sel] += 1
        return BankState(residuals=None, lanes=new_lanes, counts=new_counts)

