"""ClientBank: per-client persistent state (port of ``repro/fl/bank.py``):
the error-feedback residual memory (N, d) f32 when ``cfg.error_feedback``
is set, each client's latest PRNG lane key (``fold_in(ks[5],
client_id)``) and its participation count.

Two backends share one interface:

- ``resident``: dense tensors on the Trainer's device.
- ``streamed``: the bank stays in host memory (pinned where the Trainer
  runs on a card); only the sampled cohort's (r, .) slices move to the
  device and back each round. Device memory is then independent of N,
  and the two backends give bit-equal runs under the same key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch import prng

BACKENDS = ("resident", "streamed")


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


class ClientBank:
    """The backends' interface: ``gather`` and ``scatter`` move the
    sampled cohort's slice of the bank; nothing else in the round touches
    (n, d) state."""

    backend: str

    def init(self) -> BankState:
        raise NotImplementedError

    def gather(self, bank: BankState, sel) -> Optional[torch.Tensor]:
        """The cohort's (r, d) residual slice, or None without EF."""
        raise NotImplementedError

    def scatter(self, bank: BankState, sel, new_residuals,
                lanes) -> BankState:
        """Write the cohort's updated residual slice and this round's lane
        keys back, and bump its participation counts."""
        raise NotImplementedError

    def clone(self, bank: BankState) -> BankState:
        """A state safe to update without changing the caller's (the
        state itself where nothing is updated in place)."""
        return bank


class ResidentBank(ClientBank):
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


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(t)


class StreamedBank(ClientBank):
    """The bank in host memory: ``gather`` hands out the cohort's (r, d)
    residual rows (in pinned memory when the Trainer runs on a card, so
    their copy to the card can run asynchronously) and ``scatter`` writes
    the updated rows, lanes and counts back in place. The Trainer clones
    the bank once per ``run`` (:meth:`clone`), so a caller's state stays
    valid."""

    backend = "streamed"

    def __init__(self, n: int, d: int, error_feedback: bool,
                 device: Union[str, torch.device] = "cuda"):
        self.n, self.d, self.error_feedback = n, d, error_feedback
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"

    def init(self) -> BankState:
        return BankState(
            residuals=(torch.zeros((self.n, self.d), dtype=torch.float32,
                                   pin_memory=self.pin)
                       if self.error_feedback else None),
            lanes=torch.zeros((self.n, 2), dtype=torch.int64,
                              pin_memory=self.pin),
            counts=torch.zeros((self.n,), dtype=torch.int32,
                               pin_memory=self.pin))

    def gather(self, bank: BankState, sel) -> Optional[torch.Tensor]:
        """The cohort's (r, d) residual rows on the host, or None without
        EF."""
        if bank.residuals is None:
            return None
        sel = torch.as_tensor(sel).cpu().long()
        out = torch.empty((sel.numel(), self.d), dtype=torch.float32,
                          pin_memory=self.pin)
        return torch.index_select(bank.residuals, 0, sel, out=out)

    def scatter(self, bank: BankState, sel, new_residuals,
                lanes) -> BankState:
        """Write the cohort's rows, lane keys and counts back in place.
        ``sel`` must be unique, as for the resident bank."""
        sel = torch.as_tensor(sel).cpu().long()
        if bank.residuals is not None and new_residuals is not None:
            if torch.unique(sel).numel() != sel.numel():
                raise ValueError("the cohort repeats a client: its "
                                 "residual rows would overwrite each other")
            bank.residuals[sel] = new_residuals.cpu()
        bank.lanes[sel] = lanes.cpu()
        bank.counts[sel] += 1
        return bank

    def clone(self, bank: BankState) -> BankState:
        return BankState(
            residuals=(None if bank.residuals is None
                       else _host_copy(bank.residuals, self.pin)),
            lanes=_host_copy(bank.lanes, self.pin),
            counts=_host_copy(bank.counts, self.pin))


def make_bank(backend: str, n: int, d: int, error_feedback: bool,
              device: Union[str, torch.device] = "cuda"):
    """Backend factory keyed by ``PFELSConfig.bank_backend``."""
    if backend == "resident":
        return ResidentBank(n, d, error_feedback, device)
    if backend == "streamed":
        return StreamedBank(n, d, error_feedback, device)
    raise ValueError(f"unknown bank backend {backend!r}; "
                     f"choose from {BACKENDS}")


def to_host(bank: BankState) -> BankState:
    """A copy in host memory (a resident state in the streamed layout)."""
    return BankState(
        residuals=(None if bank.residuals is None
                   else bank.residuals.cpu().clone()),
        lanes=bank.lanes.cpu().clone(), counts=bank.counts.cpu().clone())


def to_device(bank: BankState,
              device: Union[str, torch.device] = "cuda") -> BankState:
    """A copy on ``device`` (a streamed state in the resident layout)."""
    return BankState(
        residuals=(None if bank.residuals is None
                   else bank.residuals.to(device, copy=True)),
        lanes=bank.lanes.to(device, copy=True),
        counts=bank.counts.to(device, copy=True))
