"""The cohort's process group (port of the cohort part of
``repro/launch/mesh.py``).

The reference shards the r selected clients of a round over a ("pod",
"data") device mesh; here each shard is one rank of a
``torch.distributed`` group, and the AirComp superposition is an
``all_reduce`` over it. The package never picks a backend: the caller
initialises the group, with gloo for ranks that share a card or run on
the CPU, and NCCL once each rank has its own card. The TPU-mesh helpers
of the reference (``make_production_mesh``, ``make_host_mesh``,
``use_mesh``, ``shard_map_compat``) have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist


def cohort_shape(r: int, n_dev: int):
    """(pod, data) extents for a cohort of r clients on n_dev devices: the
    total is the largest divisor of r that fits, so an awkward r degrades
    to fewer shards, and at last to (1, 1), the unsharded round. The shard
    count is split pod-major with pod <= data."""
    n = min(max(int(n_dev), 1), max(int(r), 1))
    while n > 1 and r % n:
        n -= 1
    pod = 1
    for p in range(int(n ** 0.5), 0, -1):
        if n % p == 0:
            pod = p
            break
    return pod, n // pod


@dataclass(frozen=True)
class CohortGroup:
    """Where this rank's clients sit in a round's cohort of r.

    ``shards`` is ``pod * data`` of ``cohort_shape(r, world)``; shard s
    holds clients ``[s * r_local, (s + 1) * r_local)``, contiguous in r
    order, as ``P(("pod", "data"))`` lays them over a (pod, data) mesh,
    and rank s of ``group`` holds shard s. A rank at or past ``shards``
    is spare: it holds no client, adds zeros to every sum and ends the
    round with the same replicated state as the others."""
    shards: int
    index: int
    r_local: int
    world: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def spare(self) -> bool:
        return self.index >= self.shards

    @property
    def clients(self) -> slice:
        """This rank's slice of the r clients (empty on a spare rank)."""
        lo = min(self.index, self.shards) * self.r_local
        return slice(lo, lo + (0 if self.spare else self.r_local))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank of the group, in place. Every
        rank ends with the same bits."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The shards' (r_local, ...) blocks stacked in shard order into
        (r, ...), on every rank; a spare rank passes an empty block and
        sends zeros in its place."""
        if self.spare:
            local = torch.zeros((self.r_local,) + tuple(local.shape[1:]),
                                dtype=local.dtype, device=local.device)
        parts: List[torch.Tensor] = [torch.empty_like(local)
                                     for _ in range(self.world)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts[:self.shards])


def make_cohort_group(r: int, group: Optional[dist.ProcessGroup] = None
                      ) -> CohortGroup:
    """The counterpart of the reference's ``make_cohort_mesh(r)``: the
    shards of a cohort of r clients over ``group`` (None: the default
    group). With ``torch.distributed`` not initialised, or a world of 1,
    there is one shard."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
    else:
        world, rank, group = 1, 0, None
    pod, data = cohort_shape(r, world)
    shards = pod * data
    return CohortGroup(shards=shards, index=rank, r_local=r // shards,
                       world=world, group=group)
