"""The production mesh as shapes, and the cohort's process group (port of
``repro/launch/mesh.py``).

``MeshShape`` is a mesh with no devices: ordered axis names and their
extents. The port lowers nothing, so the production meshes
(``make_production_mesh``, ``make_host_mesh``) are shapes that the
sharding rules (``repro_torch.sharding``) resolve specs against and that
``launch.dryrun`` divides the batch by. ``use_mesh``, ``make_mesh`` and
``shard_map_compat`` have no counterpart: they activate or build a JAX
device mesh, and the port runs no GSPMD program.

The reference shards the r selected clients of a round over a ("pod",
"data") device mesh; here each shard is one rank of a
``torch.distributed`` group, and the AirComp superposition is an
``all_reduce`` over it. The package never picks a backend: the caller
initialises the group, with gloo for ranks that share a card or run on
the CPU, and NCCL once each rank has its own card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import op_cost


@dataclass(frozen=True)
class MeshShape:
    """A device mesh as shapes only: ``axis_names`` in order and their
    ``extents``. ``shape`` maps each name to its extent, as a JAX mesh's
    ``shape`` does, so the sharding rules read either."""
    axis_names: Tuple[str, ...]
    extents: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.extents):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.extents)} extents")
        if any(int(e) < 1 for e in self.extents):
            raise ValueError(f"extents must be >= 1, got {self.extents}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(e) for e in self.extents)))

    @property
    def size(self) -> int:
        return math.prod(int(e) for e in self.extents)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``data, model``: one pod of 256 chips; or (2, 16, 16)
    ``pod, data, model``: two pods, 512 chips."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model")) -> MeshShape:
    """A small mesh (one device by default): the port's own runs."""
    return MeshShape(tuple(axes), tuple(int(e) for e in shape))


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
        op_cost.charge_collective("all-reduce", t.nbytes, self.world)
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
        op_cost.charge_collective("all-gather", local.nbytes * self.world,
                                  self.world)
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
