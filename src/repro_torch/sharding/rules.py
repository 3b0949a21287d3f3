"""Logical-axis -> mesh-axis sharding rules (port of
``repro/sharding/rules.py``), as pure functions of a mesh's shape.

Params carry *logical* axis names (``models.transformer.logical_axes``);
this module resolves them against a mesh (``launch.mesh.MeshShape``, or
anything whose ``shape`` maps axis names to extents):

  - "fsdp"    -> the `data` mesh axis (params sharded for memory)
  - "tensor"  -> the `model` mesh axis (heads / ff / experts / vocab)
  - "batch"   -> (`pod`, `data`) for activations
  - params are replicated over `pod` (each pod = one FL client)
  - a logical axis resolves to None (replicated) if the tensor dim is not
    divisible by the mesh axis size: small archs degrade to replication.

``resolve_spec`` returns the tuple of entries a ``PartitionSpec`` holds;
``tree_specs`` is the counterpart of ``tree_shardings``; ``shard_shape``
gives one device's block of a tensor under a spec, for the per-device
bytes of ``launch.dryrun``. ``constraint``, ``named_sharding`` and
``get_abstract_mesh_or_none`` have no counterpart: they place arrays on a
JAX mesh inside a GSPMD program, and the port runs none.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

LOGICAL_TO_MESH = {
    "fsdp": "data",
    "tensor": "model",
    "clients": "pod",       # explicit client (FL) dim of param replicas
    "cohort": ("pod", "data"),  # FL-round client dim of (r, d) updates
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq_mp": "model",      # sequence dim sharded over model
    "seq_all": ("data", "model"),
    "layers": None,
    None: None,
}

PURE_FSDP = {
    "batch": ("pod", "data", "model"),
    "batch_nopod": ("data", "model"),
    "fsdp": ("data", "model"),
    "tensor": None,
    "seq_mp": None,
    "seq_all": ("data", "model"),
}

_EXCLUDED = threading.local()
_OVERRIDES = threading.local()


def mesh_axis_size(mesh, axis) -> int:
    """The extent of a mesh axis, or the product over a tuple of axes (1
    for None or an axis the mesh lacks)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(axis, 1)


def cohort_axis_size(mesh) -> int:
    """Extent of the FL-cohort client dim on ``mesh`` (the ('pod',
    'data') product): how many shards the round's r clients split
    into."""
    return mesh_axis_size(mesh, LOGICAL_TO_MESH["cohort"])


@contextlib.contextmanager
def logical_overrides(mapping):
    """Re-map logical axes for a region, e.g. pure-FSDP parallelism maps
    'tensor' -> None and folds the `model` axis into batch/fsdp."""
    prev = getattr(_OVERRIDES, "map", None)
    _OVERRIDES.map = dict(mapping)
    try:
        yield
    finally:
        _OVERRIDES.map = prev


@contextlib.contextmanager
def exclude_axes(*axes):
    """Specs resolved inside this context never reference ``axes`` (the
    reference's vmap(spmd_axis_name=...) and shard_map regions)."""
    prev = getattr(_EXCLUDED, "axes", frozenset())
    _EXCLUDED.axes = prev | frozenset(axes)
    try:
        yield
    finally:
        _EXCLUDED.axes = prev


def usable_axes(mesh) -> set:
    """Mesh axes a spec may reference: present and not excluded (a shape
    mesh has no Manual axes)."""
    excluded = getattr(_EXCLUDED, "axes", frozenset())
    return {a for a in mesh.shape if a not in excluded}


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh) -> Tuple:
    """Resolve logical axis names to the entries of a PartitionSpec,
    dropping axes whose size does not divide the tensor dim (graceful
    replication)."""
    usable = usable_axes(mesh)
    overrides = getattr(_OVERRIDES, "map", None)
    out = []
    for name, dim in zip(logical, shape):
        if overrides is not None and name in overrides:
            axis = overrides[name]
        else:
            axis = LOGICAL_TO_MESH.get(name, None)
        # drop mesh axes missing from this mesh (e.g. 'pod' on one pod)
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if a in usable)
            if not axis:
                axis = None
            elif len(axis) == 1:
                axis = axis[0]
        elif axis is not None and axis not in usable:
            axis = None
        if axis is not None and dim % mesh_axis_size(mesh, axis) != 0:
            axis = None
        out.append(axis)
    return tuple(out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(mesh, logical_tree, shape_tree):
    """A nested tree of logical-axis tuples and the matching tree of
    tensors (any device, ``meta`` included) or shape tuples -> the same
    tree of resolved specs."""
    if _is_logical(logical_tree):
        shape = (shape_tree if isinstance(shape_tree, tuple)
                 else tuple(shape_tree.shape))
        return resolve_spec(logical_tree, shape, mesh)
    if isinstance(logical_tree, dict):
        return {k: tree_specs(mesh, v, shape_tree[k])
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(tree_specs(mesh, v, s) for v, s in
                                  zip(logical_tree, shape_tree))
    raise TypeError(f"not a logical tree: {logical_tree!r}")


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple:
    """One device's block of a tensor of ``shape`` under ``spec`` (each
    dim divided by the extent of the mesh axes its entry names; a short
    spec leaves the trailing dims whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, spec):
        n = mesh_axis_size(mesh, axis)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axis} "
                             f"({n} devices)")
        out.append(dim // n)
    return tuple(out)
