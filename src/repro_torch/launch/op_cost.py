"""What a step of the port costs, counted from the ops it dispatches (the
counterpart of ``repro/launch/hlo_cost.py``).

The reference walks compiled HLO text, multiplying each loop body by its
trip count. The port runs eagerly: its Python loops dispatch each op as
often as it runs, so ``OpCounter`` sees every op once per execution and
needs no trip-count correction. It is a ``TorchDispatchMode`` and works
the same on the ``meta`` device (shapes only, nothing allocated), the
CPU and CUDA. For every aten op it counts

- **flops**: the formulas ``torch.utils.flop_counter`` registers (mm,
  bmm, addmm, baddbmm, convolutions and their backward, SDPA); other ops
  count none, as the reference's model counts only dots and convolutions
  at full weight. A hand-written kernel's wrapper adds its own work
  (``charge_kernel``): on ``meta`` it dispatches no op that computes, and
  on CUDA its launch is invisible to the mode;
- **bytes**: each tensor operand read once and each result written once
  (eager mode fuses nothing, so every op's operands and results go
  through device memory). View and allocation ops move none;
- **peak live bytes**: every storage an op creates, rounded up to the
  CUDA caching allocator's 512-byte blocks, counts from its creation to
  its death (a ``weakref.finalize`` on the storage: the sum changes only
  when a storage is made or dies, with no sweep per op);
  ``torch.utils.checkpoint``'s recomputation in the backward is counted
  as it runs, so the peak is that of the step the card runs, remat
  included. Tensors made before the counter was entered count once
  ``track`` is given them (a step's arguments);
- **collective bytes**: each ``CohortGroup.all_reduce`` and
  ``gather_rows`` through ``charge_collective``, in the reference's ring
  model (``roofline.ring_bytes``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import ring_bytes

# the CUDA caching allocator's block granularity: every allocation is
# rounded up to a multiple of 512 bytes
ALLOC_ROUND = 512

_aten = torch.ops.aten
# ops that allocate without touching memory, or only re-describe it
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
             _aten.lift_fresh, _aten.set_, _aten.resize_}

# the counters entered, innermost last
_ACTIVE: List["OpCounter"] = []


def active() -> Optional["OpCounter"]:
    """The innermost counter entered in this process, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def charge_kernel(name: str, n_bytes: float, flops: float) -> None:
    """A hand-written kernel's launch (or, on ``meta``, its stand-in):
    adds its work to the active counter, if one is entered."""
    counter = active()
    if counter is not None:
        counter.add_kernel(name, n_bytes, flops)


def charge_collective(kind: str, result_bytes: float,
                      group_size: int) -> None:
    """One collective of ``kind`` with ``result_bytes`` on each of
    ``group_size`` ranks: adds its ring-model bytes to the active
    counter, if one is entered."""
    counter = active()
    if counter is not None:
        counter.add_collective(kind, result_bytes, group_size)


def _round(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(obj, out: list) -> list:
    """The tensors of nested lists, tuples, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module's
    docstring). ``device``: the device type whose storages count toward
    the live bytes (None: every device)."""

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._storages: Dict[int, tuple] = {}

    # ---------------------------------------------------------- the mode
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out, [])
        if not (func.is_view or packet in _NO_BYTES):
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs), []))
            self.bytes += sum(t.nbytes for t in outs)
        if not (func.is_view or func._schema.is_mutable):
            for t in outs:
                self._add(t)
        return out

    # ------------------------------------------------------ the counts
    def _add(self, t: torch.Tensor) -> None:
        if self.device is not None and t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        size = _round(st.nbytes())
        if size == 0:
            return
        self._storages[key] = (size, weakref.finalize(st, self._free, key))
        self.live += size
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key: int) -> None:
        size, _ = self._storages.pop(key)
        self.live -= size

    def track(self, *trees) -> int:
        """Count the tensors of ``trees`` (nested dicts, lists, tuples)
        as live: what a step finds allocated when it starts (its
        arguments). Returns the bytes added."""
        before = self.live
        for t in _tensors(trees, []):
            self._add(t)
        return self.live - before

    def close(self) -> None:
        """Stop following the storages still alive."""
        for _, fin in self._storages.values():
            fin.detach()
        self._storages.clear()

    def add_kernel(self, name: str, n_bytes: float, flops: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        self.flops += flops
        self.bytes += n_bytes

    def add_collective(self, kind: str, result_bytes: float,
                       group_size: int) -> None:
        self.coll += ring_bytes(kind, result_bytes, group_size)
