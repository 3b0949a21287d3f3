"""Spans at the port's layer boundaries, kept in memory.

``with span("masks"): ...`` marks one part of the work. Tracing is on
after ``enable()`` and whenever a ``torch.profiler`` session records;
otherwise a span costs one check and records nothing. On, a span appends
one ``Span`` to a ring of the last ``CAPACITY`` spans when it closes, and
under a profiler also opens the profiler's range ``"repro_torch." +
name``, so that it shows in the profiler's trace as a host operation.

The times are ``time.time_ns()``, the clock ``torch.profiler`` reports
its host and device events on, so a span can be laid beside the device
operations and runtime calls of a trace. ``start_ns`` is read after the
profiler's range opens and ``end_ns`` before it closes.

A span opened while none is open starts a unit (``step``, ``prefill``):
its ``unit`` is its own ``id``, and every span opened inside it carries
that unit. The parent is the innermost span open on the same thread; a
span with none on its thread, opened while a unit is open on another
(autograd's device thread recomputing blocks in the backward), joins
that unit with no parent.

Spans of the production step (``launch/steps.py``): ``step``, its parts
``forward_backward``, ``clip``, ``channel``, ``masks``, ``energy``,
``aggregate`` (``aggregate.noise`` and ``aggregate.combine`` a leaf) and
``apply``. Of the model (``models/transformer.py``): ``prefill``,
``caches``, ``head``, and a block's ``mamba``, ``attention``, ``mlp`` or
``moe``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16
PREFIX = "repro_torch."

# the profiler's range of a span: a RecordFunction opened directly, not
# through the operator dispatch of ``record_function``, whose own cost,
# recorded by the profiler, put a third of a step's span ends over 50 us
# before their events' on an H100 host; opened directly, every span lay
# within 25 us of its event (``PERF.md`` section 6)
_Range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or _autograd_profiler.record_function)


class Span(NamedTuple):
    unit: int
    id: int
    parent: Optional[int]
    name: str
    thread: int
    start_ns: int
    end_ns: int


_spans: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_units: List[int] = []       # the units open, outermost first
_enabled = False


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        """A profiler records: the flag every profiler session sets."""
        return _autograd_profiler._is_profiler_enabled
else:
    _profiling = torch._C._autograd._profiler_enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def records() -> List[Span]:
    """The spans kept, in the order they closed."""
    return list(_spans)


def clear() -> None:
    _spans.clear()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "unit", "id", "parent", "stack", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent = None
            self.unit = _units[-1] if _units else self.id
            if self.unit == self.id:
                _units.append(self.id)
        stack.append(self)
        self.stack = stack
        self.range = None
        if _profiling():
            self.range = _Range(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        if self.unit == self.id:
            _units.remove(self.id)
        _spans.append(Span(self.unit, self.id, self.parent, self.name,
                           threading.get_ident(), self.start, end))
        return False


def span(name: str):
    """A context manager that records the work inside it as the span
    ``name`` when tracing is on."""
    if _enabled or _profiling():
        return _On(name)
    return _OFF
