"""The traced run: its units in three phases, each reduced on the
profiler's one clock and kept in memory.

1. ``units`` units with no profiler, on the host clock: the time a unit
   takes, which the shares of a peak divide by.
2. The same number of units under the profiler with CUDA activity alone,
   which records no host operations (CUPTI still costs each launch a
   little: 5-9% of the zamba2 production step on an H100): the device
   operations, the busy time and the window the idle share is taken
   from.
3. One unit under the profiler with host and CUDA activity: the
   benchmark's host spans, and each device operation with the time its
   launch was issued on the host, which place the operation in a layer
   and the idle gaps in a span. This phase pays the profiler's host cost
   and is read for nothing that divides by its length.

Device busy time is the union of the intervals of kernels, copies and
fills (the GPU-side copies of ``record_function`` ranges are left out),
so work on two streams at once counts once."""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

SPAN_PREFIX = "bench."

Interval = Tuple[str, int, int]      # (name, start ns, end ns)
Launched = Tuple[str, int, int, int]  # (name, start, end, launch ns)


@dataclass
class TraceRecord:
    """What a per-layer metric reads. ``units`` units took ``clean_s``
    host seconds untraced; the same number under CUDA tracing took
    ``window_s`` and ran ``ops`` on the device. ``span_units`` more ran
    under host and CUDA tracing: ``launched`` are their device
    operations with their launch times, ``spans`` the benchmark's host
    spans, ``window_ns`` that phase's window. ``work`` holds the cell's
    sizes."""
    cell: str
    units: int
    clean_s: float
    window_s: float
    ops: List[Interval]
    spans: List[Interval] = field(default_factory=list)
    launched: List[Launched] = field(default_factory=list)
    span_units: int = 0
    window_ns: Tuple[int, int] = (0, 0)
    work: Dict[str, float] = field(default_factory=dict)

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.ops]) / 1e9

    def device_s(self, pred: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.ops if pred(n)) / 1e9

    def device_s_in_spans(self, labels: Iterable[str]) -> float:
        """Device seconds of the span phase's operations whose launch
        the host issued inside a span named in ``labels``, under
        whatever kernel name."""
        labels = set(labels)
        merged: List[Tuple[int, int]] = []
        for _, s, e in sorted((x for x in self.spans if x[0] in labels),
                              key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        starts = [s for s, _ in merged]
        total = 0
        for _, s, e, at in self.launched:
            if at < 0:
                continue
            k = bisect.bisect_right(starts, at) - 1
            if k >= 0 and at <= merged[k][1]:
                total += e - s
        return total / 1e9


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(ops: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] in which no device operation ran."""
    out, cur = [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def breakdown(rec: TraceRecord, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the CUDA phase,
    summed by name, and the span phase's idle time summed by the
    innermost benchmark span the host was in when each gap began
    ("outside spans" where it was in none)."""
    by_op: Dict[str, int] = {}
    for n, s, e in rec.ops:
        by_op[n] = by_op.get(n, 0) + (e - s)
    by_span: Dict[str, int] = {}
    spans = sorted(rec.spans, key=lambda x: x[1])
    for s, e in gaps([(n, s, e) for n, s, e, _ in rec.launched],
                     *rec.window_ns):
        label = "outside spans"
        for name, ss, se in spans:
            if ss > s:
                break
            if se > s:
                label = name
        by_span[label] = by_span.get(label, 0) + (e - s)

    def ranked(d):
        return [[k[:160], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}


@contextlib.contextmanager
def span(name: str, on: bool = True):
    """A host span of the benchmark's, seen by the profiler."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    with record_function(SPAN_PREFIX + name):
        yield


@contextlib.contextmanager
def wrap_calls(targets, on: bool):
    """While open, a span around each call of the module attributes
    ``targets`` [(module, attribute, span name)]; an attribute the
    program no longer has is left out."""
    saved = []
    if on:
        for mod, attr, label in targets:
            fn = getattr(mod, attr, None)
            if fn is None:
                continue

            def wrapped(*a, __fn=fn, __label=label, **kw):
                with span(__label):
                    return __fn(*a, **kw)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _is_device_op(evt) -> bool:
    if "CUDA" not in str(evt.device_type()):
        return False
    kind = str(getattr(evt, "activity_type", lambda: "")()).lower()
    if "annotation" in kind or evt.is_user_annotation():
        return False
    return True


def _timed(run_unit, first: int, n: int, sync) -> float:
    sync()
    t0 = time.perf_counter()
    for i in range(first, first + n):
        with span("unit"):
            run_unit(i)
    sync()
    return time.perf_counter() - t0


def profile_units(run_unit: Callable[[int], None], n_units: int,
                  sync: Callable[[], None], cuda: bool = True
                  ) -> TraceRecord:
    """The three phases of the module's docstring: ``run_unit(i)`` for
    i < 2 ``n_units`` + 1. ``cuda`` False (a run on the CPU) traces host
    activity in the second phase, which then finds no device
    operations."""
    from torch.profiler import ProfilerActivity, profile
    clean_s = _timed(run_unit, 0, n_units, sync)
    device = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[device]) as prof:
        window_s = _timed(run_unit, n_units, n_units, sync)
    ops = [(evt.name(), int(evt.start_ns()), int(evt.end_ns()))
           for evt in prof.profiler.kineto_results.events()
           if _is_device_op(evt)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("window"):
            _timed(run_unit, 2 * n_units, 1, sync)
    spans: List[Interval] = []
    device_ops: List[Tuple[str, int, int, int, int]] = []
    runtime: Dict[int, int] = {}     # CUDA runtime or driver call: start
    host_op: Dict[int, int] = {}     # host operation or span: start
    win = None
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        s, e = int(evt.start_ns()), int(evt.end_ns())
        if _is_device_op(evt):
            device_ops.append((name, s, e, int(evt.correlation_id()),
                               int(evt.linked_correlation_id())))
            continue
        if "CPU" not in str(evt.device_type()):
            continue
        # a host event linked to another is a CUDA runtime or driver call
        # (its id the device operation's); one linked to none is a host
        # operation or span (its id what device operations link to)
        if evt.linked_correlation_id():
            runtime[int(evt.correlation_id())] = s
        else:
            host_op[int(evt.correlation_id())] = s
        if name.startswith(SPAN_PREFIX):
            label = name[len(SPAN_PREFIX):]
            if label == "window":
                win = (s, e)
            else:
                spans.append((label, s, e))
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    # the launch: the runtime call that issued the operation (it comes
    # before the operation starts), else the host operation it is linked
    # to; -1 where the trace has neither
    launched = []
    for n, s, e, c, lc in device_ops:
        at = runtime.get(c, -1)
        launched.append((n, s, e, at if 0 <= at <= s
                         else host_op.get(lc, -1)))
    return TraceRecord(cell="", units=n_units, clean_s=clean_s,
                       window_s=window_s, ops=ops, spans=spans,
                       launched=launched, span_units=1, window_ns=win)
