"""The program's own spans (``repro_torch.tracing``), read after a traced
run and laid beside the trace on the profiler's clock.

The program records its spans whenever a profiler records, so the
second and third phases of ``trace.py`` both leave theirs in its buffer
(the first, with no profiler, leaves none). A unit is a root span of the
program (``step``, ``prefill``) with the spans nested in it on the
thread that opened it. The third phase's units lie inside
``rec.window_ns``; the second phase's are the last ``rec.units`` that
end before it. Where the program keeps no spans (a checkout from before
them), there are no units and every reader returns nothing."""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

# the program's spans of the PRNG and the aggregate
RNG = ("masks", "channel", "aggregate")


def records() -> Optional[list]:
    """The program's spans, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.records()


class Unit:
    """A root span and the spans of its unit on the root's thread."""

    def __init__(self, root, spans):
        self.root = root
        self.spans = [s for s in spans if s.unit == root.unit
                      and s.thread == root.thread]

    def within(self, names: Sequence[str]) -> List[Tuple[int, int]]:
        """The merged stretches of time inside the spans named in
        ``names``, which hold every span nested in them."""
        merged: List[Tuple[int, int]] = []
        for s in sorted((s for s in self.spans if s.name in names),
                        key=lambda s: s.start_ns):
            if merged and s.start_ns <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], s.end_ns))
            else:
                merged.append((s.start_ns, s.end_ns))
        return merged


def covers(stretches: List[Tuple[int, int]], t: int) -> bool:
    """``t`` lies in one of the sorted, disjoint ``stretches``."""
    k = bisect.bisect_right(stretches, (t, float("inf"))) - 1
    return k >= 0 and stretches[k][0] <= t <= stretches[k][1]


def units(rec, phase: int, root: str) -> List[Unit]:
    """The units named ``root`` of the traced run's ``phase`` (2 or 3)."""
    spans = records()
    if rec.units <= 0 or not spans:
        return []
    roots = [s for s in spans if s.name == root and s.parent is None
             and s.unit == s.id]
    lo, hi = rec.window_ns
    if phase == 3:
        chosen = [r for r in roots if lo <= r.start_ns and r.end_ns <= hi]
    else:
        chosen = sorted((r for r in roots if r.end_ns < lo),
                        key=lambda r: r.end_ns)[-rec.units:]
    return [Unit(r, spans) for r in chosen]


def launched_in(rec, unit: Unit, names: Sequence[str]):
    """The third phase's device operations (name, start, end, launch)
    whose launch the host issued inside the spans ``names`` of ``unit``;
    those with no launch time are left out."""
    stretches = unit.within(names)
    return [op for op in rec.launched
            if op[3] >= 0 and covers(stretches, op[3])]
