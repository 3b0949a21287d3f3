"""The readers of the program's own spans on synthetic spans and
operations whose answers are worked out by hand, and one traced run of
the tiny step cell on the CPU."""
from pathlib import Path

import pytest

from bench import harness
from bench.tests import cells
from bench.yardstick import program_spans, trace
from repro_torch.tracing import Span

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000          # ns
A, B = 1, 2             # the main thread, and another


def _reader(name):
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                               "ps_" + name.replace(".", "_"))


def _span(unit, sid, parent, name, start, end, thread=A):
    return Span(unit, sid, parent, name, thread, start * MS, end * MS)


# an earlier run's step, a second-phase step and a third-phase step (the
# window is 1000-2000 ms), each with a span on another thread that counts
# for nothing
STEP_SPANS = [
    _span(1, 1, None, "step", 10, 90), _span(1, 2, 1, "masks", 20, 30),
    _span(10, 10, None, "step", 100, 900),
    _span(10, 11, 10, "forward_backward", 100, 300),
    _span(10, 12, 10, "channel", 300, 310),
    _span(10, 13, 10, "masks", 310, 400),
    _span(10, 14, 10, "energy", 400, 420),
    _span(10, 15, 10, "aggregate", 420, 800),
    _span(10, 16, 15, "aggregate.noise", 430, 500),
    _span(10, 17, 15, "aggregate.combine", 500, 600),
    _span(10, 18, 10, "apply", 800, 900),
    _span(10, 19, None, "aggregate", 850, 880, thread=B),
    _span(20, 20, None, "step", 1100, 1900),
    _span(20, 21, 20, "masks", 1200, 1300),
    _span(20, 22, 20, "aggregate", 1300, 1500),
    _span(20, 23, 22, "aggregate.noise", 1310, 1400),
    _span(20, 24, 20, "apply", 1500, 1600),
    _span(20, 25, None, "masks", 1700, 1800, thread=B),
]
# the second phase's device operations
STEP_OPS = [("k", a * MS, b * MS) for a, b in
            [(100, 290), (320, 350), (440, 450), (520, 700), (805, 860),
             (890, 900)]]
# the third phase's, each with the host time of its launch
STEP_LAUNCHED = [("k", (at + 5) * MS, (at + 6) * MS, at * MS) for at in
                 (1150, 1250, 1320, 1450, 1550, 1750)] + [
                     ("k", 1400 * MS, 1410 * MS, -1)]


def _rec(ops=(), launched=(), units=1):
    return trace.TraceRecord(cell="c", units=units, clean_s=1.0,
                             window_s=1.0, ops=list(ops),
                             launched=list(launched), span_units=1,
                             window_ns=(1000 * MS, 2000 * MS))


@pytest.fixture
def spans(monkeypatch):
    box = []
    monkeypatch.setattr(program_spans, "records", lambda: list(box))
    return box


def test_rng_host_ms_takes_the_last_steps_before_the_window(spans):
    spans += STEP_SPANS
    read = _reader("step.rng_host_ms").read
    # channel and masks 300-400, aggregate 420-800
    assert read(_rec()) == pytest.approx(100 + 380)
    # two second-phase steps: the earlier run's masks join
    assert read(_rec(units=2)) == pytest.approx((480 + 10) / 2)


def test_rng_idle_ms_counts_gaps_by_the_span_they_begin_in(spans):
    spans += STEP_SPANS
    # gaps 290-320 (forward and backward), 350-440 (masks), 450-520
    # (aggregate.noise, inside the aggregate), 700-805 (aggregate),
    # 860-890 (apply; the other thread's aggregate does not count)
    assert _reader("step.rng_idle_ms").read(_rec(STEP_OPS)) == \
        pytest.approx(90 + 70 + 105)


def test_rng_launches_counts_by_the_launching_span(spans):
    spans += STEP_SPANS
    # 1250 masks, 1320 aggregate.noise, 1450 aggregate; not 1150 (step),
    # 1550 (apply), 1750 (the other thread's masks) or the unknown launch
    assert _reader("step.rng_launches").read(
        _rec(launched=STEP_LAUNCHED)) == 3


def test_mamba_ms_sums_the_operations_launched_in_mamba(spans):
    spans += [
        _span(5, 5, None, "prefill", 100, 900),
        _span(5, 6, 5, "mamba", 100, 800),
        _span(30, 30, None, "prefill", 1100, 1900),
        _span(30, 31, 30, "mamba", 1100, 1300),
        _span(30, 32, 30, "attention", 1300, 1400),
        _span(30, 33, 30, "mlp", 1400, 1500),
        _span(30, 34, 30, "mamba", 1500, 1700),
        _span(30, 35, 30, "head", 1700, 1750),
        _span(30, 36, None, "mamba", 1300, 1400, thread=B)]
    launched = [("a", 1200 * MS, 1260 * MS, 1150 * MS),
                ("b", 1300 * MS, 1400 * MS, 1350 * MS),
                ("c", 1500 * MS, 1540 * MS, 1600 * MS),
                ("d", 1700 * MS, 1710 * MS, -1)]
    assert _reader("prefill.mamba_ms").read(_rec(launched=launched)) == \
        pytest.approx(60 + 40)
    # no prefill in the step's readers
    assert _reader("step.rng_launches").read(_rec(launched=launched)) is None


@pytest.mark.parametrize("name", ["step.rng_host_ms", "step.rng_idle_ms",
                                  "step.rng_launches", "prefill.mamba_ms"])
def test_readers_find_nothing_without_program_spans(monkeypatch, name):
    # a program with no tracing module
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert _reader(name).read(_rec(STEP_OPS, STEP_LAUNCHED)) is None


def test_traced_tiny_step_reports_host_time_in_the_draws(tmp_path):
    root = cells.root_with(tmp_path, cells.STEP)
    res, table = harness.run_cell("tiny-step", 3700000071, 0.2, True,
                                  root=root, device="cpu",
                                  require_cuda=False)
    assert res["correct"], table
    assert res["metrics"]["step.rng_host_ms"]["value"] > 0
