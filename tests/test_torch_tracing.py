"""The port's spans (``repro_torch.tracing``): off they record nothing;
on, their ids, parents, units and threads; under ``torch.profiler`` each
has its ``repro_torch.<name>`` event at its own times; the production
step and the prefill open the spans of their parts, at the sizes of the
benchmark's tiny cells; and tracing leaves their outputs alone."""
import threading

import pytest

torch = pytest.importorskip("torch")

# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
from torch.profiler import ProfilerActivity, profile

from repro_torch import prng, tracing
from repro_torch.configs.base import (ChannelConfig, ModelConfig,
                                      PFELSConfig, SSMConfig)
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

PATTERN = ("mamba",) * 5 + ("attn",)
STEP_PARTS = ["forward_backward", "clip", "channel", "masks", "energy",
              "aggregate", "apply"]


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(1)
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _cfg():
    return ModelConfig(
        name="tiny-zamba2", family="hybrid", n_layers=12, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        block_pattern=PATTERN,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16,
                      conv_width=4, dt_min=0.001),
        dtype="float32", param_dtype="float32")


def _pfels():
    return PFELSConfig(num_clients=1000, clients_per_round=1,
                       compression_ratio=0.5, epsilon=4.0, delta=1e-3,
                       local_lr=0.1, local_steps=1, clip=1.0,
                       channel=ChannelConfig(noise_std=1.0))


def _tokens(batch, seq, seed=1):
    return prng.randint(prng.PRNGKey(seed, "cpu"), (batch, seq), 0, 256
                        ).long()


def _run_step(n_clients=1):
    cfg = _cfg()
    params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    d = T.param_count(params)
    tok = _tokens(2 * n_clients, 33)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if n_clients > 1:
        params = steps.clientize_params(params, n_clients)
    step = steps.make_pfels_train_step(cfg, _pfels(), d,
                                       n_clients=n_clients)
    new, metrics = step(params, batch, prng.PRNGKey(3, "cpu"))
    return list(tree_leaves(new)) + [metrics[k] for k in sorted(metrics)]


def _run_prefill():
    cfg = _cfg()
    params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    logits, caches, _ = T.prefill(params, cfg, {"tokens": _tokens(4, 64)})
    return [logits] + list(tree_leaves(list(caches)))


def _children(recs, parent):
    return [r.name for r in sorted(recs, key=lambda r: r.id)
            if r.parent == parent]


def test_off_records_nothing():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    _run_step()
    assert tracing.records() == []


def test_ids_parents_units_and_threads():
    tracing.enable()
    seen = {}

    def other():
        seen["thread"] = threading.get_ident()
        with tracing.span("recompute"):
            with tracing.span("inner"):
                pass

    with tracing.span("step"):
        with tracing.span("masks"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracing.span("aggregate"):
            with tracing.span("aggregate.noise"):
                pass
    with tracing.span("prefill"):
        pass
    tracing.disable()
    with tracing.span("after"):
        pass
    recs = {r.name: r for r in tracing.records()}
    assert set(recs) == {"step", "masks", "recompute", "inner", "aggregate",
                         "aggregate.noise", "prefill"}
    step, me = recs["step"], threading.get_ident()
    assert step.parent is None and step.unit == step.id
    assert recs["masks"].parent == step.id
    assert recs["aggregate"].parent == step.id
    assert recs["aggregate.noise"].parent == recs["aggregate"].id
    # a span on another thread joins the open unit without a parent there
    assert recs["recompute"].parent is None
    assert recs["recompute"].thread == seen["thread"] != me
    assert recs["inner"].parent == recs["recompute"].id
    for name in ("masks", "aggregate", "aggregate.noise", "recompute",
                 "inner"):
        assert recs[name].unit == step.id, name
    assert recs["prefill"].unit == recs["prefill"].id != step.id
    ids = [r.id for r in tracing.records()]
    assert len(set(ids)) == len(ids)
    for r in tracing.records():
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = next(x for x in tracing.records() if x.id == r.parent)
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert [r.name for r in tracing.records() if r.thread == me][:3] == [
        "masks", "aggregate.noise", "aggregate"]
    tracing.clear()
    assert tracing.records() == []


def test_spans_under_the_profiler_have_events_at_their_times():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("step"):
            with tracing.span("masks"):
                torch.ones(64).sum()
            with tracing.span("aggregate"):
                torch.ones(64).sum()
    events = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.name().startswith(tracing.PREFIX):
            events[evt.name()[len(tracing.PREFIX):]] = (
                int(evt.start_ns()), int(evt.end_ns()))
    recs = tracing.records()
    assert sorted(r.name for r in recs) == ["aggregate", "masks", "step"]
    assert set(events) == {"aggregate", "masks", "step"}
    for r in recs:
        s, e = events[r.name]
        assert abs(r.start_ns - s) < 1_000_000, r
        assert abs(r.end_ns - e) < 1_000_000, r


@pytest.mark.parametrize("n_clients", [1, 2])
def test_production_step_spans(n_clients):
    tracing.enable()
    _run_step(n_clients)
    recs = tracing.records()
    roots = [r for r in recs if r.parent is None and r.unit == r.id]
    assert [r.name for r in roots] == ["step"]
    local = ["forward_backward", "clip"] * n_clients
    assert _children(recs, roots[0].id) == local + STEP_PARTS[2:]
    n_leaves = len(tree_leaves(T.init_shapes(_cfg())))
    agg = next(r for r in recs if r.name == "aggregate")
    assert _children(recs, agg.id) == ["aggregate.noise",
                                       "aggregate.combine"] * n_leaves
    assert all(r.unit == roots[0].id for r in recs)


def test_prefill_spans():
    tracing.enable()
    _run_prefill()
    recs = tracing.records()
    root = [r for r in recs if r.parent is None]
    assert [r.name for r in root] == ["prefill"]
    names = _children(recs, root[0].id)
    rep = 12 // len(PATTERN)
    blocks = []
    for kind in PATTERN * rep:
        blocks += ["mamba"] if kind == "mamba" else ["attention", "mlp"]
    assert names == ["caches"] + blocks + ["head"]


@pytest.mark.parametrize("run", [_run_step, _run_prefill],
                         ids=["step", "prefill"])
def test_tracing_leaves_outputs_alone(run):
    off = run()
    tracing.enable()
    on = run()
    assert tracing.records()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
