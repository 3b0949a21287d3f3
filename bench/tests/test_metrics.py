"""The trace reduction and every per-layer reader on synthetic traces
whose answers are worked out by hand."""
from pathlib import Path

import pytest

from bench import harness
from bench.yardstick import peaks, trace, work
from bench.yardstick.classify import op_class

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000          # ns


def _rec(ops, spans=(), units=2, window_s=1.0, clean_s=None, launched=(),
         **work_kw):
    return trace.TraceRecord(
        cell="c", units=units, window_s=window_s,
        clean_s=window_s if clean_s is None else clean_s, ops=list(ops),
        spans=list(spans), launched=list(launched),
        span_units=1 if units else 0, work=dict(work_kw),
        window_ns=(0, 1000 * MS))


def _reader(name):
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_union_counts_overlap_once():
    assert trace.union_ns([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert trace.union_ns([]) == 0


def test_gaps_and_breakdown_by_span():
    ops = [("k1", 100 * MS, 300 * MS), ("k2", 250 * MS, 400 * MS),
           ("k1", 700 * MS, 800 * MS)]
    spans = [("unit", 0, 1000 * MS), ("aggregate", 400 * MS, 700 * MS)]
    # the span phase's operations, each with its launch time
    rec = _rec(ops, spans, launched=[(n, a, b, a) for n, a, b in ops])
    assert trace.gaps(ops, 0, 1000 * MS) == [
        (0, 100 * MS), (400 * MS, 700 * MS), (800 * MS, 1000 * MS)]
    assert rec.busy_s() == pytest.approx(0.4)
    b = trace.breakdown(rec)
    assert b["device_ops"] == [["k1", 0.3], ["k2", 0.15]]
    assert sorted(b["idle_gaps"]) == [["aggregate", 0.3], ["unit", 0.3]]


def test_classes():
    assert op_class("void clip_kernel<float>(float const*)") == "clip_norm"
    assert op_class("ssd_scan_tc_kernel<64, 64>") == "ssd_scan"
    assert op_class("flash_fwd_tc_kernel") == "flash_attn"
    assert op_class("fused_combine_kernel") == "transmit"
    assert op_class("cudnn::winograd_nonfused") == "conv"
    assert op_class("nvjet_tst_128x256_64x4") == "gemm"
    assert op_class("elementwise_kernel<BitwiseAndFunctor<long> >") == "rng"
    assert op_class("Memcpy DtoD (Device -> Device)") == "copy"
    assert op_class("vectorized_elementwise_kernel<float>") == "other"


def test_idle_and_mfu():
    # idle from the CUDA-traced window, the shares of a peak from the
    # untraced one
    rec = _rec([("k", 0, 250 * MS)], window_s=1.0, clean_s=0.5, units=2,
               params=1e9, tokens=1000)
    assert _reader("step.device_idle").read(rec) == pytest.approx(75.0)
    assert _reader("prefill.device_idle").read(rec) == pytest.approx(75.0)
    want = 100 * 6e12 * 2 / 0.5 / peaks.BF16_FLOP_PER_S
    assert _reader("step_mfu").read(rec) == pytest.approx(want)
    assert _reader("prefill_mfu").read(rec) == pytest.approx(want / 3)


def test_device_time_classes():
    ops = [("BitwiseXorFunctor<long>", 0, 30 * MS),
           ("MulFunctor<double>", 30 * MS, 40 * MS),
           ("nvjet_tst", 40 * MS, 90 * MS),
           ("ssd_scan_tc_kernel", 90 * MS, 95 * MS),
           ("Memcpy DtoD", 95 * MS, 99 * MS)]
    rec = _rec(ops, units=2)
    assert _reader("prefill.elementwise_ms").read(rec) == pytest.approx(
        (30 + 10 + 4) / 2)


def test_rng_ms_counts_by_the_launching_span_not_the_name():
    spans = [("forward_backward", 0, 100 * MS), ("masks", 100 * MS,
                                                  200 * MS),
             ("aggregate", 300 * MS, 500 * MS), ("inner", 350 * MS,
                                                  360 * MS)]
    launched = [("BitwiseXorFunctor<long>", 110 * MS, 140 * MS, 105 * MS),
                # a fused kernel under a name of its own, launched from
                # a nested span inside the aggregate
                ("fused_threefry_fma", 400 * MS, 420 * MS, 355 * MS),
                ("nvjet_tst", 120 * MS, 170 * MS, 50 * MS),
                ("MulFunctor<double>", 600 * MS, 610 * MS, 550 * MS),
                ("unknown_launch", 150 * MS, 160 * MS, -1)]
    rec = _rec([], spans, launched=launched, units=2)
    assert _reader("step.rng_ms").read(rec) == pytest.approx(30 + 20)
    assert rec.device_s_in_spans(["forward_backward"]) == \
        pytest.approx(0.05)


def test_rooflines():
    n = 1 << 26
    bound = peaks.bound_s(*work.clip_norm(n), peaks.F32_FLOP_PER_S)
    rec = _rec([("clip_kernel<float>", 0, int(4 * bound * 1e9))], units=2,
               clip_elems=n, clip_calls=1)
    # the device time is whole nanoseconds
    assert _reader("clip_norm_roofline").read(rec) == pytest.approx(
        50.0, rel=1e-4)
    shapes = dict(batch=8, seq=1024, elem=2, mamba_calls=3, attn_calls=1,
                  ssm_heads=80, ssm_head_dim=64, ssm_state=64, ssm_chunk=128,
                  heads=32, kv_heads=32, head_dim=80)
    sb = peaks.bound_s(*work.ssd_scan(8, 1024, 80, 64, 64, 128, 2),
                       peaks.BF16_FLOP_PER_S)
    fb = peaks.bound_s(*work.flash_attention(8, 1024, 1024, 32, 32, 80, 2),
                       peaks.BF16_FLOP_PER_S)
    rec = _rec([("ssd_scan_tc", 0, int(3 * sb * 1e9)),
                ("ssd_scan_tc", 0, int(3 * sb * 1e9)),
                ("flash_fwd_tc", 0, int(2 * fb * 1e9))], units=1, **shapes)
    # two launches of 3 bounds each over 3 calls: 2 bounds a call
    assert _reader("ssd_scan_roofline").read(rec) == pytest.approx(
        50.0, rel=1e-3)
    assert _reader("flash_attn_roofline").read(rec) == pytest.approx(
        50.0, rel=1e-3)


def test_flash_pairs_causal():
    # 3 queries over 3 keys: 1 + 2 + 3 pairs
    assert work.flash_attention(1, 3, 3, 1, 1, 2, 2)[1] == 4.0 * 2 * 6


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "bench" / "metrics").glob("*.py")))
def test_reader_finds_nothing_in_an_empty_trace(name):
    w = dict(params=1, tokens=1, clip_elems=1, clip_calls=1, batch=1,
             seq=1, elem=2, mamba_calls=1, attn_calls=1, ssm_heads=1,
             ssm_head_dim=1, ssm_state=1, ssm_chunk=1, heads=1, kv_heads=1,
             head_dim=1, images=1, r=1, d=1, resnet_flops=1)
    value = _reader(name).read(_rec([], units=0, window_s=0.0, **w))
    assert value is None
