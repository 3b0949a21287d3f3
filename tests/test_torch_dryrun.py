"""The port's production analysis on the CPU, against the JAX reference
where it has a counterpart: ``launch.roofline`` (``model_flops`` and the
ring model of ``hlo_analysis.collective_bytes``), ``launch.op_cost``'s
counts (a matmul's FLOPs against ``hlo_cost.analyze_hlo`` exactly, their
growth with a loop's trip count and the backward; the peak of live bytes
on a hand-built sequence and for one reduced step on ``meta`` and on the
CPU), the kernel wrappers' ``meta`` route (their plain versions' shapes
and dtypes, their work formulas charged), ``models/moe.py``'s fixed-length
expert counts, and ``launch.dryrun`` itself on the reduced families at
``tests/test_launch.py``'s four shapes, the cohort round and the CLI.

Tolerances: FLOPs and byte counts are integers held exactly; the peaks
are integers held exactly.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as JH
from repro.launch.hlo_cost import analyze_hlo
from repro_torch import prng
from repro_torch.configs import PFELSConfig, reduced_config
from repro_torch.configs.shapes import InputShape
from repro_torch.core.channel import scaled_channel
from repro_torch.kernels import _route
from repro_torch.kernels.aircomp_combine import kernel as comb_kernel
from repro_torch.kernels.clip_norm import kernel as clip_kernel
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.pfels_transmit import kernel as pfels_kernel
from repro_torch.kernels.randk_gather import kernel as gather_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch import dryrun, op_cost, roofline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_pfels_train_step
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T

SMALL_SHAPES = (InputShape("t_train", 128, 8, "train"),
                InputShape("t_prefill", 256, 4, "prefill"),
                InputShape("t_decode", 256, 4, "decode"),
                InputShape("long_500k", 512, 1, "decode"))
DRYRUN_ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m", "whisper-tiny",
                "qwen2-vl-72b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread, as the other files that mix
    torch and XLA work pin it (ROADMAP's test-time note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- roofline

@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_flops_is_the_reference(kind):
    for n, tok in ((3_800_000_000, 1_048_576), (130_000_000, 128), (7, 3)):
        assert roofline.model_flops(n, tok, kind) == \
            JH.model_flops(n, tok, kind)


@pytest.mark.parametrize("kind", roofline.KINDS)
@pytest.mark.parametrize("group", [1, 2, 16, 256])
def test_ring_bytes_is_the_reference_ring_model(kind, group):
    """One collective line of HLO text through the reference's
    ``collective_bytes`` against ``ring_bytes`` of its result bytes."""
    ids = ",".join(str(i) for i in range(group))
    line = (f"  %c = f32[1024,8]{{1,0}} {kind}(f32[1024,8]{{1,0}} %x), "
            f"replica_groups={{{{{ids}}}}}")
    ref = JH.collective_bytes(line)
    assert ref["counts"][kind] == 1
    assert roofline.ring_bytes(kind, 1024 * 8 * 4, group) == ref[kind]


def test_roofline_terms_on_the_h100():
    t = roofline.roofline_terms({"flops": 989e12, "bytes accessed": 6.7e12},
                                {"total": 45e9}, 8)
    assert t["t_compute_s"] == 1.0 and t["t_memory_s"] == 2.0
    assert t["t_collective_s"] == 0.1 and t["dominant"] == "memory"
    with pytest.raises(ValueError):
        roofline.ring_bytes("broadcast", 8, 2)


# ------------------------------------------------------------ the counter

def _count(fn, *args, device="meta"):
    with op_cost.OpCounter(device=device) as c:
        fn(*args)
    c.close()
    return c


def test_matmul_flops_equal_the_hlo_model_exactly():
    """``tests/test_hlo_cost.py``'s single matmul."""
    x = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    ref = analyze_hlo(jax.jit(lambda a, b: a @ b).lower(x, x).compile()
                      .as_text())["flops"]
    a = torch.empty((256, 256), device="meta")
    c = _count(lambda: a @ a)
    assert c.flops == ref == 2 * 256 ** 3
    assert c.ops == 1
    assert c.bytes == 3 * 256 * 256 * 4


def test_flops_scale_with_loops_and_the_backward():
    a = torch.empty((256, 256), device="meta")
    one = 2 * 256 ** 3

    def loop(n):
        x = a
        for _ in range(n):
            x = x @ a
        return x

    assert _count(loop, 10).flops == 10 * one
    assert _count(lambda: [loop(5) for _ in range(4)]).flops == 20 * one

    w = torch.empty((256, 256), device="meta", requires_grad=True)

    def loss():
        h = a
        for _ in range(8):
            h = torch.tanh(h @ w)
        torch.autograd.grad(torch.sum(h ** 2), w)

    # forward, and the backward's two products a layer (the first layer's
    # input needs no gradient, as in the reference's count)
    assert _count(loss).flops == (8 + 2 * 8 - 1) * one

    x = torch.empty((1024, 128), device="meta")

    def adds():
        y = x
        for _ in range(50):
            y = y + 1.0
    assert _count(adds).bytes == 50 * 2 * 1024 * 128 * 4


def test_peak_on_a_hand_built_sequence():
    """Allocations rounded to 512 bytes, freed as they die; views and
    in-place ops allocate nothing; ``track`` counts what was there."""
    base = torch.empty((100,), device="meta")             # 400 -> 512
    with op_cost.OpCounter() as c:
        assert c.track(base) == 512
        a = torch.empty((1000,), device="meta")           # 4000 -> 4096
        b = a * 2                                         # 4096
        v = b.view(10, 100)                               # a view
        b.add_(1.0)                                       # in place
        assert c.live == 512 + 2 * 4096
        del a
        assert c.live == 512 + 4096
        d = torch.empty((3,), dtype=torch.bfloat16, device="meta")  # 512
        assert c.peak == 512 + 2 * 4096
        del b
        assert c.live == 512 + 4096 + 512                 # v keeps b's
        del v
        assert c.live == 512 + 512
        e = torch.empty((4096,), device="meta")           # 16384
        del e
        assert c.peak == 512 + 512 + 16384 and c.live == 1024
    c.close()
    del d


def _reduced_step(device):
    cfg = reduced_config("zamba2-2.7b")
    key = prng.PRNGKey(0, device) if device != "meta" else None
    params = T.init_params(key, cfg, device=device)
    d = T.param_count(params)
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.int64,
                                   device=device),
             "labels": torch.ones((2, 64), dtype=torch.int64,
                                  device=device)}
    pf = PFELSConfig(num_clients=1000, clients_per_round=1,
                     compression_ratio=0.5, epsilon=4.0, local_lr=0.1,
                     local_steps=1, channel=scaled_channel(d))
    step = make_pfels_train_step(cfg, pf, d)
    k = prng.PRNGKey(3, device)
    c = op_cost.OpCounter(device=device)
    start = c.track(params, batch, k)
    with c:
        step(params, batch, k)
    c.close()
    return c, start


def test_peak_is_the_same_on_meta_and_on_the_cpu():
    """One reduced zamba2-2.7b step: the meta run (the clip kernel's meta
    route) and the CPU run (its plain version) hold the same live bytes
    at their peak, and the same arguments."""
    meta, meta_start = _reduced_step("meta")
    cpu, cpu_start = _reduced_step("cpu")
    assert meta_start == cpu_start > 0
    assert meta.peak == cpu.peak > meta_start
    assert meta.kernels["clip_norm"]["launches"] == 1
    assert "clip_norm" not in cpu.kernels   # the CPU ran the plain version


# ---------------------------------------------------- wrappers on meta

def _wrapper_cases():
    f32, bf16 = torch.float32, torch.bfloat16

    def t(shape, dtype=f32, device="cpu"):
        if dtype in (torch.int32, torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.ones(shape, dtype=dtype, device=device)

    r, d, m = 3, 300, 2
    rows, k_rows = 9, 4
    idx = [0, 3, 5, 8]
    b, s, h, p, n, chunk = 1, 64, 2, 32, 32, 32
    return [
        ("client_sumsq", pfels_kernel.client_sumsq,
         lambda dev: (t((r, d), device=dev),), {},
         pfels_kernel.sumsq_work(r, d)),
        ("fused_combine", pfels_kernel.fused_combine,
         lambda dev: (t((r, d), device=dev), t((d,), device=dev),
                      t((d,), device=dev), t((r, m), device=dev),
                      t((r,), device=dev), t((r,), device=dev)), {},
         pfels_kernel.combine_work(r, d, m)),
        ("clip_norm", clip_kernel.clip_norm,
         lambda dev: (t((rows, 128), bf16, dev), 1.0), {},
         clip_kernel.work(rows * 128, 2)),
        ("randk_gather", gather_kernel.randk_gather,
         lambda dev: (t((rows, 128), device=dev),
                      torch.tensor(idx, dtype=torch.int32, device=dev), 0.5),
         {}, gather_kernel.work(k_rows, 4)),
        ("aircomp_combine", comb_kernel.aircomp_combine,
         lambda dev: (t((rows, 128), device=dev), t((k_rows, 128),
                                                    device=dev),
                      torch.tensor(idx, dtype=torch.int32, device=dev),
                      0.25), {}, comb_kernel.work(k_rows, 4)),
        ("ssd_scan", ssd_kernel.ssd_scan,
         lambda dev: (t((b, s, h, p), device=dev), t((b, s, h), device=dev),
                      -t((h,), device=dev), t((b, s, n), device=dev),
                      t((b, s, n), device=dev)), {"chunk": chunk},
         ssd_kernel.work(b, s, h, p, n, chunk, 4)),
        ("flash_attention_fwd", flash_kernel.flash_attention_fwd,
         lambda dev: (t((2, 40, 4, 64), bf16, dev),
                      t((2, 48, 2, 64), bf16, dev),
                      t((2, 48, 2, 64), bf16, dev)),
         {"causal": True, "window": 16},
         flash_kernel.work(2, 40, 48, 4, 2, 64, 16, 2, True)),
    ]


@pytest.mark.parametrize("case", _wrapper_cases(), ids=lambda c: c[0])
def test_wrappers_on_meta_return_the_plain_shapes_and_charge_their_work(
        case):
    name, fn, make, kw, (n_bytes, flops) = case
    plain = fn(*make("cpu"), **kw)
    args = make("meta")
    with op_cost.OpCounter() as c:
        out = fn(*args, **kw)
    c.close()
    plain = plain if isinstance(plain, tuple) else (plain,)
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(x.shape), x.dtype) for x in out] == \
        [(tuple(x.shape), x.dtype) for x in plain]
    assert all(x.device.type == "meta" for x in out)
    assert c.kernels == {name: {"launches": 1, "flops": flops,
                                "bytes": n_bytes}}
    assert c.flops == flops and c.bytes == n_bytes
    # no counter entered: the meta route charges nothing and counts no
    # launch (only a CUDA launch does)
    fn(*make("meta"), **kw)
    assert all(sum(mod.LAUNCHES.values()) == 0 for mod in (
        pfels_kernel, clip_kernel, gather_kernel, comb_kernel, ssd_kernel,
        flash_kernel))


def test_flash_work_counts_the_pairs_the_mask_keeps():
    # causal, Sq == Skv: the triangle; no mask: every pair; a window
    _, f = flash_kernel.work(1, 4, 4, 1, 1, 8, None, 4, True)
    assert f == 4.0 * 8 * (1 + 2 + 3 + 4)
    _, f = flash_kernel.work(1, 4, 6, 1, 1, 8, None, 4, False)
    assert f == 4.0 * 8 * 24
    _, f = flash_kernel.work(1, 4, 4, 1, 1, 8, 2, 4, True)
    assert f == 4.0 * 8 * (1 + 2 + 2 + 2)


def test_route_refuses_mixed_and_other_devices():
    assert _route.route(torch.zeros(2)) == "cpu"
    assert _route.route(torch.zeros(2, device="meta")) == "meta"
    with pytest.raises(ValueError, match="several devices"):
        _route.route(torch.zeros(2), torch.zeros(2, device="meta"))
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        _route.route(other)


# ---------------------------------------------------------------- moe

@pytest.mark.parametrize("seed", [0, 1])
def test_moe_expert_counts_equal_bincount(seed):
    """``_routing_plan``'s fixed-length counts (the reference's
    ``bincount(length=e)``) equal ``torch.bincount``'s, and it runs on
    meta."""
    rng = np.random.default_rng(seed)
    e, cap = 6, 5
    top_e = torch.from_numpy(rng.integers(0, e - 1, (17, 3)))
    plan = tmoe._routing_plan(top_e, e, cap)
    counts = torch.bincount(top_e.reshape(-1), minlength=e)
    assert torch.equal(plan["slot_valid"].sum(1),
                       torch.clamp_max(counts, cap))
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(top_e.reshape(-1), stable=True)
    pos = torch.argsort(order) - starts[top_e.reshape(-1)]
    assert torch.equal(plan["keep"], pos < cap)
    meta = tmoe._routing_plan(top_e.to("meta"), e, cap)
    assert meta["tok_idx"].shape == (e, cap)


# ------------------------------------------------------------- the dry run

@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_dryrun_one_on_the_reduced_families(arch):
    cfg = reduced_config(arch)
    mesh = make_host_mesh()
    for shape in SMALL_SHAPES:
        rec = dryrun.dryrun_one(arch, shape, mesh=mesh, cfg=cfg,
                                verbose=False)
        mem = rec["memory"]
        assert rec["device"] == "meta" and rec["n_chips"] == 1
        assert rec["n_params"] == T.param_count(T.init_shapes(cfg))
        assert mem["peak_bytes_per_device"] == (
            mem["argument_bytes_one_device"] + mem["temp_bytes"])
        assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
        assert rec["fits"] and rec["useful_flops_ratio"] > 0
        assert rec["roofline"]["flops_per_device"] == rec["cost"]["flops"]
        kernels = rec["kernels"]
        if shape.kind == "train":
            assert kernels["clip_norm"]["launches"] == 1
            assert rec["per_device_batch"] == 8
        elif shape.kind == "prefill":
            # the serving path's kernels, one a layer that has one
            assert kernels.get("flash_attention_fwd", {}).get(
                "launches", 0) + kernels.get("ssd_scan", {}).get(
                "launches", 0) >= 2
        json.dumps(rec)


def test_dryrun_multi_pod_train_is_the_client_step():
    """On a mesh with two pods the train step carries one client a pod,
    each on its own rows."""
    from repro_torch.launch.mesh import MeshShape
    cfg = reduced_config("mamba2-130m")
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 1))
    rec = dryrun.dryrun_one("mamba2-130m", SMALL_SHAPES[0], mesh=mesh,
                            cfg=cfg, verbose=False)
    assert rec["n_clients"] == 2 and rec["per_device_batch"] == 2
    assert rec["kernels"]["clip_norm"]["launches"] == 2
    one = dryrun.dryrun_one("mamba2-130m", SMALL_SHAPES[0],
                            mesh=make_host_mesh(), cfg=cfg, verbose=False)
    assert rec["memory"]["argument_bytes_one_device"] > \
        one["memory"]["argument_bytes_one_device"]


def test_reference_defaults_of_the_dry_run():
    from repro_torch.configs import get_config
    assert dryrun.grad_accum(get_config("qwen2-vl-72b"), False) == 4
    assert dryrun.grad_accum(get_config("zamba2-2.7b"), False) == 2
    assert dryrun.grad_accum(get_config("granite-moe-3b-a800m"), True) == 4
    assert dryrun.grad_accum(get_config("qwen3-moe-30b-a3b"), True) == 8
    pf = dryrun.default_pfels(get_config("phi3-mini-3.8b"),
                              make_host_mesh((2, 16, 16),
                                             ("pod", "data", "model")))
    assert (pf.compression_ratio, pf.epsilon, pf.num_clients,
            pf.clients_per_round, pf.local_steps) == (0.3, 1.5, 1000, 2, 1)


def test_cohort_dry_run_and_the_cli(tmp_path):
    rec = dryrun.dryrun_cohort(clients_per_round=32, world=512,
                               verbose=False)
    assert rec["device"] == "meta" and rec["d"] == 26122
    assert rec["mesh"] == {"pod": 4, "data": 8} and rec["shards"] == 32
    assert rec["memory"]["peak_bytes_per_device"] > 0
    dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    out = json.loads((tmp_path / "whisper-tiny__long_500k__pod.json")
                     .read_text())
    assert out["mesh"] == {"data": 16, "model": 16}
    assert out["kernels"]["flash_attention_fwd"]["launches"] >= 1
    with pytest.raises(SystemExit):
        dryrun.main(["--out", str(tmp_path)])


def test_per_device_rows_follow_the_batch_spec():
    cfg = reduced_config("phi3-mini-3.8b")
    mesh = make_host_mesh((4, 1))
    rec = dryrun.dryrun_one("phi3-mini-3.8b", SMALL_SHAPES[0], mesh=mesh,
                            cfg=cfg, verbose=False)
    assert rec["per_device_batch"] == 2
    rec = dryrun.dryrun_one("phi3-mini-3.8b", SMALL_SHAPES[3], mesh=mesh,
                            cfg=cfg, verbose=False)
    assert rec["per_device_batch"] == 1     # batch 1 stays whole
