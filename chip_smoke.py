#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, as the port's check
    python3 chip_smoke.py --profile      # and a profiled extra round

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, and TF32 switched off for
   matmuls and cuDNN convolutions (cuDNN defaults to TF32).
2. ``build``: nvcc builds the kernels from ``src/repro_torch/csrc``.
3. ``kernels``: each hand-written kernel against its plain torch version
   on the card, at the main-path shape (r = 32, d = 9,222,858) and at
   ragged small shapes; run twice for bit-identity; timed with CUDA
   events beside its memory bound, the plain version and a one-call
   PyTorch yardstick where one exists.
4. ``main_path``: the port's ``Trainer.run`` of PFELS on the paper's
   VGG-11 (d = 9,222,858) with N = 1000 clients of 50 CIFAR-size
   synthetic images, r = 32, tau = 5, transmit clip 0.25, fused kernels,
   3 rounds. Launch counters are zeroed just before and read just after.
5. ``parity_on_card``: the golden problem (BENCH_MLP, 2 rounds) fused
   (kernels) against unfused (plain torch), and against the committed
   reference digests.

Then the kernel summary line, the ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is non-zero; without a CUDA device it exits 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 rate and f32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MAIN_R, MAIN_D = 32, 9_222_858


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.pfels_transmit import kernel
    t0 = time.perf_counter()
    paths = _build.build([kernel.SOURCE])
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.BUILD_LOGS.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libraries": [os.path.relpath(p, ROOT) for p in paths],
          "ptxas": ptxas})


def _kernel_inputs(r, d, m_ant, seed, txm_zero):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    u = 0.01 * torch.randn((r, d), generator=g, device=dev)
    mask = (torch.rand((d,), generator=g, device=dev) < 0.3).float()
    z = torch.randn((d,), generator=g, device=dev) * mask
    gains = 1e-3 + 0.1 * torch.rand((r, m_ant), generator=g, device=dev)
    tx = 1.0 + 100.0 * torch.rand((r,), generator=g, device=dev)
    txm = torch.ones((r,), device=dev)
    if txm_zero:
        txm[r // 2] = 0.0
    return u, mask, z, gains, tx, txm


def _rel(a, b):
    import torch
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_kernels_at(r, d, m_ant, seed, txm_zero, timed):
    """One shape: both kernels against their plain versions, twice for
    bit-identity, and (if ``timed``) their times."""
    import torch
    from repro_torch.kernels.pfels_transmit import kernel, ref
    u, mask, z, gains, tx, txm = _kernel_inputs(r, d, m_ant, seed, txm_zero)

    s_k = kernel.client_sumsq(u)
    s_k2 = kernel.client_sumsq(u)
    s_p = ref.client_sumsq_ref(u)
    y_k, e_k = kernel.fused_combine(u, mask, z, gains, tx, txm)
    y_k2, e_k2 = kernel.fused_combine(u, mask, z, gains, tx, txm)
    y_p, e_p = ref.fused_combine_ref(u, mask, z, gains, tx, txm)
    torch.cuda.synchronize()

    # tolerances: f32 sums in another order than the plain version's;
    # 1e-5 relative is ~100 ulp, far above reordering error at r <= 32
    sum_rel = float(((s_k - s_p).abs() / s_p.abs().clamp_min(1e-30)).max())
    y_atol = 1e-5 * float(y_p.abs().max())
    y_ok = bool(torch.allclose(y_k, y_p, rtol=1e-5, atol=y_atol))
    e_rel = abs(float(e_k) - float(e_p)) / max(abs(float(e_p)), 1e-30)
    line = {"phase": "kernels", "r": r, "d": d, "M": m_ant,
            "txm_zero": txm_zero,
            "client_sumsq": {"max_rel_err": sum_rel,
                             "max_abs_err": float((s_k - s_p).abs().max()),
                             "bit_identical": bool(torch.equal(s_k, s_k2))},
            "fused_combine": {"y_max_abs_err": float((y_k - y_p).abs().max()),
                              "y_rel_to_max": _rel(y_k, y_p),
                              "energy_rel_err": e_rel,
                              "bit_identical": bool(torch.equal(y_k, y_k2)
                                                    and torch.equal(e_k,
                                                                    e_k2))},
            "tolerance": "sums and energy: 1e-5 relative; y: rtol 1e-5, "
                         "atol 1e-5 * max|y|"}
    failures = []
    if not sum_rel <= 1e-5:
        failures.append("client_sumsq disagrees with its plain version")
    if not (y_ok and e_rel <= 1e-5):
        failures.append("fused_combine disagrees with its plain version")
    if not line["client_sumsq"]["bit_identical"]:
        failures.append("client_sumsq is not bit-identical run to run")
    if not line["fused_combine"]["bit_identical"]:
        failures.append("fused_combine is not bit-identical run to run")

    summary = {}
    if timed:
        f32 = 4
        b_sumsq, op_sumsq = (r * d + r) * f32, 2.0 * r * d
        b_comb = (r * d + 3 * d + r * m_ant + 2 * r + 1) * f32
        op_comb = 6.0 * r * d
        sumsq_bound, sumsq_by = bound_ms(b_sumsq, op_sumsq)
        comb_bound, comb_by = bound_ms(b_comb, op_comb)
        times = {
            "client_sumsq": time_ms(lambda: kernel.client_sumsq(u)),
            "client_sumsq_plain": time_ms(lambda: ref.client_sumsq_ref(u)),
            "client_sumsq_library": time_ms(
                lambda: torch.linalg.vector_norm(u, dim=1)),
            "fused_combine": time_ms(lambda: kernel.fused_combine(
                u, mask, z, gains, tx, txm)),
            "fused_combine_plain": time_ms(lambda: ref.fused_combine_ref(
                u, mask, z, gains, tx, txm)),
        }
        line["times_ms"] = times
        line["bound_ms"] = {"client_sumsq": sumsq_bound,
                            "fused_combine": comb_bound}
        line["bytes"] = {"client_sumsq": b_sumsq, "fused_combine": b_comb}
        summary = {
            "client_sumsq": {
                "max_abs_err": line["client_sumsq"]["max_abs_err"],
                "ms": times["client_sumsq"],
                "plain_ms": times["client_sumsq_plain"],
                "bound_ms": sumsq_bound, "bound_by": sumsq_by,
                "library_ms": times["client_sumsq_library"]},
            "fused_combine": {
                "max_abs_err": line["fused_combine"]["y_max_abs_err"],
                "ms": times["fused_combine"],
                "plain_ms": times["fused_combine_plain"],
                "bound_ms": comb_bound, "bound_by": comb_by,
                # no single PyTorch call computes y and E together
                "library_ms": None}}
    emit(line)
    del u, mask, z, gains, tx, txm
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def phase_kernels():
    for r, d, m_ant, txm_zero in ((1, 4100, 4, False), (3, 4100, 4, True),
                                  (4, 26_122, 1, False)):
        check_kernels_at(r, d, m_ant, seed=r, txm_zero=txm_zero, timed=False)
    return check_kernels_at(MAIN_R, MAIN_D, 1, seed=7, txm_zero=False,
                            timed=True)


def profile_round(trainer, state, x, y):
    """One more round under ``torch.profiler``: device busy time against
    the round's wall time, and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    emit({"phase": "profile", "round_wall_s": wall,
          "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall if wall > 0 else None,
          "top_kernels": [{"name": k[:120], "calls": c, "device_ms": t / 1e3}
                          for t, c, k in rows[:25]]})


def phase_main_path(profile: bool):
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import Trainer
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.models import cnn

    cfg_m = PAPER_VGG11_CIFAR10
    rounds = 3
    t0 = time.perf_counter()
    params = cnn.init_cnn(prng.PRNGKey(0), cfg_m)
    d = sum(p.numel() for p in params.values())
    x, y, xt, yt = make_federated_classification(
        prng.PRNGKey(0), n_clients=1000, per_client=50, num_classes=10,
        image_shape=(3, 32, 32))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # PFELSConfig defaults (N = 1000, r = 32, tau = 5, eta = 0.05, C1 = 1,
    # p = 0.3, eps = 1.5), transmit clip eta tau C1, fused kernels
    cfg = PFELSConfig(transmit_clip=0.25, use_fused_kernel=True,
                      channel=scaled_channel(d))
    loss_fn = lambda p, b: cnn.cnn_loss(p, cfg_m, b)
    trainer = Trainer(cfg, loss_fn, params)
    state = trainer.init(prng.PRNGKey(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    marks = [time.perf_counter()]

    def on_round(t, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    kernel.reset_launch_counts()
    end, metrics = trainer.run(state, x, y, rounds=rounds, on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    test_loss, test_acc = trainer.evaluate(end, xt, yt)

    m = {k: [float(v) for v in metrics[k]] for k in metrics}
    finite = all(math.isfinite(v) for vs in m.values() for v in vs)
    eps_ok = all(v <= cfg.epsilon for v in m["eps_round"])
    line = {"phase": "main_path", "model": cfg_m.name, "d": d,
            "k": int(m["subcarriers"][0]), "n_clients": cfg.num_clients,
            "r": cfg.clients_per_round, "tau": cfg.local_steps,
            "data_bytes": x.numel() * x.element_size(),
            "setup_s": setup_s, "rounds": rounds,
            "round_wall_s": [b - a for a, b in zip(marks, marks[1:])],
            "peak_memory_bytes": peak, "launches": launches,
            "train_loss": m["train_loss"], "beta": m["beta"],
            "energy": m["energy"], "eps_round": m["eps_round"],
            "update_norm": m["update_norm"],
            "test_loss": test_loss, "test_acc": test_acc,
            "ledger_totals": trainer.ledger_totals(end),
            "finite": finite}
    emit(line)
    failures = []
    if d != MAIN_D:
        failures.append(f"VGG-11 has d={d}, expected {MAIN_D}")
    for name, n in launches.items():
        if n != rounds:
            failures.append(f"{name} launched {n} times in {rounds} rounds")
    if not finite:
        failures.append("non-finite metric")
    if not eps_ok:
        failures.append("eps_round above the per-round budget")
    if failures:
        raise AssertionError("; ".join(failures))
    if profile:
        profile_round(trainer, end, x, y)
    del x, y, xt, yt, end, state, trainer
    torch.cuda.empty_cache()
    return launches


def _golden_digests(use_fused_kernel: bool):
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import BENCH_MLP, PFELSConfig
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import Trainer, replace
    from repro_torch.models import cnn
    from repro_torch.tree import ravel

    def digest(a):
        a = np.asarray(a.detach().cpu(), np.float64)
        return [float(a.sum()), float(np.abs(a).sum()), float((a * a).sum())]

    key = prng.PRNGKey(0)
    params = cnn.init_cnn(key, BENCH_MLP)
    x, y, _, _ = make_federated_classification(
        key, n_clients=20, per_client=20, num_classes=10,
        image_shape=(1, 8, 8))
    cfg = PFELSConfig(num_clients=20, clients_per_round=4, local_steps=2,
                      local_lr=0.05, compression_ratio=0.3, epsilon=2.0,
                      rounds=2, use_fused_kernel=use_fused_kernel)
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, BENCH_MLP, b),
                      params)
    state = replace(trainer.init(prng.PRNGKey(1)), key=prng.PRNGKey(2))
    end, metrics = trainer.run(state, x, y, rounds=2)
    torch.cuda.synchronize()
    out = {"params": digest(ravel(end.params)),
           "prev_delta": digest(end.prev_delta)}
    for k in ("train_loss", "update_norm", "beta", "energy", "eps_round"):
        out[k] = [float(v) for v in metrics[k]]
    return out


def _max_rel_gap(a, b):
    gaps = []
    for k in b:
        for u, v in zip(a[k], b[k]):
            gaps.append(abs(u - v) / max(abs(v), 1e-12))
    return max(gaps)


def phase_parity():
    from repro_torch.kernels.pfels_transmit import kernel
    kernel.reset_launch_counts()
    fused = _golden_digests(True)
    fused_launches = dict(kernel.LAUNCHES)
    unfused = _golden_digests(False)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "golden_digests.json")) as f:
        golden = json.load(f)["cases"]
    gaps = {"fused_vs_unfused": _max_rel_gap(fused, unfused)}
    for name, got in (("pfels-fused", fused), ("pfels-unfused", unfused)):
        g = golden[name]
        want = {"params": g["params"], "prev_delta": g["prev_delta"],
                **{k: g["metrics"][k] for k in ("train_loss", "update_norm",
                                                "beta", "energy",
                                                "eps_round")}}
        gaps[f"{name}_vs_reference"] = _max_rel_gap(got, want)
    emit({"phase": "parity_on_card", "problem": "golden BENCH_MLP, 2 rounds",
          "fused_launches": fused_launches, "max_rel_gap": gaps,
          "tolerance": {"fused_vs_unfused": 1e-5, "vs_reference": 1e-4}})
    failures = []
    if fused_launches["fused_combine"] != 2:
        failures.append("the fused run did not go through fused_combine")
    if not gaps["fused_vs_unfused"] <= 1e-5:
        failures.append("fused and unfused runs disagree")
    for name in ("pfels-fused", "pfels-unfused"):
        if not gaps[f"{name}_vs_reference"] <= 1e-4:
            failures.append(f"{name} digests disagree with the reference")
    if failures:
        raise AssertionError("; ".join(failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path round after the "
                         "checked ones (device busy time, time by kernel)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    summary = phase_kernels()
    launches = phase_main_path(args.profile)
    phase_parity()
    from repro_torch.kernels.pfels_transmit import kernel
    source = "src/repro_torch/csrc/pfels_transmit.cu"
    replaces = {"client_sumsq":
                "src/repro/kernels/pfels_transmit/kernel.py:90",
                "fused_combine":
                "src/repro/kernels/pfels_transmit/kernel.py:107"}
    emit({"kernels": [
        {"name": f"pfels_transmit.{name}", "route": "cuda",
         "source": source, "replaces": replaces[name],
         "launches": launches[name], **summary[name]}
        for name in kernel.LAUNCHES]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
