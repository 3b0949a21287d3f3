#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, as the port's check
    python3 chip_smoke.py --profile      # and profiled extra runs

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, and TF32 switched off for
   matmuls and cuDNN convolutions (cuDNN defaults to TF32).
2. ``build``: nvcc builds the kernels from ``src/repro_torch/csrc``, one
   process per source, all started together.
3. ``kernels``: each hand-written kernel against its plain torch version
   on the card, at its main-path shapes and at ragged small shapes; run
   twice for bit-identity; timed with CUDA events beside its bound, the
   plain version and a one-call PyTorch yardstick where one exists. The
   PFELS pair at r = 32, d = 9,222,858; ``ssd_scan`` at zamba2-2.7b's
   (B 8, S 2048, H 80, P 64, N 64) and mamba2-130m's (H 24, N 128) prefill;
   ``flash_attention_fwd`` at zamba2-2.7b's (B 8, S 2048, H = Hkv = 32,
   Dh 80), beside ``scaled_dot_product_attention``.
4. ``main_path``: the port's ``Trainer.run`` of PFELS on the paper's
   VGG-11 (d = 9,222,858) with N = 1000 clients of 50 CIFAR-size
   synthetic images, r = 32, tau = 5, transmit clip 0.25, fused kernels,
   3 rounds. Launch counters are zeroed just before and read just after.
5. ``parity_on_card``: the golden problem (BENCH_MLP, 2 rounds) fused
   (kernels) against unfused (plain torch), and against the committed
   reference digests.
6. ``serve_parity_on_card``: reduced zamba2-2.7b and mamba2-130m in f32,
   prefill and 8 greedy decode steps on the card (kernels) against the
   same params on the CPU (plain versions).
7. ``serve``: ``repro_torch.launch.serve.serve`` of zamba2-2.7b at full
   width (batch 8, prompt 2048, 64 new tokens, bf16, random weights from
   seed 0), then of mamba2-130m; launch counters zeroed just before each
   and read just after (45 ``ssd_scan`` and 9 ``flash_attention_fwd`` for
   zamba2); prefill s, decode tok/s, peak memory, finite logits and
   in-vocabulary tokens.

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

# H100 SXM data sheet: HBM3 rate, f32 (non-tensor-core) and dense bf16
# tensor-core peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

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


def bound_ms(n_bytes: float, n_flops: float,
             peak_flop_per_s: float = PEAK_F32_FLOP_PER_S):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of the inputs' type, the larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flop_per_s * 1e3
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
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    t0 = time.perf_counter()
    paths = _build.build([kernel.SOURCE, ssd_kernel.SOURCE,
                          flash_kernel.SOURCE])
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


# ssd_scan: (B, S, H, P, N, chunk) at the prefills of zamba2-2.7b and
# mamba2-130m (batch 8, prompt 2048), and ragged small shapes
SSD_ZAMBA2 = (8, 2048, 80, 64, 64, 128)
SSD_MAMBA2 = (8, 2048, 24, 64, 128, 128)
SSD_SMALL = ((1, 64, 2, 32, 32, 32), (2, 96, 3, 64, 64, 32),
             (2, 40, 2, 32, 32, 8), (1, 256, 2, 64, 128, 128))
# flash attention: (B, Sq, Skv, H, Hkv, Dh, window) at zamba2-2.7b's
# prefill, and ragged small shapes (GQA, Sq < Skv, a window)
FLASH_ZAMBA2 = (8, 2048, 2048, 32, 32, 80, None)
FLASH_SMALL = ((1, 100, 100, 4, 4, 64, None), (2, 130, 130, 8, 2, 80, None),
               (1, 50, 77, 4, 2, 64, None), (1, 200, 200, 4, 4, 80, 37))
# tolerances against the plain versions, relative to the largest value:
# ssd_scan sums up to 128 terms per chunk and carries a recurrence over
# 16 chunks in another order than the plain einsums (measured 7e-6);
# flash attention in f32 sums in another order (1e-5), and in bf16 both
# round an f32 result, so they differ by at most one bf16 ulp (2^-7)
SSD_TOL = 5e-5
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _ssd_inputs(b, s, h, p, n, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device="cuda") - 2.0)
    a = -torch.exp(0.5 * torch.randn((h,), generator=g, device="cuda"))
    bm = (torch.randn((b, s, n), generator=g, device="cuda") / 4).to(dtype)
    cm = (torch.randn((b, s, n), generator=g, device="cuda") / 4).to(dtype)
    return x, dt, a, bm, cm


def ssd_work(b, s, h, p, n, chunk, elem):
    """Bytes (each input read once, each output written once) and FLOPs
    of the scan: C B^T once per chunk (causal half), and per head the
    intra-chunk product (causal half), the carried-in term and the state
    update."""
    n_bytes = (b * s * h * p * elem + b * s * h * 4 + h * 4
               + 2 * b * s * n * elem + b * s * h * p * 4 + b * h * p * n * 4)
    nc = s // chunk
    tri = chunk * (chunk + 1) / 2
    flops = b * nc * (2 * tri * n + h * (2 * tri * p + 4 * chunk * p * n))
    return n_bytes, flops


def check_ssd_at(shape, dtype_name, seed, timed):
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ref
    b, s, h, p, n, chunk = shape
    dtype = getattr(torch, dtype_name)
    args = _ssd_inputs(b, s, h, p, n, dtype, seed)
    y1, s1 = kernel.ssd_scan(*args, chunk=chunk)
    y2, s2 = kernel.ssd_scan(*args, chunk=chunk)
    y_p, s_p = ref.ssd_chunked(*args, chunk)
    torch.cuda.synchronize()
    y_err = float((y1 - y_p).abs().max())
    s_err = float((s1 - s_p).abs().max())
    y_rel = y_err / max(float(y_p.abs().max()), 1e-30)
    s_rel = s_err / max(float(s_p.abs().max()), 1e-30)
    bit = bool(torch.equal(y1, y2) and torch.equal(s1, s2))
    line = {"phase": "kernels", "kernel": "ssd_scan",
            "shape": {"B": b, "S": s, "H": h, "P": p, "N": n,
                      "chunk": chunk}, "dtype": dtype_name,
            "y_max_abs_err": y_err, "y_rel_to_max": y_rel,
            "state_max_abs_err": s_err, "state_rel_to_max": s_rel,
            "bit_identical": bit,
            "tolerance": f"y and state: {SSD_TOL} of max|plain|"}
    summary = None
    if timed:
        n_bytes, flops = ssd_work(b, s, h, p, n, chunk, dtype.itemsize)
        peak = (PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16
                else PEAK_F32_FLOP_PER_S)
        bound, by = bound_ms(n_bytes, flops, peak)
        times = {"kernel": time_ms(lambda: kernel.ssd_scan(*args,
                                                           chunk=chunk)),
                 "plain": time_ms(lambda: ref.ssd_chunked(*args, chunk),
                                  reps=5)}
        line.update({
            "times_ms": times, "bytes": n_bytes, "flops": flops,
            "bound_ms": {"inputs_type": bound, "inputs_type_by": by,
                         "bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                         "f32_cuda_cores": flops / PEAK_F32_FLOP_PER_S * 1e3,
                         "bf16_tensor_cores":
                             flops / PEAK_BF16_FLOP_PER_S * 1e3},
            "library": "none: no one PyTorch call computes the SSD scan"})
        summary = {"max_abs_err": y_err, "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": None}
    emit(line)
    del args, y1, y2, y_p, s1, s2, s_p
    torch.cuda.empty_cache()
    failures = []
    if not (y_rel <= SSD_TOL and s_rel <= SSD_TOL):
        failures.append(f"ssd_scan {shape} disagrees with its plain version")
    if not bit:
        failures.append(f"ssd_scan {shape} is not bit-identical run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def flash_work(b, sq, skv, h, hkv, dh, window, elem):
    """Bytes (q, k, v read once, the output written once) and FLOPs of
    the causal product: the (query, key) pairs the mask keeps, a
    multiply-add over Dh for the scores and one for the values each."""
    off = skv - sq
    pairs = 0
    for i in range(sq):
        hi = i + off + 1
        lo = 0 if window is None else max(0, hi - window)
        pairs += hi - lo
    n_bytes = (2 * b * sq * h * dh + 2 * b * skv * hkv * dh) * elem
    return n_bytes, 4.0 * b * h * dh * pairs


def _plain_attention_by_row(q, k, v, window):
    """The plain version one batch row at a time (a full-shape f32 score
    tensor of every row together would take 4.3 GB)."""
    import torch
    from repro_torch.kernels.flash_attn import ref
    return torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        causal=True, window=window)
                      for i in range(q.shape[0])])


def check_flash_at(shape, dtype_name, seed, timed):
    import torch
    from repro_torch.kernels.flash_attn import kernel
    b, sq, skv, h, hkv, dh, window = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, dh), generator=g, device="cuda").to(dtype)
    o1 = kernel.flash_attention_fwd(q, k, v, causal=True, window=window)
    o2 = kernel.flash_attention_fwd(q, k, v, causal=True, window=window)
    want = _plain_attention_by_row(q.float(), k.float(), v.float(), window)
    torch.cuda.synchronize()
    err = (o1.float() - want).abs()
    tol = FLASH_TOL[dtype_name]
    ok = bool((err <= tol * want.abs() + 1e-5 * want.abs().max()).all())
    bit = bool(torch.equal(o1, o2))
    line = {"phase": "kernels", "kernel": "flash_attention_fwd",
            "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "Hkv": hkv,
                      "Dh": dh, "window": window, "causal": True},
            "dtype": dtype_name, "max_abs_err": float(err.max()),
            "within_tolerance": ok, "bit_identical": bit,
            "tolerance": f"|kernel - plain (f32)| <= {tol} |plain| + 1e-5 "
                         f"max|plain|"}
    summary = None
    if timed:
        n_bytes, flops = flash_work(b, sq, skv, h, hkv, dh, window,
                                    dtype.itemsize)
        peak = (PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16
                else PEAK_F32_FLOP_PER_S)
        bound, by = bound_ms(n_bytes, flops, peak)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times = {
            "kernel": time_ms(lambda: kernel.flash_attention_fwd(
                q, k, v, causal=True, window=window)),
            "plain": time_ms(lambda: _plain_attention_by_row(q, k, v,
                                                             window),
                             reps=5),
            "library": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=hkv != h))}
        line.update({
            "times_ms": times, "bytes": n_bytes, "flops": flops,
            "bound_ms": {"inputs_type": bound, "inputs_type_by": by,
                         "bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                         "f32_cuda_cores": flops / PEAK_F32_FLOP_PER_S * 1e3,
                         "bf16_tensor_cores":
                             flops / PEAK_BF16_FLOP_PER_S * 1e3},
            "plain_note": "the plain version one batch row at a time",
            "library": "scaled_dot_product_attention (causal, same GQA)"})
        summary = {"max_abs_err": float(err.max()), "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": times["library"]}
    emit(line)
    del q, k, v, o1, o2, want, err
    torch.cuda.empty_cache()
    failures = []
    if not ok:
        failures.append(f"flash_attention_fwd {shape} disagrees with its "
                        f"plain version")
    if not bit:
        failures.append(f"flash_attention_fwd {shape} is not bit-identical "
                        f"run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def phase_kernels():
    for r, d, m_ant, txm_zero in ((1, 4100, 4, False), (3, 4100, 4, True),
                                  (4, 26_122, 1, False)):
        check_kernels_at(r, d, m_ant, seed=r, txm_zero=txm_zero, timed=False)
    summary = check_kernels_at(MAIN_R, MAIN_D, 1, seed=7, txm_zero=False,
                               timed=True)
    for i, shape in enumerate(SSD_SMALL):
        for dtype in ("float32", "bfloat16"):
            check_ssd_at(shape, dtype, seed=i, timed=False)
    summary["ssd_scan"] = check_ssd_at(SSD_ZAMBA2, "bfloat16", seed=11,
                                       timed=True)
    check_ssd_at(SSD_MAMBA2, "bfloat16", seed=12, timed=True)
    for i, shape in enumerate(FLASH_SMALL):
        for dtype in ("float32", "bfloat16"):
            check_flash_at(shape, dtype, seed=i, timed=False)
    summary["flash_attention_fwd"] = check_flash_at(
        FLASH_ZAMBA2, "bfloat16", seed=13, timed=True)
    return summary


def profile_call(label: str, fn, top: int = 25):
    """``fn()`` under ``torch.profiler``: device busy time against the
    call's wall time, and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    emit({"phase": "profile", "what": label, "wall_s": wall,
          "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall if wall > 0 else None,
          "top_kernels": [{"name": k[:120], "calls": c, "device_ms": t / 1e3}
                          for t, c, k in rows[:top]]})


def profile_round(trainer, state, x, y):
    profile_call("one more main-path round",
                 lambda: trainer.step(state, x, y))


def profile_serve(arch: str = "zamba2-2.7b", batch: int = 8,
                  prompt_len: int = 2048, steps: int = 8):
    """One more full-width prefill and ``steps`` decode steps of ``arch``
    (the serve phase's shapes), each under the profiler."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    params = T.init_params(prng.PRNGKey(0), cfg)
    toks = prng.randint(prng.PRNGKey(1), (batch, prompt_len), 0,
                        cfg.vocab_size)
    box = {}

    def run_prefill():
        box["logits"], box["caches"], _ = T.prefill(
            params, cfg, {"tokens": toks}, extra_slots=steps)

    def run_decode():
        tok = torch.argmax(box["logits"], dim=-1)
        for _ in range(steps):
            logits, box["caches"] = T.decode_step(params, cfg, tok,
                                                  box["caches"])
            tok = torch.argmax(logits, dim=-1)

    profile_call(f"{arch} prefill, batch {batch}, prompt {prompt_len}",
                 run_prefill)
    profile_call(f"{arch} {steps} decode steps, batch {batch}", run_decode)
    del params, box
    torch.cuda.empty_cache()


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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def phase_serve_parity():
    """Reduced zamba2-2.7b and mamba2-130m in f32: prefill and 8 greedy
    decode steps on the card (kernels) against the same params and prompt
    on the CPU (plain versions)."""
    import dataclasses

    import torch
    from repro_torch import prng
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import transformer as T

    steps, tol = 8, 1e-4
    failures, lines = [], []
    for arch in ("zamba2-2.7b", "mamba2-130m"):
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                                  param_dtype="float32")
        params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
        toks = prng.randint(prng.PRNGKey(1, "cpu"), (4, 128), 0,
                            cfg.vocab_size)
        runs = {}
        ssd_kernel.reset_launch_counts()
        flash_kernel.reset_launch_counts()
        for dev in ("cuda", "cpu"):
            p = _tree_to(params, dev)
            logits, caches, _ = T.prefill(p, cfg, {"tokens": toks.to(dev)},
                                          extra_slots=steps)
            out, tok = [logits.float().cpu()], torch.argmax(logits, dim=-1)
            toks_out = [tok.cpu()]
            for _ in range(steps):
                logits, caches = T.decode_step(p, cfg, tok, caches)
                tok = torch.argmax(logits, dim=-1)
                out.append(logits.float().cpu())
                toks_out.append(tok.cpu())
            runs[dev] = (torch.stack(out), torch.cat(toks_out, dim=1))
            if dev == "cuda":
                launches = {**ssd_kernel.LAUNCHES, **flash_kernel.LAUNCHES}
        (lc, tc), (lp, tp) = runs["cuda"], runs["cpu"]
        gap = float((lc - lp).abs().max() / lp.abs().max())
        same = bool(torch.equal(tc, tp))
        lines.append({"arch": cfg.name, "launches_on_card": launches,
                      "max_logit_gap_rel_to_max": gap,
                      "greedy_tokens_equal": same})
        n_mamba = cfg.block_pattern.count("mamba") * cfg.resolved_repeat()
        n_attn = cfg.block_pattern.count("attn") * cfg.resolved_repeat()
        if launches != {"ssd_scan": n_mamba, "flash_attention_fwd": n_attn}:
            failures.append(f"{arch}: prefill launched {launches}")
        if not (gap <= tol and same):
            failures.append(f"{arch}: the card and the CPU disagree")
    emit({"phase": "serve_parity_on_card", "problem": "reduced, f32, "
          "batch 4, prompt 128, 8 greedy steps", "runs": lines,
          "tolerance": f"logits {tol} of max|logit|, tokens equal"})
    if failures:
        raise AssertionError("; ".join(failures))


SERVE_RUNS = (("zamba2-2.7b", {"ssd_scan": 45, "flash_attention_fwd": 9}),
              ("mamba2-130m", {"ssd_scan": 24, "flash_attention_fwd": 0}))


def phase_serve():
    """The serving main path through ``serve``, the entry point a user
    calls, at full width; the launch counters are zeroed just before each
    call and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers

    batch, prompt_len, new_tokens = 8, 2048, 64
    launches_of = {}
    failures = []
    for arch, want in SERVE_RUNS:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ssd_kernel.reset_launch_counts()
        flash_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        r = serve(arch, reduced=False, batch=batch, prompt_len=prompt_len,
                  new_tokens=new_tokens, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**ssd_kernel.LAUNCHES, **flash_kernel.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        vpad = layers.pad_vocab(cfg.vocab_size)
        toks = r["tokens"]
        finite = bool(torch.isfinite(r["logits"].float()).all())
        in_vocab = bool(((toks >= 0) & (toks < vpad)).all())
        shape_ok = tuple(toks.shape) == (batch, new_tokens)
        emit({"phase": "serve", "arch": arch, "batch": batch,
              "prompt_len": prompt_len, "new_tokens": new_tokens,
              "dtype": cfg.dtype, "n_layers": cfg.n_layers,
              "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
              "decode_tok_per_s": r["tok_per_s"],
              "decode_ms_per_step": r["decode_s"] / new_tokens * 1e3,
              "wall_s_with_init": wall, "peak_memory_bytes": peak,
              "launches": launches, "finite_logits": finite,
              "tokens_in_padded_vocab": in_vocab, "tokens_shape_ok": shape_ok,
              "sample_tokens": toks[0, :12].tolist()})
        if launches != want:
            failures.append(f"{arch}: launched {launches}, expected {want}")
        if not (finite and in_vocab and shape_ok):
            failures.append(f"{arch}: bad output (finite {finite}, "
                            f"in vocab {in_vocab}, shape {shape_ok})")
        launches_of[arch] = launches
        del r
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches_of["zamba2-2.7b"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path round after the "
                         "checked ones, and one more zamba2-2.7b prefill "
                         "and 8 decode steps after the serve phase "
                         "(device busy time, time by kernel)")
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
    phase_serve_parity()
    launches.update(phase_serve())
    if args.profile:
        profile_serve()
    from repro_torch.kernels.pfels_transmit import kernel
    pfels_src = "src/repro_torch/csrc/pfels_transmit.cu"
    rows = [("pfels_transmit.client_sumsq", "client_sumsq", pfels_src,
             "src/repro/kernels/pfels_transmit/kernel.py:90"),
            ("pfels_transmit.fused_combine", "fused_combine", pfels_src,
             "src/repro/kernels/pfels_transmit/kernel.py:107"),
            ("ssd_scan", "ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:71"),
            ("flash_attn.flash_attention_fwd", "flash_attention_fwd",
             "src/repro_torch/csrc/flash_attn.cu",
             "src/repro/kernels/flash_attn/kernel.py:75")]
    assert [r[1] for r in rows[:2]] == list(kernel.LAUNCHES)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[key], **summary[key]}
        for name, key, source, replaces in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
