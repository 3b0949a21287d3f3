#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, as the port's check
    python3 chip_smoke.py --profile      # and profiled extra runs
    python3 chip_smoke.py --time-ssd     # only ssd_scan's and a warm
                                         # zamba2-2.7b prefill's times

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, and TF32 switched off for
   matmuls and cuDNN convolutions (cuDNN defaults to TF32).
2. ``build``: nvcc builds the kernels from ``src/repro_torch/csrc``, one
   process per source, all started together.
3. ``kernels``: each hand-written kernel against its plain torch version
   on the card, at its main-path shapes and at ragged small shapes; run
   twice for bit-identity; timed with CUDA events beside its bound, the
   plain version and a one-call PyTorch yardstick where one exists. The
   PFELS pair at r = 32, d = 9,222,858; ``ssd_scan`` at small shapes and
   ragged chunks (1 to 100 rows) in f32 (CUDA cores) and bf16 (tensor
   cores; also on misaligned views, which must equal their aligned
   copies, and at P = N = 128), the bf16 route held to the bound derived
   from its split operands against the plain version and against
   ``ref.split_bf16_route``, the emulation of its rounding; then timed
   (warm and cold L2) at zamba2-2.7b's (B 8, S 2048, H 80, P 64, N 64)
   and mamba2-130m's (H 24, N 128) prefill, with its ``ptxas`` registers
   and spills and its shared memory a block;
   ``flash_attention_fwd`` at zamba2-2.7b's (B 8, S 2048, H = Hkv = 32,
   Dh 80) in bf16 (tensor cores) and f32 (CUDA cores), beside
   ``scaled_dot_product_attention``, with TFLOP/s, the share of the bound
   and the bf16 kernel's ``ptxas`` registers and spills; ``clip_norm``,
   ``randk_gather`` and ``aircomp_combine`` at ragged small shapes (f32
   and bf16, the combine with duplicate rows too; the clip and the
   combine also on views off 16-byte alignment), the clip at 268 MB
   (above L2), and at the VGG-11 update padded to 72,054 rows of 128
   lanes, with the 21,616 rand-k rows of p = 0.3, where the device
   kernels of one clip and one combine call are counted (1 each).
4. ``main_path``: the port's ``Trainer.run`` of PFELS on the paper's
   VGG-11 (d = 9,222,858) with N = 1000 clients of 50 CIFAR-size
   synthetic images, r = 32, tau = 5, transmit clip 0.25, fused kernels,
   3 rounds. Launch counters are zeroed just before and read just after.
5. ``kernel_api``: the path of the three row kernels, the public kernel
   API (``clip_flat``, ``row_indices_from_coords``, ``gather_rows``,
   ``combine``), once at VGG-11 width as one transmit and combine;
   counters zeroed just before and read just after; checked against the
   same chain through the plain versions.
6. ``baselines``: ``Trainer.run`` of WFL-P, WFL-PDP, DP-FedAvg, FedAvg and
   PFELS with error feedback at the main path's config, 2 rounds each:
   s/round, peak memory, metrics and every kernel's launches (the EF run
   holds the 36.9 GB residual bank, freed before the serve phases);
   ``--profile`` adds one profiled round of each.
7. ``parity_on_card``: the golden problem (BENCH_MLP, 2 rounds) fused
   (kernels) against unfused (plain torch), and the PFELS, baseline and
   error-feedback runs against the committed reference digests.
8. ``conv_parity_on_card``: the port's convolutions with cuDNN's flags at
   PyTorch's defaults around the phase (TF32 on), so that the package's
   own scoping is what is checked: one local step's gradient at
   BENCH_CNN_CIFAR's and VGG-11's widths against the CPU (and without
   the scope, to show the check sees TF32), two rounds of
   BENCH_CNN_CIFAR at the default config against the CPU route as
   digests, and one VGG-11 round repeated bit for bit, beside the same
   round without the package's scope under ``phase_device``'s flags (TF32
   off, nondeterministic algorithms allowed): whether that repeats, and
   what the deterministic algorithms cost in wall and device time.
9. ``serve_parity_on_card``: reduced zamba2-2.7b and mamba2-130m in f32,
   prefill and 8 greedy decode steps on the card (kernels) against the
   same params on the CPU (plain versions); and the reduced zamba2-2.7b's
   bf16 prefill, card against CPU, within 3% of max|logit|.
10. ``serve``: ``repro_torch.launch.serve.serve`` of zamba2-2.7b at full
   width (batch 8, prompt 2048, 64 new tokens, bf16, random weights from
   seed 0), then of mamba2-130m; launch counters zeroed just before each
   and read just after (45 ``ssd_scan`` and 9 ``flash_attention_fwd`` for
   zamba2); prefill s, decode tok/s, peak memory, finite logits and
   in-vocabulary tokens; then three warm zamba2-2.7b prefills and one
   more under the profiler: its device time, and each LLM kernel's device
   ms and share of it.

``--time-ssd`` runs the device phase and then only times ``ssd_scan`` at
the two serving prefills (bf16, warm and cold L2) and three warm
zamba2-2.7b prefills plus one profiled, and prints no result line. It
uses only what every tree of the port has: copy this script into a parent
commit's checkout (``git archive``) and run it there and here in turns,
in one call, to compare the two.

Then the kernel summary line, the ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is non-zero; without a CUDA device it exits 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
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


def _kernel_modules():
    """The kernel wrapper modules, one per CUDA source."""
    from repro_torch.kernels.aircomp_combine import kernel as comb_kernel
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.kernels.randk_gather import kernel as gather_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    return (kernel, ssd_kernel, flash_kernel, clip_kernel, gather_kernel,
            comb_kernel)


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


def cold_ms(fn, reps: int = 20, warmup: int = 3,
            flush_bytes: int = 512 * 2 ** 20) -> float:
    """Median CUDA-event time of one call that finds the 50 MB L2 cold:
    before each call the card writes ``flush_bytes`` of scratch, which
    evicts the cache and keeps the card busy while the host enqueues the
    call, so the pair of events times the device work and not the host's
    time before the launch."""
    import torch
    flush = torch.empty((flush_bytes // 4,), dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
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
    t0 = time.perf_counter()
    paths = _build.build([mod.SOURCE for mod in _kernel_modules()])
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.BUILD_LOGS.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libraries": [os.path.relpath(p, ROOT) for p in paths],
          "ptxas": ptxas})


def _kernel_inputs(r, d, m_ant, seed, txm_zero, density=0.3):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    u = 0.01 * torch.randn((r, d), generator=g, device=dev)
    mask = (torch.rand((d,), generator=g, device=dev) < density).float()
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


def check_kernels_at(r, d, m_ant, seed, txm_zero, timed, density=0.3):
    """One shape: both kernels against their plain versions, twice for
    bit-identity, and (if ``timed``) their times. ``density`` is the
    support's share of d: 0.3 for PFELS, 1 for WFL-P and WFL-PDP."""
    import torch
    from repro_torch.kernels.pfels_transmit import kernel, ref
    u, mask, z, gains, tx, txm = _kernel_inputs(r, d, m_ant, seed, txm_zero,
                                                density)

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
            "txm_zero": txm_zero, "support_share": density,
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
# chunks of 1, 4, 8, 40 and 100 rows (prefill_chunk gives a prompt of S
# <= 128 the chunk S, and halves 128 until it divides S), N = 128
SSD_RAGGED = ((1, 8, 2, 32, 32, 1), (2, 100, 3, 64, 64, 4),
              (2, 48, 2, 64, 128, 8), (2, 120, 2, 64, 32, 40),
              (1, 100, 2, 32, 64, 100))
# P = N = 128 at chunk 128: the bf16 route's 1-stage ring (the f32
# route's shared memory refuses it)
SSD_WIDE = (1, 256, 2, 128, 128, 128)
# flash attention: (B, Sq, Skv, H, Hkv, Dh, window) at zamba2-2.7b's
# prefill, and ragged small shapes (GQA, Sq < Skv, a window)
FLASH_ZAMBA2 = (8, 2048, 2048, 32, 32, 80, None)
FLASH_SMALL = ((1, 100, 100, 4, 4, 64, None), (2, 130, 130, 8, 2, 80, None),
               (1, 50, 77, 4, 2, 64, None), (1, 200, 200, 4, 4, 80, 37),
               (1, 300, 300, 2, 2, 96, None), (1, 190, 250, 2, 2, 128, 64),
               (1, 257, 257, 2, 1, 160, 100))
# a mid-size shape at zamba2-2.7b's row length (GQA), where the bf16
# route is also held to its emulated rounding
FLASH_MID = (1, 2048, 2048, 4, 2, 80, None)
# tolerances against the plain versions, relative to the largest value:
# ssd_scan sums up to 128 terms per chunk and carries a recurrence over
# 16 chunks in another order than the plain einsums (measured 7e-6)
SSD_TOL = 5e-5
# ssd_scan's bf16 route (tensor cores) splits each f32 operand (G, H, W)
# into bf16 halves, off the operand by at most 2^-18 of it, so y moves by
# at most 2^-18 y_abs and the state by 2^-18 state_abs (the abs-value
# sums of ref.split_bf16_route: |C| |B|^T o L o dt against |x|, twice
# exp(cum) |C| Habs^T); held to twice that plus the f32 route's SSD_TOL
# of max|plain| for the sums' order (the cumsum's above all). Against the
# emulation of its rounding (the kernel's cumsum order, the same halves of
# nearly the same operands), element by element with no relative-to-max
# term: where the two sides' f32 operands differ in their last bits their
# halves round apart, so each side's residual counts (2 x 2^-18), and the
# orders of their f32 sums add sqrt(256) 2^-24 of the same sums each:
# 5 x 2^-19 y_abs.
SSD_SPLIT_PLAIN = 2.0 ** -17
SSD_SPLIT_EMULATED = 5 * 2.0 ** -19
# flash attention, |kernel - plain (f32)| <= rel |plain| + abs_of * max|x|:
# f32 (CUDA cores) sums in another order: 1e-5 |plain| + 1e-5 max|plain|.
# bf16 (tensor cores) rounds P to bf16 before P V, as the reference's
# serving attention does: each p in (0, 1] moves by at most 2^-9 of
# itself, and l sums the unrounded p, so |sum_j dp_j v_j| / l <= 2^-9
# max|v|; the output's own rounding adds 2^-9 |out| at most. Twice that
# bound: 2^-7 |plain| + 2^-8 max|v| (x = v). At the small and mid-size
# shapes the bf16 output is also held, element by element, to the
# emulation of the route's rounding (ref.tensor_core_route, plain torch
# ops on the card beside the plain version; TF32 off): 2 bf16 ulps,
# plus ulp(p) |v| / l for each p near enough to a rounding midpoint that
# the card may round it the other way, plus 2^-18 max|v|.
FLASH_TOL = {"float32": (1e-5, 1e-5, "plain"),
             "bfloat16": (2 ** -7, 2 ** -8, "v")}


def _ssd_inputs(b, s, h, p, n, dtype, seed, misaligned=False):
    """x, dt, a, B, C on the card. With ``misaligned``, x, B and C are
    views into one buffer laid out as the model's projection (x, then B,
    then C along a row), with a row of odd length and a start one
    element past a 16-byte boundary: the bf16 route loads them element
    by element."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device="cuda") - 2.0)
    a = -torch.exp(0.5 * torch.randn((h,), generator=g, device="cuda"))
    bm = (torch.randn((b, s, n), generator=g, device="cuda") / 4).to(dtype)
    cm = (torch.randn((b, s, n), generator=g, device="cuda") / 4).to(dtype)
    if misaligned:
        row = h * p + 2 * n + 1
        buf = torch.zeros((b * s * row + 1,), dtype=dtype, device="cuda")
        xbc = buf[1:].view(b, s, row)
        xbc[..., :h * p] = x.reshape(b, s, h * p)
        xbc[..., h * p:h * p + n] = bm
        xbc[..., h * p + n:h * p + 2 * n] = cm
        x = xbc[..., :h * p].view(b, s, h, p)
        bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:h * p + 2 * n]
        assert x.data_ptr() % 16 != 0
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


def _ssd_ratio(err, limit):
    return float((err / limit).max())


def check_ssd_at(shape, dtype_name, seed, timed, misaligned=False):
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ref
    b, s, h, p, n, chunk = shape
    dtype = getattr(torch, dtype_name)
    args = _ssd_inputs(b, s, h, p, n, dtype, seed, misaligned)
    y1, s1 = kernel.ssd_scan(*args, chunk=chunk)
    y2, s2 = kernel.ssd_scan(*args, chunk=chunk)
    y_p, s_p = ref.ssd_chunked(*args, chunk)
    torch.cuda.synchronize()
    y_err, s_err = (y1 - y_p).abs(), (s1 - s_p).abs()
    y_max, s_max = float(y_p.abs().max()), float(s_p.abs().max())
    bit = bool(torch.equal(y1, y2) and torch.equal(s1, s2))
    line = {"phase": "kernels", "kernel": "ssd_scan",
            "shape": {"B": b, "S": s, "H": h, "P": p, "N": n,
                      "chunk": chunk}, "dtype": dtype_name,
            "misaligned_views": misaligned,
            "y_max_abs_err": float(y_err.max()),
            "y_rel_to_max": float(y_err.max()) / max(y_max, 1e-30),
            "state_max_abs_err": float(s_err.max()),
            "state_rel_to_max": float(s_err.max()) / max(s_max, 1e-30),
            "bit_identical": bit}
    failures = []
    if dtype == torch.bfloat16:
        y_e, s_e, y_abs, s_abs = ref.split_bf16_route(*args, chunk)
        y_lim = SSD_SPLIT_PLAIN * y_abs + SSD_TOL * y_max
        s_lim = SSD_SPLIT_PLAIN * s_abs + SSD_TOL * s_max
        emu = (_ssd_ratio((y1 - y_e).abs(), SSD_SPLIT_EMULATED * y_abs),
               _ssd_ratio((s1 - s_e).abs(), SSD_SPLIT_EMULATED * s_abs))
        plain = (_ssd_ratio(y_err, y_lim), _ssd_ratio(s_err, s_lim))
        line.update({
            "route": "tensor cores (mma.sync, split operands; cp.async)",
            "y_err_over_limit": plain[0], "state_err_over_limit": plain[1],
            "y_emulated_err_over_limit": emu[0],
            "state_emulated_err_over_limit": emu[1],
            "tolerance": f"|kernel - plain| <= {SSD_SPLIT_PLAIN} abs + "
                         f"{SSD_TOL} max|plain|; |kernel - "
                         f"ref.split_bf16_route| <= {SSD_SPLIT_EMULATED} "
                         f"abs"})
        if misaligned:
            # the same arithmetic from contiguous copies (16-byte loads)
            y_c, s_c = kernel.ssd_scan(*(t.contiguous() for t in args),
                                       chunk=chunk)
            line["equal_to_aligned_copies"] = bool(
                torch.equal(y1, y_c) and torch.equal(s1, s_c))
            if not line["equal_to_aligned_copies"]:
                failures.append(f"ssd_scan {shape}: misaligned views and "
                                f"their aligned copies differ")
            del y_c, s_c
        del y_e, s_e, y_abs, s_abs, y_lim, s_lim
        if not max(plain) <= 1.0:
            failures.append(f"ssd_scan {shape} disagrees with its plain "
                            f"version")
        if not max(emu) <= 1.0:
            failures.append(f"ssd_scan {shape} departs from the emulated "
                            f"rounding of its route")
    else:
        line.update({"route": "CUDA cores",
                     "tolerance": f"y and state: {SSD_TOL} of max|plain|"})
        if not (line["y_rel_to_max"] <= SSD_TOL
                and line["state_rel_to_max"] <= SSD_TOL):
            failures.append(f"ssd_scan {shape} disagrees with its plain "
                            f"version")
    summary = None
    if timed:
        n_bytes, flops = ssd_work(b, s, h, p, n, chunk, dtype.itemsize)
        peak = (PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16
                else PEAK_F32_FLOP_PER_S)
        bound, by = bound_ms(n_bytes, flops, peak)
        run = lambda: kernel.ssd_scan(*args, chunk=chunk)
        times = {"kernel": time_ms(run), "kernel_cold": cold_ms(run),
                 "plain": time_ms(lambda: ref.ssd_chunked(*args, chunk),
                                  reps=5)}
        line.update({
            "times_ms": times, "bytes": n_bytes, "flops": flops,
            "bound_ms": {"inputs_type": bound, "inputs_type_by": by,
                         "bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                         "f32_cuda_cores": flops / PEAK_F32_FLOP_PER_S * 1e3,
                         "bf16_tensor_cores":
                             flops / PEAK_BF16_FLOP_PER_S * 1e3},
            "share_of_bound": bound / times["kernel"],
            "shared_memory_per_block": kernel.shared_memory(chunk, p, n,
                                                            dtype),
            "library": "none: no one PyTorch call computes the SSD scan"})
        if dtype == torch.bfloat16:
            line["ptxas"] = ssd_ptxas().get((p, n))
        summary = {"max_abs_err": float(y_err.max()), "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": None}
    emit(line)
    del args, y1, y2, y_p, s1, s2, s_p, y_err, s_err
    torch.cuda.empty_cache()
    if not bit:
        failures.append(f"ssd_scan {shape} is not bit-identical run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def check_ssd_kernels():
    """The scan at the small and ragged shapes in both routes (bf16 also
    on misaligned views and at P = N = 128, chunk 128), then timed at the
    two serving prefills in bf16."""
    for i, shape in enumerate(SSD_SMALL + SSD_RAGGED):
        for dtype in ("float32", "bfloat16"):
            check_ssd_at(shape, dtype, seed=i, timed=False)
    for i, shape in enumerate((SSD_SMALL[1], SSD_RAGGED[2])):
        check_ssd_at(shape, "bfloat16", seed=20 + i, timed=False,
                     misaligned=True)
    check_ssd_at(SSD_WIDE, "bfloat16", seed=22, timed=False)
    summary = check_ssd_at(SSD_ZAMBA2, "bfloat16", seed=11, timed=True)
    check_ssd_at(SSD_MAMBA2, "bfloat16", seed=12, timed=True)
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


def check_flash_at(shape, dtype_name, seed, timed, emulate=False):
    import torch
    from repro_torch.kernels.flash_attn import kernel, ref
    b, sq, skv, h, hkv, dh, window = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, dh), generator=g, device="cuda").to(dtype)
    kept = [t.clone() for t in (q, k, v)]
    o1 = kernel.flash_attention_fwd(q, k, v, causal=True, window=window)
    o2 = kernel.flash_attention_fwd(q, k, v, causal=True, window=window)
    want = _plain_attention_by_row(q.float(), k.float(), v.float(), window)
    torch.cuda.synchronize()
    intact = all(torch.equal(x, y) for x, y in zip((q, k, v), kept))
    del kept
    err = (o1.float() - want).abs()
    rel, abs_of, of = FLASH_TOL[dtype_name]
    scale = (v if of == "v" else want).float().abs().max()
    limit = rel * want.abs() + abs_of * scale
    ok = bool((err <= limit).all())
    bit = bool(torch.equal(o1, o2))
    line = {"phase": "kernels", "kernel": "flash_attention_fwd",
            "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "Hkv": hkv,
                      "Dh": dh, "window": window, "causal": True},
            "dtype": dtype_name,
            "route": ("tensor cores (wgmma, TMA)" if dtype == torch.bfloat16
                      else "CUDA cores"),
            "max_abs_err": float(err.max()),
            "max_err_over_limit": float((err / limit).max()),
            "within_tolerance": ok, "bit_identical": bit,
            "inputs_unchanged": intact,
            "tolerance": f"|kernel - plain (f32)| <= {rel} |plain| + "
                         f"{abs_of} max|{of}|"}
    emulated = True
    if emulate:
        emu, emu_limit = ref.tensor_core_route(q, k, v, causal=True,
                                               window=window)
        emu_err = (o1.float() - emu.float()).abs()
        emulated = bool((emu_err <= emu_limit).all())
        line.update({
            "emulated_max_abs_err": float(emu_err.max()),
            "emulated_max_err_over_limit": float((emu_err / emu_limit).max()),
            "emulated_median_limit": float(emu_limit.median()),
            "within_emulated_limit": emulated,
            "emulated_tolerance": "|kernel - ref.tensor_core_route| <= 2 "
                                  "bf16 ulps + ulp(p) |v| / l over p near a "
                                  "rounding midpoint + 2^-18 max|v|"})
        del emu, emu_limit, emu_err
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
            "tflop_per_s": flops / times["kernel"] / 1e9,
            "share_of_bound": bound / times["kernel"],
            "plain_note": "the plain version one batch row at a time",
            "library": "scaled_dot_product_attention (causal, same GQA)"})
        if dtype == torch.bfloat16:
            line["ptxas"] = flash_ptxas().get(dh)
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
    if not emulated:
        failures.append(f"flash_attention_fwd {shape} departs from the "
                        f"emulated rounding of its route")
    if not bit:
        failures.append(f"flash_attention_fwd {shape} is not bit-identical "
                        f"run to run")
    if not intact:
        failures.append(f"flash_attention_fwd {shape}: q, k or v changed "
                        f"across the launches")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def _ptxas(source, entry):
    """Registers and spills of each instantiation of a kernel, from this
    process's build log of ``source`` (empty if the library was built
    earlier): ``entry`` is a regex on the mangled name whose groups are
    the template's integer arguments, the key."""
    import re
    from repro_torch.kernels import _build
    out, key = {}, None
    for ln in _build.BUILD_LOGS.get(source, "").splitlines():
        m = re.search(entry, ln)
        if m:
            key = tuple(int(v) for v in m.groups())
            key = key[0] if len(key) == 1 else key
            out.setdefault(key, {})
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[key]["registers_at_entry"] = int(m.group(1))
            key = None
    return out


def flash_ptxas():
    """The flash tensor-core kernel's registers and spills at each Dh."""
    return _ptxas("flash_attn", r"flash_fwd_tc_kernelILi(\d+)E")


def ssd_ptxas():
    """The ssd_scan tensor-core kernel's registers and spills at each
    (P, N)."""
    return _ptxas("ssd_scan", r"ssd_scan_tc_kernelILi(\d+)ELi(\d+)E")


# clip_norm, randk_gather, aircomp_combine: the paper's VGG-11 update
# padded to whole 128-lane rows (9,222,912 = 72,054 rows), and the rows of
# rand-k at p = 0.3 (k = 2,766,857 coordinates, 21,616 rows); ragged small
# shapes (rows, k_rows), k_rows = 1 among them
VGG_ROWS = -(-MAIN_D // 128)
MAIN_K = round(0.3 * MAIN_D)
ROW_SMALL = ((37, 1), (300, 77), (513, 513))
# tolerances against the plain versions: the clip's norm sums squares in
# another order (1e-6 relative), and its output is x times a scale one f32
# ulp apart at most, rounded to x's dtype (f32 1e-6, bf16 one ulp 2^-8);
# the gather and the unique-row combine round each element once, as the
# plain versions do (bit-identical); duplicate rows make the combine's
# atomics add in a varying order (one rounding per extra add)
ROW_ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -8}
CLIP_OUT_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
# clip_norm above L2's size: 2^19 rows of 128 f32 (268 MB)
CLIP_ABOVE_L2_ROWS = 2 ** 19


def _randn(shape, seed, dtype_name="float32", scale=1.0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device="cuda")).to(
        getattr(torch, dtype_name))


def _row_indices(rows, k_rows, seed):
    import torch
    from repro_torch import prng
    from repro_torch.kernels.randk_gather.ops import row_indices_from_coords
    if (rows, k_rows) == (VGG_ROWS, MAIN_K // 128):
        return row_indices_from_coords(prng.PRNGKey(seed), rows * 128,
                                       MAIN_K)
    return prng.permutation(prng.PRNGKey(seed), rows)[:k_rows].to(
        torch.int32)


def _max_rel(a, b):
    """max |a - b| / |b| over the elements, 0/0 counted as 0."""
    import torch
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return float(torch.where(diff == 0, torch.zeros_like(diff),
                             diff / b.abs()).max())


def _misaligned(t):
    """A copy of ``t`` whose start lies one element past a 16-byte
    boundary: the kernels' path for operands that vector loads and
    reductions cannot take."""
    import torch
    buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def device_kernels(fn) -> int:
    """Kernels, copies and fills the card runs for one call of ``fn``,
    counted by ``torch.profiler``."""
    return sum(c for _, c, _ in _profiled(fn)[1])


def check_clip_at(rows, dtype_name, seed, timed, misaligned=False):
    import torch
    from repro_torch.kernels.clip_norm import kernel, ref
    x = _randn((rows, 128), seed, dtype_name, scale=0.01)
    if misaligned:
        x = _misaligned(x)
    clip = 0.25
    o1, n1 = kernel.clip_norm(x, clip)
    o2, n2 = kernel.clip_norm(x, clip)
    o_p, n_p = ref.clip_norm_ref(x, clip)
    torch.cuda.synchronize()
    norm_rel = abs(float(n1) - float(n_p)) / float(n_p)
    out_rel = _max_rel(o1, o_p)
    bit = bool(torch.equal(o1, o2) and torch.equal(n1, n2))
    line = {"phase": "kernels", "kernel": "clip_norm",
            "shape": {"R": rows, "lanes": 128}, "dtype": dtype_name,
            "misaligned": misaligned,
            "clip": clip, "norm": float(n1), "norm_rel_gap": norm_rel,
            "out_max_rel_gap": out_rel,
            "out_max_abs_err": float((o1.float() - o_p.float()).abs().max()),
            "bit_identical": bit,
            "tolerance": f"norm 1e-6 relative; output "
                         f"{CLIP_OUT_TOL[dtype_name]} relative"}
    summary = None
    if timed:
        n, elem = x.numel(), x.element_size()
        bound, by = bound_ms(2 * n * elem + 4, 3.0 * n)
        fns = {"kernel": lambda: kernel.clip_norm(x, clip),
               "plain": lambda: ref.clip_norm_ref(x, clip),
               "library_first_pass": lambda: torch.linalg.vector_norm(x)}
        times = {k: time_ms(f) for k, f in fns.items()}
        line.update({"times_ms": times,
                     "cold_ms": {k: cold_ms(f) for k, f in fns.items()},
                     "bytes": 2 * n * elem + 4,
                     "device_kernels_per_call": device_kernels(
                         fns["kernel"]),
                     "library": "torch.linalg.vector_norm: the first pass "
                                "(the norm) only"})
        summary = {"max_abs_err": line["out_max_abs_err"],
                   "ms": times["kernel"], "plain_ms": times["plain"],
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": times["library_first_pass"],
                   "cold_ms": line["cold_ms"],
                   "device_kernels_per_call":
                       line["device_kernels_per_call"]}
    emit(line)
    failures = []
    if timed and line["device_kernels_per_call"] != 1:
        failures.append(f"clip_norm ran {line['device_kernels_per_call']} "
                        f"device kernels a call, expected 1")
    if not (norm_rel <= 1e-6 and out_rel <= CLIP_OUT_TOL[dtype_name]):
        failures.append(f"clip_norm R={rows} {dtype_name} disagrees with "
                        f"its plain version")
    if not bit:
        failures.append(f"clip_norm R={rows} is not bit-identical run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def check_gather_at(rows, k_rows, dtype_name, seed, timed):
    import torch
    from repro_torch.kernels.randk_gather import kernel, ref
    delta = _randn((rows, 128), seed, dtype_name, scale=0.01)
    idx = _row_indices(rows, k_rows, seed)
    scale = torch.tensor(37.5, device="cuda")     # beta / |h_i|
    o1 = kernel.randk_gather(delta, idx, scale)
    o2 = kernel.randk_gather(delta, idx, scale)
    o_p = ref.randk_gather_ref(delta, idx, scale)
    torch.cuda.synchronize()
    same = bool(torch.equal(o1, o_p))
    bit = bool(torch.equal(o1, o2))
    line = {"phase": "kernels", "kernel": "randk_gather",
            "shape": {"R": rows, "k_rows": k_rows, "lanes": 128},
            "dtype": dtype_name, "bit_identical_to_plain": same,
            "max_abs_err": float((o1.float() - o_p.float()).abs().max()),
            "bit_identical": bit, "tolerance": "bit-identical"}
    summary = None
    if timed:
        elem = delta.element_size()
        n_bytes = 2 * k_rows * 128 * elem + 4 * k_rows + elem
        bound, by = bound_ms(n_bytes, 1.0 * k_rows * 128)
        fns = {"kernel": lambda: kernel.randk_gather(delta, idx, scale),
               "plain": lambda: ref.randk_gather_ref(delta, idx, scale)}
        times = {k: time_ms(f) for k, f in fns.items()}
        line.update({"times_ms": times,
                     "cold_ms": {k: cold_ms(f) for k, f in fns.items()},
                     "bytes": n_bytes,
                     "library": "none: no one PyTorch call gathers and "
                                "scales"})
        summary = {"max_abs_err": line["max_abs_err"], "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": None,
                   "cold_ms": line["cold_ms"]}
    emit(line)
    failures = []
    if not same:
        failures.append(f"randk_gather {rows}x{k_rows} {dtype_name} "
                        f"disagrees with its plain version")
    if not bit:
        failures.append(f"randk_gather {rows}x{k_rows} is not bit-identical "
                        f"run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def check_combine_at(rows, k_rows, dtype_name, seed, timed,
                     duplicates=False, misaligned=False):
    import torch
    from repro_torch.kernels.aircomp_combine import kernel, ref
    theta = _randn((rows, 128), seed, dtype_name)
    y = _randn((k_rows, 128), seed + 1, dtype_name, scale=0.01)
    # the kernel's copies of theta, and y, start off 16-byte alignment
    copy = _misaligned if misaligned else torch.clone
    if misaligned:
        y = _misaligned(y)
    if duplicates:
        g = torch.Generator(device="cuda").manual_seed(seed)
        idx = torch.randint(0, rows, (k_rows,), generator=g, device="cuda",
                            dtype=torch.int32)
    else:
        idx = _row_indices(rows, k_rows, seed)
    inv = 1.0 / (MAIN_R * 0.05)
    o1 = kernel.aircomp_combine(copy(theta), y, idx, inv)
    o2 = kernel.aircomp_combine(copy(theta), y, idx, inv)
    o_p = ref.aircomp_combine_ref(theta, y, idx, inv)
    torch.cuda.synchronize()
    err = float((o1.float() - o_p.float()).abs().max())
    mult = int(torch.bincount(idx.long(), minlength=rows).max())
    if duplicates:
        tol = mult * ROW_ULP[dtype_name] * float(o_p.float().abs().max())
        ok, bit = err <= tol, None
        tolerance = (f"{mult} (the largest multiplicity) x "
                     f"{ROW_ULP[dtype_name]} x max|theta|")
    else:
        ok = bool(torch.equal(o1, o_p))
        bit = bool(torch.equal(o1, o2))
        tolerance = "bit-identical"
    line = {"phase": "kernels", "kernel": "aircomp_combine",
            "shape": {"R": rows, "k_rows": k_rows, "lanes": 128},
            "dtype": dtype_name, "duplicates": duplicates,
            "misaligned": misaligned,
            "max_multiplicity": mult, "max_abs_err": err,
            "within_tolerance": ok, "bit_identical": bit,
            "tolerance": tolerance}
    summary = None
    if timed:
        elem = theta.element_size()
        n_bytes = 3 * k_rows * 128 * elem + 4 * k_rows + elem
        bound, by = bound_ms(n_bytes, 2.0 * k_rows * 128)
        work = theta.clone()
        idx_long = idx.long()
        fns = {"kernel": lambda: kernel.aircomp_combine(work, y, idx, inv),
               "plain": lambda: ref.aircomp_combine_ref(theta, y, idx, inv),
               "library": lambda: work.index_add_(0, idx_long, y,
                                                  alpha=inv)}
        times = {k: time_ms(f) for k, f in fns.items()}
        line.update({"times_ms": times,
                     "cold_ms": {k: cold_ms(f) for k, f in fns.items()},
                     "bytes": n_bytes,
                     "device_kernels_per_call": device_kernels(
                         fns["kernel"]),
                     "plain_note": "index_add_ on a clone of theta",
                     "library": "torch.Tensor.index_add_(0, idx, y, "
                                "alpha=inv), in place"})
        summary = {"max_abs_err": err, "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": times["library"],
                   "cold_ms": line["cold_ms"],
                   "device_kernels_per_call":
                       line["device_kernels_per_call"]}
    emit(line)
    failures = []
    if timed and line["device_kernels_per_call"] != 1:
        failures.append(f"aircomp_combine ran "
                        f"{line['device_kernels_per_call']} device kernels "
                        f"a call, expected 1")
    if not ok:
        failures.append(f"aircomp_combine {rows}x{k_rows} {dtype_name} "
                        f"(duplicates {duplicates}) disagrees with its plain "
                        f"version")
    if bit is False:
        failures.append(f"aircomp_combine {rows}x{k_rows} is not "
                        f"bit-identical run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def check_row_kernels():
    """The three row kernels at ragged small shapes in f32 and bf16
    (the combine with duplicate rows too; the clip and the combine also
    on operands off 16-byte alignment), the clip above L2's size, then
    timed at the VGG-11 shapes in f32 with the device kernels of one call
    counted."""
    for i, (rows, k_rows) in enumerate(ROW_SMALL):
        for dtype in ("float32", "bfloat16"):
            check_clip_at(rows, dtype, seed=i, timed=False)
            check_gather_at(rows, k_rows, dtype, seed=i, timed=False)
            check_combine_at(rows, k_rows, dtype, seed=i, timed=False)
            check_combine_at(rows, 4 * k_rows, dtype, seed=i, timed=False,
                             duplicates=True)
            check_clip_at(rows, dtype, seed=i, timed=False, misaligned=True)
            check_combine_at(rows, k_rows, dtype, seed=i, timed=False,
                             misaligned=True)
            check_combine_at(rows, 4 * k_rows, dtype, seed=i, timed=False,
                             duplicates=True, misaligned=True)
    # x of 268 MB, above the 50 MB L2: the second read comes from HBM
    check_clip_at(CLIP_ABOVE_L2_ROWS, "float32", seed=20, timed=False)
    k_rows = MAIN_K // 128
    return {"clip_norm": check_clip_at(VGG_ROWS, "float32", seed=21,
                                       timed=True),
            "randk_gather": check_gather_at(VGG_ROWS, k_rows, "float32",
                                            seed=22, timed=True),
            "aircomp_combine": check_combine_at(VGG_ROWS, k_rows, "float32",
                                                seed=23, timed=True)}


def phase_kernels():
    for r, d, m_ant, txm_zero in ((1, 4100, 4, False), (3, 4100, 4, True),
                                  (4, 26_122, 1, False)):
        check_kernels_at(r, d, m_ant, seed=r, txm_zero=txm_zero, timed=False)
    summary = check_kernels_at(MAIN_R, MAIN_D, 1, seed=7, txm_zero=False,
                               timed=True)
    # the full support of WFL-P and WFL-PDP (k = d): the same bytes
    check_kernels_at(MAIN_R, MAIN_D, 1, seed=8, txm_zero=False, timed=True,
                     density=1.0)
    summary["ssd_scan"] = check_ssd_kernels()
    for i, shape in enumerate(FLASH_SMALL):
        for dtype in ("float32", "bfloat16"):
            check_flash_at(shape, dtype, seed=i, timed=False,
                           emulate=dtype == "bfloat16")
    check_flash_at(FLASH_MID, "bfloat16", seed=len(FLASH_SMALL), timed=False,
                   emulate=True)
    summary["flash_attention_fwd"] = check_flash_at(
        FLASH_ZAMBA2, "bfloat16", seed=13, timed=True)
    # the f32 route (CUDA cores) at the same shape, for its time
    check_flash_at(FLASH_ZAMBA2, "float32", seed=14, timed=True)
    summary.update(check_row_kernels())
    return summary


def _profiled(fn):
    """``fn()`` under ``torch.profiler``: its wall seconds, and (device us,
    calls, name) of every kernel, copy and fill the card ran."""
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
    return wall, rows


def profile_call(label: str, fn, top: int = 25):
    """``fn()`` under ``torch.profiler``: device busy time against the
    call's wall time, and device time by kernel name. Returns the emitted
    line with every kernel's (device ms, calls, name) under ``all``."""
    wall, rows = _profiled(fn)
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    line = {"phase": "profile", "what": label, "wall_s": wall,
            "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall if wall > 0 else None,
            "top_kernels": [{"name": k[:120], "calls": c,
                             "device_ms": t / 1e3}
                            for t, c, k in rows[:top]]}
    emit(line)
    line["all"] = [(t / 1e3, c, k) for t, c, k in rows]
    return line


def profile_round(trainer, state, x, y):
    profile_call("one more main-path round",
                 lambda: trainer.step(state, x, y))


def profile_serve(arch: str = "zamba2-2.7b", batch: int = 8,
                  prompt_len: int = 2048, steps: int = 8):
    """Three full-width prefills of ``arch`` (the serve phase's shapes)
    on the host clock, then one more prefill and ``steps`` decode steps,
    each under the profiler (no decode steps with ``steps=0``). Returns
    the prefill's profile line and the three prefills' seconds: unlike
    ``serve``'s first prefill, these run warm."""
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

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_prefill()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    pre = profile_call(f"{arch} prefill, batch {batch}, prompt "
                       f"{prompt_len}", run_prefill)
    if steps:
        profile_call(f"{arch} {steps} decode steps, batch {batch}",
                     run_decode)
    del params, box
    torch.cuda.empty_cache()
    return pre, warm


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


def phase_kernel_api():
    """The reference's public kernel API, the path that reaches the three
    row kernels (no round of either package calls them), driven once at
    the paper's VGG-11 width as one transmit and combine: ``clip_flat`` of
    a client update, ``row_indices_from_coords`` of its rand-k rows,
    ``gather_rows`` of the clipped update at beta/|h|, ``combine`` of the
    payload into the model. The launch counters are zeroed just before
    and read just after; the same chain through the plain versions is the
    check."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10
    from repro_torch.kernels.aircomp_combine import kernel as comb_kernel
    from repro_torch.kernels.aircomp_combine.ops import combine
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.kernels.clip_norm.ops import clip_flat
    from repro_torch.kernels.randk_gather import kernel as gather_kernel
    from repro_torch.kernels.randk_gather.ops import (gather_rows,
                                                      row_indices_from_coords)
    from repro_torch.models import cnn
    from repro_torch.tree import ravel

    d_pad = VGG_ROWS * 128
    theta = torch.nn.functional.pad(
        ravel(cnn.init_cnn(prng.PRNGKey(0), PAPER_VGG11_CIFAR10)),
        (0, d_pad - MAIN_D))
    delta = _randn((MAIN_D,), 31, scale=0.01)
    key, r, beta, gain = prng.PRNGKey(3), MAIN_R, 0.05, 0.02
    mods = (clip_kernel, gather_kernel, comb_kernel)

    def chain(use_kernel):
        clipped, nrm = clip_flat(delta, 0.25, use_kernel=use_kernel)
        idx = row_indices_from_coords(key, d_pad, MAIN_K)
        payload = gather_rows(
            torch.nn.functional.pad(clipped, (0, d_pad - MAIN_D)), idx,
            beta / gain, use_kernel=use_kernel)
        return clipped, nrm, idx, payload, combine(
            theta, payload, idx, r, beta, use_kernel=use_kernel)

    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    clipped, nrm, idx, payload, new_theta = chain(True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    p_clipped, p_nrm, _, p_payload, p_theta = chain(False)
    torch.cuda.synchronize()
    touched = torch.zeros((VGG_ROWS,), dtype=torch.bool, device="cuda")
    touched[idx.long()] = True
    rows_moved = (new_theta.reshape(VGG_ROWS, 128)
                  != theta.reshape(VGG_ROWS, 128)).any(dim=1)
    line = {"phase": "kernel_api", "d": MAIN_D, "d_padded": d_pad,
            "k": MAIN_K, "k_rows": int(idx.numel()), "r": r, "beta": beta,
            "gain": gain, "wall_s": wall, "launches": launches,
            "norm": float(nrm), "norm_rel_gap": abs(float(nrm) - float(p_nrm))
            / float(p_nrm),
            "clipped_max_rel_gap": _max_rel(clipped, p_clipped),
            "payload_max_rel_gap": _max_rel(payload, p_payload),
            "theta_max_abs_err": float((new_theta - p_theta).abs().max()),
            "finite": bool(torch.isfinite(new_theta).all()),
            "only_support_rows_moved": bool(not (rows_moved
                                                 & ~touched).any()),
            "tolerance": "norm, clipped and payload 1e-6 relative; theta "
                         "1e-6 of max|theta|"}
    emit(line)
    failures = []
    if launches != {"clip_norm": 1, "randk_gather": 1, "aircomp_combine": 1}:
        failures.append(f"the kernel API launched {launches}")
    if idx.numel() != MAIN_K // 128 or new_theta.shape != (d_pad,):
        failures.append("unexpected shapes")
    if not (line["finite"] and line["only_support_rows_moved"]):
        failures.append("bad output of combine")
    if not (line["norm_rel_gap"] <= 1e-6
            and line["clipped_max_rel_gap"] <= 1e-6
            and line["payload_max_rel_gap"] <= 1e-6
            and line["theta_max_abs_err"]
            <= 1e-6 * float(p_theta.abs().max())):
        failures.append("the kernel chain disagrees with the plain chain")
    del theta, delta, clipped, payload, new_theta, p_clipped, p_payload
    del p_theta
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# the paper's comparators at the main path's config, 2 rounds each; the
# launches each should make: the fused AirComp round launches
# fused_combine once, and client_sumsq once unless error feedback applies
# the transmit clip itself (in plain torch); the digital schemes neither
BASELINE_RUNS = (
    ("wfl_p", {}, {"client_sumsq": 1, "fused_combine": 1}),
    ("wfl_pdp", {}, {"client_sumsq": 1, "fused_combine": 1}),
    ("dp_fedavg", {}, {"client_sumsq": 0, "fused_combine": 0}),
    ("fedavg", {}, {"client_sumsq": 0, "fused_combine": 0}),
    ("pfels", {"error_feedback": True},
     {"client_sumsq": 0, "fused_combine": 1}),
)


def phase_baselines(profile: bool):
    """``Trainer.run`` of each of the paper's comparators (and PFELS with
    error feedback) at the main path's config on VGG-11, 2 rounds each:
    s/round, peak memory, the metrics and the launches of every kernel;
    with ``profile``, one more round of each under the profiler."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import Trainer
    from repro_torch.models import cnn

    cfg_m = PAPER_VGG11_CIFAR10
    rounds = 2
    params = cnn.init_cnn(prng.PRNGKey(0), cfg_m)
    d = sum(p.numel() for p in params.values())
    x, y, _, _ = make_federated_classification(
        prng.PRNGKey(0), n_clients=1000, per_client=50, num_classes=10,
        image_shape=(3, 32, 32))
    loss_fn = lambda p, b: cnn.cnn_loss(p, cfg_m, b)
    mods = _kernel_modules()
    failures = []
    for alg, extra, per_round in BASELINE_RUNS:
        cfg = PFELSConfig(algorithm=alg, transmit_clip=0.25,
                          use_fused_kernel=True, channel=scaled_channel(d),
                          **extra)
        trainer = Trainer(cfg, loss_fn, params)
        state = trainer.init(prng.PRNGKey(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]

        def on_round(t, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        for mod in mods:
            mod.reset_launch_counts()
        end, metrics = trainer.run(state, x, y, rounds=rounds,
                                   on_round=on_round)
        torch.cuda.synchronize()
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated()
        m = {k: [float(v) for v in metrics[k]] for k in metrics}
        finite = all(math.isfinite(v) for vs in m.values() for v in vs)
        want = {k: 0 for k in launches}
        want.update({k: n * rounds for k, n in per_round.items()})
        emit({"phase": "baselines", "algorithm": alg, **extra, "d": d,
              "r": cfg.clients_per_round, "tau": cfg.local_steps,
              "transmit_clip": cfg.transmit_clip, "rounds": rounds,
              "round_wall_s": [b - a for a, b in zip(marks, marks[1:])],
              "peak_memory_bytes": peak, "launches": launches,
              "subcarriers": m["subcarriers"], "train_loss": m["train_loss"],
              "beta": m["beta"], "energy": m["energy"],
              "eps_round": m["eps_round"], "update_norm": m["update_norm"],
              "ledger_totals": trainer.ledger_totals(end),
              "residuals_bytes": (0 if end.residuals is None else
                                  end.residuals.numel() * 4),
              "finite": finite})
        if launches != want:
            failures.append(f"{alg} {extra}: launched {launches}, "
                            f"expected {want}")
        if not finite:
            failures.append(f"{alg} {extra}: non-finite metric")
        if profile:
            profile_call(f"one more {alg} {extra} round",
                         lambda: trainer.step(end, x, y))
        del trainer, state, end, metrics
        torch.cuda.empty_cache()
    del x, y, params
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def _digest(a):
    import numpy as np
    a = np.asarray(a.detach().cpu(), np.float64)
    return [float(a.sum()), float(np.abs(a).sum()), float((a * a).sum())]


def _round_digests(model_cfg, params, x, y, cfg, device="cuda"):
    """Digests of ``Trainer.run`` for ``cfg.rounds`` rounds from ``params``
    and data ``x``, ``y``, all moved to ``device``, with the golden
    problem's keys (init key 1, run key 2): sum, |sum| and sum of squares
    of the params and of the last Delta_hat, and every round's metrics."""
    import torch
    from repro_torch import prng
    from repro_torch.fl import Trainer, replace
    from repro_torch.models import cnn
    from repro_torch.tree import ravel

    params = {n: t.to(device) for n, t in params.items()}
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, model_cfg, b),
                      params, device=device)
    state = replace(trainer.init(prng.PRNGKey(1, device)),
                    key=prng.PRNGKey(2, device))
    end, metrics = trainer.run(state, x.to(device), y.to(device),
                               rounds=cfg.rounds)
    if device != "cpu":
        torch.cuda.synchronize()
    out = {"params": _digest(ravel(end.params)),
           "prev_delta": _digest(end.prev_delta)}
    for k in ("train_loss", "update_norm", "beta", "energy", "eps_round"):
        out[k] = [float(v) for v in metrics[k]]
    return out


def _golden_digests(**overrides):
    from repro_torch import prng
    from repro_torch.configs import BENCH_MLP, PFELSConfig
    from repro_torch.data import make_federated_classification
    from repro_torch.models import cnn

    key = prng.PRNGKey(0)
    params = cnn.init_cnn(key, BENCH_MLP)
    x, y, _, _ = make_federated_classification(
        key, n_clients=20, per_client=20, num_classes=10,
        image_shape=(1, 8, 8))
    cfg = PFELSConfig(num_clients=20, clients_per_round=4, local_steps=2,
                      local_lr=0.05, compression_ratio=0.3, epsilon=2.0,
                      rounds=2, **overrides)
    return _round_digests(BENCH_MLP, params, x, y, cfg)


def _max_rel_gap(a, b):
    gaps = []
    for k in b:
        for u, v in zip(a[k], b[k]):
            gaps.append(abs(u - v) / max(abs(v), 1e-12))
    return max(gaps)


# the committed golden rows of the baselines and error feedback, with
# their configs (tools/update_goldens.py)
GOLDEN_ROWS = {
    "wfl_p-unfused": dict(algorithm="wfl_p", use_fused_kernel=False),
    "wfl_p-fused": dict(algorithm="wfl_p", use_fused_kernel=True),
    "wfl_pdp-unfused": dict(algorithm="wfl_pdp", use_fused_kernel=False),
    "wfl_pdp-fused": dict(algorithm="wfl_pdp", use_fused_kernel=True),
    "dp_fedavg-unfused": dict(algorithm="dp_fedavg", use_fused_kernel=False),
    "fedavg-unfused": dict(algorithm="fedavg", use_fused_kernel=False),
    "pfels-error_feedback": dict(error_feedback=True, transmit_clip=0.5,
                                 use_fused_kernel=False),
}


def phase_parity():
    from repro_torch.kernels.pfels_transmit import kernel
    kernel.reset_launch_counts()
    fused = _golden_digests(use_fused_kernel=True)
    fused_launches = dict(kernel.LAUNCHES)
    unfused = _golden_digests(use_fused_kernel=False)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "golden_digests.json")) as f:
        golden = json.load(f)["cases"]
    gaps = {"fused_vs_unfused": _max_rel_gap(fused, unfused)}
    runs = [("pfels-fused", fused), ("pfels-unfused", unfused)]
    runs += [(name, _golden_digests(**kw)) for name, kw in GOLDEN_ROWS.items()]
    for name, got in runs:
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
    for name, _ in runs:
        if not gaps[f"{name}_vs_reference"] <= 1e-4:
            failures.append(f"{name} digests disagree with the reference")
    if failures:
        raise AssertionError("; ".join(failures))


# conv_parity_on_card's tolerances, derived on the CPU by
# tests/test_torch_cnn.py with f64 convolutions (which move what summing
# in another order moves, and more) and with TF32-rounded operands in
# place of f32 ones. One local step's gradient: f64 moves it by less than
# a tenth of the limit, TF32 by more than ten times it. Two rounds of
# BENCH_CNN_CIFAR at the default config, with these keys: the same. At
# other keys a ReLU or max-pool somewhere among the 32 x 5 steps can
# switch under any f32 difference and move the digests as far as TF32
# does; the step gradient has no such switch.
CONV_GRAD_TOL = 1e-5
CONV_DIGEST_TOL = 1e-4


def _digest_gaps(a, b):
    """Per entry, the largest gap of ``a`` against ``b`` relative to
    ``b``; the sum of a vector, which cancels, against its sum of
    magnitudes."""
    gaps = {}
    for k in b:
        scale = [abs(v) for v in b[k]]
        if k in ("params", "prev_delta"):
            scale[0] = abs(b[k][1])
        gaps[k] = max(abs(u - v) / max(m, 1e-12)
                      for u, v, m in zip(a[k], b[k], scale))
    return gaps


def _pytorch_cudnn_flags(allow_tf32=True):
    """cuDNN's flags at PyTorch's defaults (TF32 on, nondeterministic
    algorithms allowed, no benchmarking), or with TF32 off as
    ``phase_device`` sets them; the caller's restored on exit."""
    import torch
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=False,
                                      allow_tf32=allow_tf32)


@contextlib.contextmanager
def _without_package_scope():
    """The port's convolutions without its ``f32_convs()`` scope, under
    whatever cuDNN flags the process holds: what the checks would see
    without the repair."""
    from repro_torch.models import cnn
    saved = cnn.f32_convs
    cnn.f32_convs = contextlib.nullcontext
    try:
        yield
    finally:
        cnn.f32_convs = saved


def _step_gradient(model_cfg, params, x, y, device):
    """The gradient of ``local_train``'s first step (read in a hook on
    each param leaf, inside the port's own scope) and its loss, on
    ``device``."""
    from repro_torch import prng
    from repro_torch.fl.client import local_train
    from repro_torch.models import cnn
    from repro_torch.tree import ravel

    grads = {}

    def loss_fn(p, batch):
        for n, t in p.items():
            t.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach()))
        return cnn.cnn_loss(p, model_cfg, batch)

    _, loss = local_train({n: t.to(device) for n, t in params.items()},
                          x.to(device), y.to(device),
                          prng.PRNGKey(5, device), loss_fn=loss_fn, steps=1,
                          lr=0.05, clip=1.0, momentum=0.9)
    return ravel({n: grads[n] for n in params}).cpu(), float(loss)


# the VGG-11 rounds of conv_parity_on_card: with the package's scope
# (True) and without it under TF32 off, as phase_device runs the process
# (False), in turns so that drift of the host falls on both; the first
# round of each warms up, and one more of each runs under the profiler
VGG_ROUND_ORDER = (True, False, False, True, True, False, False, True)


@contextlib.contextmanager
def _unscoped_tf32_off():
    with _pytorch_cudnn_flags(allow_tf32=False), _without_package_scope():
        yield


def _vgg_round(trainer, state, x, y, scoped, profiled=False):
    """One ``trainer.step`` from ``state``: the flat params, the loss, the
    host-clock seconds, and (``profiled``) the device busy seconds."""
    import torch
    from repro_torch.tree import ravel
    box = {}

    def run():
        box["out"] = trainer.step(state, x, y)

    with contextlib.nullcontext() if scoped else _unscoped_tf32_off():
        if profiled:
            wall, rows = _profiled(run)
            busy = sum(r[0] for r in rows) / 1e6
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall, busy = time.perf_counter() - t0, None
    new, metrics = box["out"]
    return ravel(new.params), metrics["train_loss"].clone(), wall, busy


def _vgg_summary(rounds):
    import torch
    p0, l0 = rounds[0][0], rounds[0][1]
    return {"bit_equal": all(torch.equal(p, p0) and torch.equal(l, l0)
                             for p, l, _, _ in rounds[1:]),
            "train_loss": float(l0),
            "round_wall_s": [w for _, _, w, _ in rounds[1:-1]],
            "profiled_round_wall_s": rounds[-1][2],
            "profiled_round_device_busy_s": rounds[-1][3]}


def phase_conv_parity():
    """The port's convolutions on the card under PyTorch's default cuDNN
    flags (TF32 on, nondeterministic algorithms allowed), so that what is
    checked is the package's own scoping and not ``phase_device``'s
    process switch:

    - one ``local_train`` step's gradient at BENCH_CNN_CIFAR's and
      VGG-11's widths, card against CPU, same params and batch; and the
      same without the package's scope (TF32 convolutions), which must
      fall outside the limit;
    - two rounds of BENCH_CNN_CIFAR at the default PFELS config, card
      against the port's CPU route, same key, as digests;
    - one VGG-11 round at the main path's config, five times from the
      same state and key: bit-equal params and losses; in turns with the
      same round without the package's scope under ``phase_device``'s
      flags (TF32 off, nondeterministic algorithms allowed): whether that
      repeats, and what the deterministic algorithms cost (round wall
      time, device busy time).
    """
    import torch
    from repro_torch import prng
    from repro_torch.configs import (BENCH_CNN_CIFAR, PAPER_VGG11_CIFAR10,
                                     PFELSConfig)
    from repro_torch.core.channel import scaled_channel
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import Trainer
    from repro_torch.models import cnn

    c = torch.backends.cudnn
    failures = []
    line = {"phase": "conv_parity_on_card"}
    with _pytorch_cudnn_flags():
        line["cudnn_flags_around"] = {
            "allow_tf32": c.allow_tf32, "deterministic": c.deterministic,
            "benchmark": c.benchmark}
        grads = {}
        for model_cfg, size in ((BENCH_CNN_CIFAR, 16),
                                (PAPER_VGG11_CIFAR10, 32)):
            params = cnn.init_cnn(prng.PRNGKey(0), model_cfg)
            x = _randn((50, 3, size, size), 41)
            g = torch.Generator(device="cuda").manual_seed(42)
            y = torch.randint(0, 10, (50,), generator=g, device="cuda")
            g_cpu, l_cpu = _step_gradient(model_cfg, params, x, y, "cpu")
            g_card, l_card = _step_gradient(model_cfg, params, x, y, "cuda")
            with _without_package_scope():
                g_tf32, _ = _step_gradient(model_cfg, params, x, y, "cuda")
            scale = float(g_cpu.abs().max())
            grads[model_cfg.name] = {
                "d": g_cpu.numel(),
                "gap_rel_to_max": float((g_card - g_cpu).abs().max())
                / scale,
                "loss_rel_gap": abs(l_card - l_cpu) / abs(l_cpu),
                "unscoped_tf32_gap_rel_to_max":
                    float((g_tf32 - g_cpu).abs().max()) / scale}
        line["step_gradient"] = grads
        for name, gp in grads.items():
            if not gp["gap_rel_to_max"] <= CONV_GRAD_TOL:
                failures.append(f"{name}: the step gradient on the card is "
                                f"{gp['gap_rel_to_max']:.3g} of max|g| off "
                                f"the CPU's")
        if not (grads[PAPER_VGG11_CIFAR10.name]
                ["unscoped_tf32_gap_rel_to_max"] > CONV_GRAD_TOL):
            failures.append("without the package's scope the VGG-11 step "
                            "gradient stays within the limit: the check "
                            "cannot see TF32")

        # two rounds of BENCH_CNN_CIFAR, PFELSConfig defaults; params and
        # data made on the card and copied, so both routes start alike
        key = prng.PRNGKey(0)
        params = cnn.init_cnn(key, BENCH_CNN_CIFAR)
        x, y, _, _ = make_federated_classification(
            key, n_clients=1000, per_client=50, num_classes=10,
            image_shape=(3, 16, 16))
        cfg = PFELSConfig(rounds=2)
        card = _round_digests(BENCH_CNN_CIFAR, params, x, y, cfg)
        cpu = _round_digests(BENCH_CNN_CIFAR, params, x.cpu(), y.cpu(), cfg,
                             device="cpu")
        gaps = _digest_gaps(card, cpu)
        line["bench_cnn_2_rounds"] = {"max_rel_gap": gaps,
                                      "train_loss_card": card["train_loss"],
                                      "train_loss_cpu": cpu["train_loss"]}
        if not max(gaps.values()) <= CONV_DIGEST_TOL:
            failures.append("BENCH_CNN_CIFAR: two rounds on the card "
                            "disagree with the CPU route")
        del x, y

        # one VGG-11 round at the main path's config, repeated
        model_cfg = PAPER_VGG11_CIFAR10
        params = cnn.init_cnn(prng.PRNGKey(0), model_cfg)
        d = sum(p.numel() for p in params.values())
        x, y, _, _ = make_federated_classification(
            prng.PRNGKey(0), n_clients=1000, per_client=50, num_classes=10,
            image_shape=(3, 32, 32))
        cfg = PFELSConfig(transmit_clip=0.25, use_fused_kernel=True,
                          channel=scaled_channel(d))
        trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, model_cfg, b),
                          params)
        state = trainer.init(prng.PRNGKey(1))
        rounds = {True: [], False: []}
        for scoped in VGG_ROUND_ORDER:
            rounds[scoped].append(_vgg_round(trainer, state, x, y, scoped))
        for scoped in (True, False):
            rounds[scoped].append(_vgg_round(trainer, state, x, y, scoped,
                                             profiled=True))
        scoped = _vgg_summary(rounds[True])
        line["vgg11_round"] = {"d": d, "repeats": len(rounds[True]),
                               "order": VGG_ROUND_ORDER, "scoped": scoped,
                               "unscoped_tf32_off":
                                   _vgg_summary(rounds[False])}
        del rounds
        if d != MAIN_D:
            failures.append(f"VGG-11 has d={d}, expected {MAIN_D}")
        if not scoped["bit_equal"]:
            failures.append("the VGG-11 round does not repeat bit for bit")
        del x, y, trainer, state
    torch.cuda.empty_cache()
    line["cudnn_flags_after"] = {"allow_tf32": c.allow_tf32,
                                 "deterministic": c.deterministic,
                                 "benchmark": c.benchmark}
    line["tolerance"] = {"step_gradient": f"{CONV_GRAD_TOL} of max|g|",
                         "bench_cnn_2_rounds": f"{CONV_DIGEST_TOL} relative"
                                               " (a sum against its sum of"
                                               " magnitudes)"}
    emit(line)
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


def phase_serve_parity_bf16():
    """Reduced zamba2-2.7b in bf16, the serving dtype: the tensor-core
    route rounds P to bf16 before P V; the prefill's logits on the card
    against the CPU's plain path within the 3% of max|logit| that
    tests/test_torch_serve.py states for bf16. It runs after ``serve``, so
    that serve's first (timed) bf16 prefill is not warmed by it."""
    from repro_torch import prng
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.models import transformer as T

    failures = []
    cfg = reduced_config("zamba2-2.7b")
    params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    toks = prng.randint(prng.PRNGKey(1, "cpu"), (4, 128), 0, cfg.vocab_size)
    flash_kernel.reset_launch_counts()
    logits = {}
    for dev in ("cuda", "cpu"):
        out, _, _ = T.prefill(_tree_to(params, dev), cfg,
                              {"tokens": toks.to(dev)}, extra_slots=0)
        logits[dev] = out.float().cpu()
        if dev == "cuda":
            launches = dict(flash_kernel.LAUNCHES)
    gap = float((logits["cuda"] - logits["cpu"]).abs().max()
                / logits["cpu"].abs().max())
    n_attn = cfg.block_pattern.count("attn") * cfg.resolved_repeat()
    emit({"phase": "serve_parity_on_card", "problem": "reduced zamba2-2.7b, "
          f"{cfg.dtype}, batch 4, prompt 128, prefill", "dtype": cfg.dtype,
          "launches_on_card": launches, "max_logit_gap_rel_to_max": gap,
          "tolerance": "logits 0.03 of max|logit|"})
    if cfg.dtype != "bfloat16":
        failures.append(f"the reduced zamba2-2.7b is {cfg.dtype}, not bf16")
    if launches != {"flash_attention_fwd": n_attn}:
        failures.append(f"bf16 prefill launched {launches}")
    if not gap <= 0.03:
        failures.append("bf16 prefill: the card and the CPU disagree")
    if failures:
        raise AssertionError("; ".join(failures))


SERVE_RUNS = (("zamba2-2.7b", {"ssd_scan": 45, "flash_attention_fwd": 9}),
              ("mamba2-130m", {"ssd_scan": 24, "flash_attention_fwd": 0}))


def prefill_split(pre):
    """The profiled prefill's wall and device time, and the device time
    and calls of each LLM kernel with its share."""
    line = {"prefill_wall_s": pre["wall_s"],
            "prefill_device_busy_s": pre["device_busy_s"]}
    for name, tag in (("flash_attention_fwd", "flash_fwd"),
                      ("ssd_scan", "ssd_scan")):
        rows = [(t, c) for t, c, k in pre["all"] if tag in k]
        ms = sum(t for t, _ in rows)
        line.update({f"{name}_device_ms": ms,
                     f"{name}_calls": sum(c for _, c in rows),
                     f"{name}_share_of_prefill_device_time":
                         ms / 1e3 / pre["device_busy_s"]})
    return line


def phase_serve(profile: bool):
    """The serving main path through ``serve``, the entry point a user
    calls, at full width; the launch counters are zeroed just before each
    call and read just after. Then one more zamba2-2.7b prefill under the
    profiler (and, with ``profile``, 8 decode steps)."""
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
    # more zamba2-2.7b prefills: three warm ones on the host clock (serve's
    # first prefill also pays first-call costs), then one under the
    # profiler: the flash kernel's device time and its share of the
    # prefill's device time
    pre, warm = profile_serve("zamba2-2.7b", batch, prompt_len,
                              steps=8 if profile else 0)
    emit({"phase": "serve", "arch": "zamba2-2.7b",
          "what": "three warm prefills, then one profiled (batch 8, "
                  "prompt 2048)",
          "prefill_warm_s": warm, **prefill_split(pre)})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches_of["zamba2-2.7b"]


def phase_ssd_timing():
    """``--time-ssd``: the scan alone at the two serving prefills (bf16,
    warm and cold L2), then three warm zamba2-2.7b prefills and one
    profiled. It uses only what every tree of the port has, so a parent
    commit is measured by copying this script into its checkout and
    running it there and here in turns, in one call."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel
    t0 = time.perf_counter()
    _build.build(["ssd_scan", "flash_attn"])
    line = {"phase": "ssd_timing", "tree": ROOT,
            "build_s": time.perf_counter() - t0}
    for i, (name, shape) in enumerate((("zamba2", SSD_ZAMBA2),
                                       ("mamba2", SSD_MAMBA2))):
        b, s, h, p, n, chunk = shape
        args = _ssd_inputs(b, s, h, p, n, torch.bfloat16, seed=11 + i)
        run = lambda: kernel.ssd_scan(*args, chunk=chunk)
        line[name] = {"shape": shape, "warm_ms": time_ms(run),
                      "cold_ms": cold_ms(run)}
        del args
        torch.cuda.empty_cache()
    pre, warm = profile_serve("zamba2-2.7b", 8, 2048, steps=0)
    line["zamba2_prefill"] = {"warm_s": warm, **prefill_split(pre)}
    emit(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path round and one more "
                         "round of each baseline after the checked ones, "
                         "and 8 zamba2-2.7b decode steps after the serve "
                         "phase's profiled prefill (device busy time, time "
                         "by kernel)")
    ap.add_argument("--time-ssd", action="store_true",
                    help="only time ssd_scan at the two serving prefills "
                         "and a warm zamba2-2.7b prefill (no checks, no "
                         "result line): the comparison with a parent tree")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    if args.time_ssd:
        phase_ssd_timing()
        print(smi, flush=True)
        return 0
    phase_build()
    summary = phase_kernels()
    launches = phase_main_path(args.profile)
    launches.update(phase_kernel_api())
    phase_baselines(args.profile)
    phase_parity()
    phase_conv_parity()
    phase_serve_parity()
    launches.update(phase_serve(args.profile))
    phase_serve_parity_bf16()
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
             "src/repro/kernels/flash_attn/kernel.py:75"),
            ("randk_gather", "randk_gather",
             "src/repro_torch/csrc/randk_gather.cu",
             "src/repro/kernels/randk_gather/kernel.py:43"),
            ("aircomp_combine", "aircomp_combine",
             "src/repro_torch/csrc/aircomp_combine.cu",
             "src/repro/kernels/aircomp_combine/kernel.py:37"),
            ("clip_norm", "clip_norm", "src/repro_torch/csrc/clip_norm.cu",
             "src/repro/kernels/clip_norm/kernel.py:36")]
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
