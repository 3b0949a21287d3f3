#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, as the port's check
    python3 chip_smoke.py --profile      # and profiled extra runs
    python3 chip_smoke.py --time-ssd     # only ssd_scan's and a warm
                                         # zamba2-2.7b prefill's times
    python3 chip_smoke.py --time-rows    # only the row kernels' times
                                         # and the kernel_api chain
    python3 chip_smoke.py --time-transmit  # only the PFELS transmit
                                         # pair's times
    python3 chip_smoke.py --sharded      # only the main path, the
                                         # sharded and multi-pod phases
                                         # and the per-shard kernels

Phases, each printing one JSON line:

1. ``device``: the card, its power limit, and TF32 switched off for
   matmuls and cuDNN convolutions (cuDNN defaults to TF32).
2. ``build``: nvcc builds the kernels from ``src/repro_torch/csrc``, one
   process per source, all started together.
3. ``draws``: the port's threefry draws on the card against its CPU
   route, bit for bit (the same ops round alike on both): ``uniform``,
   ``normal`` in f32 and bf16, ``normal_fma`` and ``exponential`` at
   2^24 values; ``gamma`` and ``loggamma`` at alphas 0.1, 0.5, 1 and 3
   and ``dirichlet`` (Dirichlet(0.5) over 62 classes) at 2^18 values
   (the CPU route's rejection loops set the size: 9-25 s a draw of 2^20
   on the H100 machine's host); the Markov channel's
   gains from a 2^24-value latent and one AR(1) step of it; and XLA's
   f32 ``log1p``, ``exp``, ``erf``, ``erfc``, ``ndtr``, ``rsqrt`` and
   ``erf_inv`` (``repro_torch.prng``) on the CPU tests' stratified inputs
   (``repro_torch.xla_samples``). One line a draw with its mismatches
   and the card's and the CPU's seconds; any mismatch fails the run.
4. ``dryrun``: predictions, before the runs they predict, by
   ``repro_torch.launch.dryrun.dryrun_one`` on the meta device (a
   one-device mesh, in parallel worker processes): zamba2-2.7b's
   production step at 8 x 512 and tau = 1 and its serve prefill at
   8 x 2048, and granite-moe-3b-a800m's step at 8 x 512 at each depth
   from its 32 layers down to the deepest predicted to peak at no more
   than 70 GB, the depth its card run takes: peak bytes, FLOPs, bytes
   moved, model FLOPs, the roofline terms, the kernels' charged work.
5. ``kernels``: each hand-written kernel against its plain torch version
   on the card, at its main-path shapes and at ragged small shapes; run
   twice for bit-identity; timed with CUDA events beside its bound, the
   plain version and a one-call PyTorch yardstick where one exists. The
   PFELS pair at r = 32, d = 9,222,858, also with M = 4 and M = 8
   antenna gains and 8 of the 32 clients dropped (the scenarios'
   inputs), and at r = 8 and r = 1 with zero noise (a rank's call in the
   sharded cohort), each warm and cold (L2 flushed) beside
   ``vector_norm(u, dim=1)``, with the device kernels of one call held
   at 1; untimed at d = 1, 2 and 3 mod 4, at r = 128 and at FEMNIST's
   d = 11,189,886; one client's ``client_sumsq`` bit-equal alone, in row
   5 of 8 and in row 21 of 32; the pair's ``ptxas`` registers and
   spills; ``ssd_scan`` at small shapes and
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
   and the bf16 kernel's ``ptxas`` registers and spills; then at the MoE,
   Whisper and VLM serving shapes in both routes (the bf16 one also
   against its emulated rounding), timed the same way: with no mask
   whisper-tiny's encoder (S 1500) and cross-attention in prefill (Sq
   128) and decode (Sq 1) against 1500 frames, and a small Sq > Skv;
   causal whisper's decoder prefill, granite-moe-3b-a800m's (GQA 24/8)
   and qwen2-vl-72b's (B 4, S 2048, GQA 64/8, Dh 128) as one launch and
   as its serving path runs it (the 1024-row vision prefix against
   itself with no mask, the text rows against every key); ``clip_norm``,
   ``randk_gather`` and ``aircomp_combine`` at ragged small shapes (f32
   and bf16, the combine with duplicate rows too; all three also on
   views off 16-byte alignment, which must equal their aligned copies;
   the gather with a number and a tensor scale, at odd k_rows, with
   indices out of range (NaN rows) and on a bf16 delta of more than 2^24
   rows), the clip at 268 MB (above L2), and at the VGG-11 update padded
   to 72,054 rows of 128 lanes, with the 21,616 rand-k rows of p = 0.3,
   where the device kernels of one call of each are counted (1 each, the
   gather's with either scale), the gather also in bf16 and beside
   ``index_select`` alone (the gather without the scale), with its
   ``ptxas`` registers and spills.
6. ``main_path``: the port's ``Trainer.run`` of PFELS on the paper's
   VGG-11 (d = 9,222,858) with N = 1000 clients of 50 CIFAR-size
   synthetic images, r = 32, tau = 5, transmit clip 0.25, fused kernels,
   3 rounds. Launch counters are zeroed just before and read just after.
7. ``kernel_api``: the path of the three row kernels, the public kernel
   API (``clip_flat``, ``row_indices_from_coords``, ``gather_rows``,
   ``combine``), once at VGG-11 width as one transmit and combine;
   counters zeroed just before and read just after; checked against the
   same chain through the plain versions.
8. ``baselines``: ``Trainer.run`` of WFL-P, WFL-PDP, DP-FedAvg, FedAvg and
   PFELS with error feedback at the main path's config, 2 rounds each:
   s/round, peak memory, metrics and every kernel's launches (the EF run
   holds the 36.9 GB residual bank, freed before the serve phases);
   ``--profile`` adds one profiled round of each.
9. ``scenarios``: the golden rows' channel models, compressors and
   schedules at the main path's config, 2 rounds each: ``markov_fading``
   (rho 0.9), ``mimo_mrc`` (M = 4 and 8), ``dropout`` (0.4),
   ``top_k_ef`` (clip 0.5; the 36.9 GB residual bank, freed after),
   ``threshold`` (0.3), ``stoch_quant`` (6 bits, clip 0.5), the
   ``linear`` and ``budget`` schedules: s/round, peak memory, the
   transmit kernels' launches against those the config implies (counters
   zeroed just before each scenario's rounds, read just after), finite
   metrics, round 1 once more unfused from the same state and key (digest
   gap limit 1e-4), and for ``markov_fading`` the streamed bank's channel
   carry against the resident one's.
10. ``parity_on_card``: the golden problem (BENCH_MLP, 2 rounds) fused
   (kernels) against unfused (plain torch), and 31 committed rows (PFELS,
   the baselines, error feedback, the channel models, compressors and
   schedules, resident and streamed) against the reference's digests.
11. ``sharded``: the sharded cohort (``client_sharding="cohort"``) on 4
   gloo ranks sharing the card, each a spawned process holding the whole
   replicated state (the gloo backend takes CUDA tensors; NCCL refuses
   two ranks on one device): the seven ``*-sharded`` golden rows against
   the committed digests (limit 1e-4) and against their one-process runs
   on the card (1e-5; run before the ranks start, so that nothing else
   shares the card while the ranks run), every rank's end state equal
   byte for byte
   (sha256), ``fused_combine`` once a round on each rank of a fused row;
   then the main path's config at full width with 8 clients a rank
   (``client_sumsq`` and ``fused_combine`` at (8, d) with zero noise,
   once a round on each rank), 3 rounds: round 1's loss and update norm
   against ``main_path``'s (within 1e-6), and 3 steps each against one
   step of the one-process round from the same state (digests within
   1e-5); the 3 rounds' digests against ``main_path``'s are printed and
   not held: after round 1 a change of summation order grows through
   VGG-11's training past 1e-4. Per rank the round times,
   launches, peak memory and each round's all-reduce and all-gather
   calls, bytes and seconds (each collective timed between two
   synchronisations, so that its time includes the wait for the slowest
   rank), beside ``main_path``'s round times.
12. ``sharded`` (multi-pod): the production step with a client dim
   (``make_pfels_train_step(n_clients=2)``): the reduced mamba2-130m in
   f32 on the card against the CPU, then mamba2-130m at full width (batch
   8 x 512, 4 rows a client), 3 steps: s/step, peak memory, ``clip_norm``
   launches (2 a step: once a client a local step), finite metrics and
   params, the two clients' replicas equal.
13. ``conv_parity_on_card``: the port's convolutions with cuDNN's flags at
   PyTorch's defaults around the phase (TF32 on), so that the package's
   own scoping is what is checked: one local step's gradient at
   BENCH_CNN_CIFAR's and VGG-11's widths against the CPU (and without
   the scope, to show the check sees TF32), two rounds of
   BENCH_CNN_CIFAR at the default config against the CPU route as
   digests, and one VGG-11 round repeated bit for bit, beside the same
   round without the package's scope under ``phase_device``'s flags (TF32
   off, nondeterministic algorithms allowed): whether that repeats, and
   what the deterministic algorithms cost in wall and device time.
14. ``femnist``: the paper's second experiment, PFELS on the full-width
   ResNet-18 of FEMNIST (d = 11,189,886) with N = 1000 clients of 50
   synthetic 1x28x28 images under a Dirichlet(0.5) label skew, drawn on
   the card, 3 rounds at the main path's settings: s/round, peak memory,
   the transmit kernels' launches (3 each), finite metrics and the
   labels' skew; one more round twice from one state and key (bit-equal,
   the second profiled: device idle share and time by kernel kind); one
   local step's gradient, card against CPU.
15. ``streamed``: the streamed bank against the resident one from the
   same state and key, bit for bit: the main path's config (VGG-11,
   N = 1000, 3 rounds; both runs' s/round and peak memory), and PFELS
   with error feedback at BENCH_CNN_CIFAR's width.
16. ``train_cli``: ``python -m repro_torch.launch.train`` in a process of
   its own, with the reference's defaults for 10 rounds and at
   population scale (streamed bank, 100,000 clients); its ``--out`` JSON
   checked.
17. ``serve_parity_on_card``: reduced zamba2-2.7b, mamba2-130m,
   granite-moe-3b-a800m (6 padded experts over 4), whisper-tiny and
   qwen2-vl-72b in f32, prefill (with the f32 stub prefix of the last two),
   8 greedy decode steps and 8 sampled ones on the card (kernels) against
   the same params on the CPU (plain versions), the launches against
   those the config implies; and the reduced zamba2-2.7b's bf16 prefill,
   card against CPU, within 3% of max|logit|.
18. ``serve``: ``repro_torch.launch.serve.serve`` at full width, bf16,
   random weights from seed 0, each model freed before the next:
   zamba2-2.7b and mamba2-130m (batch 8, prompt 2048, 64 greedy tokens),
   granite-moe-3b-a800m (batch 8, prompt 2048, 64 greedy then 64 sampled
   tokens from the same params), whisper-tiny (batch 8, prompt 128, 1500
   encoder frames, 64 greedy then 64 sampled) and qwen2-vl-72b at 16 of
   its 80 layers (batch 4, prompt 2048 of which a 1024-row vision prefix,
   32 greedy tokens); launch counters zeroed just before each call and
   read just after, against those the config implies (zamba2: 45
   ``ssd_scan`` and 9 ``flash_attention_fwd``; granite 32; whisper 12 a
   prefill and 4 a decode step; qwen2-vl 32, two a layer); prefill s,
   decode tok/s, peak memory, finite logits, in-vocabulary tokens and
   the MoE prefill's drop fraction; then three warm zamba2-2.7b prefills
   (the first one's peak memory beside the dry run's prediction) and one
   more under the profiler: its device time, and each LLM kernel's
   device ms and share of it.
19. ``llm_train``: PFELS as the optimizer of one transformer that is one
   FL client (``repro_torch.launch.steps.make_pfels_train_step``). First
   one step of the reduced zamba2-2.7b in f32 on the card against the CPU
   route, at the CPU tests' tolerances. Then zamba2-2.7b at full width and
   depth (bf16, random weights from seed 0, the reference example's
   settings: p = 0.5, eps = 4, eta = 0.1, ``scaled_channel(d)``), batch 8 x
   512 tokens drawn by ``make_lm_sequences`` on the card: 3 steps at
   tau = 1 and 1 at tau = 2, s/step, peak memory, the ``clip_norm``
   launches (zeroed just before, read just after; they must equal the sum
   of tau: the clip runs once a local step over the whole gradient as one
   flat f32 buffer), finite metrics and params, and the masks' density
   within 1% of p; with ``--profile`` one more tau = 1 step profiled
   (device idle share) and its parts timed one by one; last ``clip_norm``
   at the gradient's flat size (2.9e9 f32 elements) against its plain
   version, timed beside its bound and ``vector_norm``. The tau = 1
   steps' peak (reset after the data are made) within 10% of the dry
   run's prediction; the tau = 2 step's peak beside it. Then
   granite-moe-3b-a800m's production step at full width (d_model 1536,
   40 experts top-8 padded to 48, bf16) at the dry run's depth, 3 steps
   at tau = 1 with the allocator's expandable segments: s/step, the
   peak within 10% of the prediction, the step's share of the bf16
   peak, one ``clip_norm`` launch a step, finite metrics and params, the
   masks' density within 1% of p; and one step of the reduced
   whisper-tiny and qwen2-vl-72b (with their stub audio frames and vision
   prefix) on the card against the CPU.

``--time-ssd`` runs the device phase and then only times ``ssd_scan`` at
the two serving prefills (bf16, warm and cold L2) and three warm
zamba2-2.7b prefills plus one profiled, and prints no result line. It
uses only what every tree of the port with ``launch/roofline.py`` and
the kernels' ``work`` formulas has: copy this script into a parent
commit's checkout (``git archive``) and run it there and here in turns,
in one call, to compare the two.

``--draws`` runs the device and ``draws`` phases only, and prints no
result line.

``--llm-train`` runs the device, build and dryrun phases and then only
``llm_train`` (zamba2-2.7b's steps and granite-moe-3b-a800m's at the dry
run's depth), and prints no result line: copy this script into a parent
commit's checkout and run it there and here in turns, in one call, to
compare the production step's time and peak.

``--sharded`` runs the device and build phases, the transmit pair at
the per-shard shapes, ``main_path`` and the two ``sharded`` phases, and
prints no result line: the quick check of the sharded cohort. After the
ranks have ended it also runs 3 unfused one-process rounds of the main
path's config, which differ from ``main_path`` only in the order of f32
sums, and prints their drift from ``main_path`` beside the sharded
run's, as a yardstick.

``--time-rows`` runs the device phase and then only times the three row
kernels at the VGG-11 shapes (warm and cold L2; the gather in f32 and
bf16 with a tensor and a number scale, beside ``index_select``, with the
device kernels of one call), runs the ``kernel_api`` chain three times,
and prints no result line. Like ``--time-ssd`` it uses only what every
tree of the port with the kernels' ``work`` formulas has, for the same
turns with a parent commit.

``--time-transmit`` runs the device phase and then only times the PFELS
transmit pair at its six timed shapes (r = 32 at M = 1 with support
shares 0.3 and 1, at M = 4 and 8 with 8 clients dropped; r = 8 and 1
with zero noise), warm and cold L2, beside ``vector_norm(u, dim=1)``,
with the device kernels of one call and the kernels' ``ptxas``
registers when this process built the library, and prints no result
line. Like ``--time-ssd`` it uses only what every tree of the port has
(the two wrappers and their ``*_work`` formulas), for the same turns with
a parent commit.

Then the kernel summary line (the flash row with its times at every
timed shape under ``by_shape``; the serving kernels' launches summed over
the serve runs, each run's under ``launches_by_path``; the PFELS pair's
main-path launches beside the sharded phase's, summed over the ranks,
under ``launches_by_path``, its per-shard times under ``per_shard``, warm
and cold (``cold_ms``) in each row, and its ``ptxas`` registers;
``clip_norm``'s multi-pod and granite-moe-3b-a800m step's launches), the
whole run's seconds, the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises and the
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
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the H100's constants, one copy with the dry run's (this import fails
# outside a checkout of the repository)
from repro_torch.launch.roofline import (  # noqa: E402
    PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S)

MAIN_R, MAIN_D = 32, 9_222_858
# the sharded phase's world: gloo ranks sharing the one card
SHARDED_WORLD = 4


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
            flush_bytes: int = 512 * 2 ** 20, read: bool = False) -> float:
    """Median CUDA-event time of one call that finds the 50 MB L2 cold:
    before each call the card writes ``flush_bytes`` of scratch, which
    evicts the cache and keeps the card busy while the host enqueues the
    call, so the pair of events times the device work and not the host's
    time before the launch. The written lines stay dirty in L2, so the
    call may also pay their write-back as it fills L2; with ``read`` the
    card sums the scratch instead, which leaves L2 clean."""
    import torch
    flush = torch.empty((flush_bytes // 4,), dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if read:
            flush.sum()
        else:
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


def _kernel_inputs(r, d, m_ant, seed, dropped, density=0.3,
                   zero_noise=False):
    """The transmit pair's inputs; ``dropped`` clients (every
    ``r // dropped``-th from the first) have a transmit mask of 0; with
    ``zero_noise`` z is 0, as a shard of the sharded cohort passes it."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    u = 0.01 * torch.randn((r, d), generator=g, device=dev)
    mask = (torch.rand((d,), generator=g, device=dev) < density).float()
    z = torch.randn((d,), generator=g, device=dev) * mask
    if zero_noise:
        z.zero_()
    gains = 1e-3 + 0.1 * torch.rand((r, m_ant), generator=g, device=dev)
    tx = 1.0 + 100.0 * torch.rand((r,), generator=g, device=dev)
    txm = torch.ones((r,), device=dev)
    if dropped:
        txm[::r // dropped][:dropped] = 0.0
    return u, mask, z, gains, tx, txm


def _rel(a, b):
    import torch
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# the pair's timed shapes: (label, r, d, M, dropped, support share,
# zero noise): the main path's, WFL-P's full support, the scenarios'
# antennas with 8 clients dropped, and the sharded cohort's per-shard
# calls (8 clients a rank and one)
TRANSMIT_TIMED = (
    ("main_path", MAIN_R, MAIN_D, 1, 0, 0.3, False),
    ("full_support", MAIN_R, MAIN_D, 1, 0, 1.0, False),
    ("antennas_4_dropped_8", MAIN_R, MAIN_D, 4, 8, 0.3, False),
    ("antennas_8_dropped_8", MAIN_R, MAIN_D, 8, 8, 0.3, False),
    ("per_shard_r8", MAIN_R // SHARDED_WORLD, MAIN_D, 1, 0, 0.3, True),
    ("per_shard_r1", 1, MAIN_D, 1, 0, 0.3, True))


def check_transmit_timed(labels=None):
    """``check_kernels_at``, timed, at the ``TRANSMIT_TIMED`` shapes (those
    in ``labels``, or all): their summaries by label."""
    return {label: check_kernels_at(r, d, m_ant, seed=7 + i, dropped=dropped,
                                    timed=True, density=share,
                                    zero_noise=zero)
            for i, (label, r, d, m_ant, dropped, share, zero)
            in enumerate(TRANSMIT_TIMED)
            if labels is None or label in labels}


# the device kernels one call of each of the pair runs (csrc/
# pfels_transmit.cu: one launch, the last block sums the partials)
TRANSMIT_DEVICE_KERNELS_PER_CALL = 1


def host_us(fn, reps: int = 100) -> float:
    """The host's microseconds a call of ``fn`` takes to return (the
    launch enqueued, not waited for), over ``reps`` calls in a row."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def _transmit_times(u, mask, z, gains, tx, txm, plain=False):
    """The pair's times at one shape, warm (``time_ms``: the host's time
    before the launch included) and cold (``cold_ms``: the device's
    time, L2 flushed by a write, whose dirty lines the call may write
    back; ``cold_ms_clean_l2``: flushed by a read), and the host's time
    a call, beside ``torch.linalg.vector_norm(u, dim=1)`` and
    (``plain``) the plain versions warm; the bounds and the device kernels
    of one call. It uses only the wrappers and the ``*_work`` formulas,
    which every tree of the port has."""
    import torch
    from repro_torch.kernels.pfels_transmit import kernel, ref
    r, d = u.shape
    args = (u, mask, z, gains, tx, txm)
    fns = {"client_sumsq": lambda: kernel.client_sumsq(u),
           "client_sumsq_library": lambda: torch.linalg.vector_norm(u,
                                                                    dim=1),
           "fused_combine": lambda: kernel.fused_combine(*args)}
    if plain:
        fns["client_sumsq_plain"] = lambda: ref.client_sumsq_ref(u)
        fns["fused_combine_plain"] = lambda: ref.fused_combine_ref(*args)
    work = {"client_sumsq": kernel.sumsq_work(r, d),
            "fused_combine": kernel.combine_work(r, d, gains.shape[1])}
    bounds = {k: bound_ms(*w) for k, w in work.items()}
    timed = ("client_sumsq", "client_sumsq_library", "fused_combine")
    return {
        "times_ms": {k: time_ms(f) for k, f in fns.items()},
        "cold_ms": {k: cold_ms(fns[k]) for k in timed},
        "cold_ms_clean_l2": {k: cold_ms(fns[k], read=True) for k in timed},
        "host_us_per_call": {k: host_us(fns[k]) for k in timed},
        "bound_ms": {k: b[0] for k, b in bounds.items()},
        "bound_by": {k: b[1] for k, b in bounds.items()},
        "bytes": {k: w[0] for k, w in work.items()},
        "device_kernels_per_call": {
            k: device_kernels(fns[k]) for k in ("client_sumsq",
                                                "fused_combine")}}


def check_kernels_at(r, d, m_ant, seed, dropped, timed, density=0.3,
                     zero_noise=False):
    """One shape: both kernels against their plain versions, twice for
    bit-identity, and (if ``timed``) their times. ``density`` is the
    support's share of d: 0.3 for PFELS, 1 for WFL-P and WFL-PDP;
    ``dropped`` the clients whose transmit mask is 0; ``zero_noise`` a
    shard's call in the sharded cohort (r its clients, z = 0)."""
    import torch
    from repro_torch.kernels.pfels_transmit import kernel, ref
    u, mask, z, gains, tx, txm = _kernel_inputs(r, d, m_ant, seed, dropped,
                                                density, zero_noise)

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
            "dropped": dropped, "support_share": density,
            "zero_noise": zero_noise,
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
        t = _transmit_times(u, mask, z, gains, tx, txm, plain=True)
        line.update(t)
        dk = t["device_kernels_per_call"]
        for name in ("client_sumsq", "fused_combine"):
            if dk[name] != TRANSMIT_DEVICE_KERNELS_PER_CALL:
                failures.append(f"{name} ran {dk[name]} device kernels a "
                                f"call, expected "
                                f"{TRANSMIT_DEVICE_KERNELS_PER_CALL}")
        times, cold = t["times_ms"], t["cold_ms"]
        summary = {
            "client_sumsq": {
                "max_abs_err": line["client_sumsq"]["max_abs_err"],
                "ms": times["client_sumsq"],
                "plain_ms": times["client_sumsq_plain"],
                "bound_ms": t["bound_ms"]["client_sumsq"],
                "bound_by": t["bound_by"]["client_sumsq"],
                "library_ms": times["client_sumsq_library"],
                "cold_ms": cold["client_sumsq"],
                "cold_ms_clean_l2": t["cold_ms_clean_l2"]["client_sumsq"],
                "library_cold_ms": cold["client_sumsq_library"],
                "device_kernels_per_call": dk["client_sumsq"]},
            "fused_combine": {
                "max_abs_err": line["fused_combine"]["y_max_abs_err"],
                "ms": times["fused_combine"],
                "plain_ms": times["fused_combine_plain"],
                "bound_ms": t["bound_ms"]["fused_combine"],
                "bound_by": t["bound_by"]["fused_combine"],
                # no single PyTorch call computes y and E together
                "library_ms": None,
                "cold_ms": cold["fused_combine"],
                "cold_ms_clean_l2": t["cold_ms_clean_l2"]["fused_combine"],
                "device_kernels_per_call": dk["fused_combine"]}}
    emit(line)
    del u, mask, z, gains, tx, txm
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


# where one client's row lies in the batches of the row-independence
# check: alone, row 5 of a shard of 8, row 21 of the main path's 32 (at
# d = 2 mod 4 rows 5 and 21 start 8 bytes off 16-byte alignment, at odd
# d each at its own offset)
ROW_PLACES = ((1, 0), (8, 5), (32, 21))
# FEMNIST's ResNet-18 update: d = 2 mod 4, like VGG-11's
FEMNIST_D = 11_189_886


def check_row_independence(d, seed):
    """One client's ``client_sumsq`` at each place of ``ROW_PLACES``, the
    other rows random: the same bits everywhere (its order of sums
    depends only on its values and d), and within 1e-5 of the plain
    version."""
    import torch
    from repro_torch.kernels.pfels_transmit import kernel, ref
    x = _randn((d,), seed, scale=0.01)
    sums = []
    for r, row in ROW_PLACES:
        u = _randn((r, d), seed + 1 + r, scale=0.01)
        u[row] = x
        sums.append(kernel.client_sumsq(u)[row].item())
        del u
    torch.cuda.empty_cache()
    plain = ref.client_sumsq_ref(x[None])[0].item()
    bits = [struct.unpack("<I", struct.pack("<f", v))[0] for v in sums]
    line = {"phase": "kernels", "check": "client_sumsq row independence",
            "d": d, "places_r_row": ROW_PLACES, "sums": sums,
            "bits": [f"{b:08x}" for b in bits],
            "bit_equal": len(set(bits)) == 1,
            "rel_err_vs_plain": abs(sums[0] - plain) / abs(plain)}
    emit(line)
    if not line["bit_equal"]:
        raise AssertionError(f"client_sumsq at d={d}: one client's sum "
                             f"differs with its row: {line['bits']}")
    if not line["rel_err_vs_plain"] <= 1e-5:
        raise AssertionError(f"client_sumsq at d={d} disagrees with its "
                             f"plain version")


def transmit_ptxas():
    """Registers and spills of the pair's kernels, by kernel name (the
    first design's names too, for a parent tree)."""
    return _ptxas("pfels_transmit",
                  r"\d(client_sumsq_kernel|fused_combine_kernel|"
                  r"sumsq_partial_kernel|sum_rows_kernel|combine_kernel)E")


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
# the shapes of the MoE, Whisper and VLM serving paths, (shape, causal):
# whisper-tiny's encoder (1500 frames) and cross-attention in prefill
# (prompt 128) and decode (one row) with no mask, and its decoder's
# causal prefill; a small Sq > Skv with no mask; granite-moe-3b-a800m's
# causal prefill (GQA 24/8); qwen2-vl-72b's prefill of 1024 vision and
# 1024 text rows (GQA 64/8, Dh 128) as one causal launch, and as its
# serving path runs it: the vision prefix against itself with no mask,
# then the text rows against every key, causal
FLASH_FAMILIES = (((8, 1500, 1500, 6, 6, 64, None), False),
                  ((8, 128, 1500, 6, 6, 64, None), False),
                  ((8, 1, 1500, 6, 6, 64, None), False),
                  ((8, 128, 128, 6, 6, 64, None), True),
                  ((1, 300, 77, 4, 2, 64, None), False),
                  ((8, 2048, 2048, 24, 8, 64, None), True),
                  ((4, 2048, 2048, 64, 8, 128, None), True),
                  ((4, 1024, 1024, 64, 8, 128, None), False),
                  ((4, 1024, 2048, 64, 8, 128, None), True))
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
        n_bytes, flops = kernel.work(b, s, h, p, n, chunk, dtype.itemsize)
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


def _plain_attention_by_row(q, k, v, window, causal=True):
    """The plain version one batch row at a time (a full-shape f32 score
    tensor of every row together would take 4.3 GB)."""
    import torch
    from repro_torch.kernels.flash_attn import ref
    return torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        causal=causal, window=window)
                      for i in range(q.shape[0])])


def _sdpa_call(q, k, v, causal):
    """One ``scaled_dot_product_attention`` call of the same function:
    ``is_causal`` at Sq = Skv; the kernel's suffix-aligned causal mask as
    a boolean mask where Sq < Skv (``is_causal`` aligns the rows to the
    first key)."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sq, skv = q.shape[1], k.shape[1]
    gqa = k.shape[2] != q.shape[2]
    if causal and sq != skv:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
    return lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=gqa)


def check_flash_at(shape, dtype_name, seed, timed, emulate=False,
                   causal=True):
    import torch
    from repro_torch.kernels.flash_attn import kernel, ref
    b, sq, skv, h, hkv, dh, window = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, skv, hkv, dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, skv, hkv, dh), generator=g, device="cuda").to(dtype)
    kept = [t.clone() for t in (q, k, v)]
    o1 = kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    o2 = kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = _plain_attention_by_row(q.float(), k.float(), v.float(), window,
                                   causal)
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
                      "Dh": dh, "window": window, "causal": causal},
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
        emu, emu_limit = ref.tensor_core_route(q, k, v, causal=causal,
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
        n_bytes, flops = kernel.work(b, sq, skv, h, hkv, dh, window,
                                     dtype.itemsize, causal)
        peak = (PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16
                else PEAK_F32_FLOP_PER_S)
        bound, by = bound_ms(n_bytes, flops, peak)
        times = {
            "kernel": time_ms(lambda: kernel.flash_attention_fwd(
                q, k, v, causal=causal, window=window)),
            "plain": time_ms(lambda: _plain_attention_by_row(
                q, k, v, window, causal), reps=5),
            "library": time_ms(_sdpa_call(q, k, v, causal))}
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
            "library": "scaled_dot_product_attention (the same mask and "
                       "GQA)"})
        if dtype == torch.bfloat16:
            line["ptxas"] = flash_ptxas().get(dh)
        summary = {"max_abs_err": float(err.max()), "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": times["library"]}
    emit(line)
    del q, k, v, o1, o2, want, err
    torch.cuda.empty_cache()
    failures = []
    where = f"{shape} causal={causal} {dtype_name}"
    if not ok:
        failures.append(f"flash_attention_fwd {where} disagrees with its "
                        f"plain version")
    if not emulated:
        failures.append(f"flash_attention_fwd {where} departs from the "
                        f"emulated rounding of its route")
    if not bit:
        failures.append(f"flash_attention_fwd {where} is not bit-identical "
                        f"run to run")
    if not intact:
        failures.append(f"flash_attention_fwd {where}: q, k or v changed "
                        f"across the launches")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def _ptxas(source, entry):
    """Registers and spills of each instantiation of a kernel, from this
    process's build log of ``source`` (empty if the library was built
    earlier): ``entry`` is a regex on the mangled name whose groups are
    the template's arguments, the key (integers as ints)."""
    import re
    from repro_torch.kernels import _build
    out, key = {}, None
    for ln in _build.BUILD_LOGS.get(source, "").splitlines():
        m = re.search(entry, ln)
        if m:
            key = tuple(int(v) if v.isdigit() else v for v in m.groups())
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
# the gather's scale beta/|h_i| (a number and an f32 tensor; it rounds
# apart in f32 and bf16), k_rows that leave a warp's group of rows part
# filled (odd counts: in bf16 a warp step takes two rows), and R past
# 2^24 rows of bf16 (4.3 GB), whose element offsets pass 2^31
GATHER_SCALE = 0.05 / 0.015
GATHER_SMALL = ((300, 3), (300, 5))
GATHER_LARGE_ROWS = 2 ** 24 + 4_096


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
    """Kernels, copies and fills that one call of ``fn`` enqueues on the
    card: the nodes of a CUDA graph captured from the call. Nothing runs
    in the capture, and unlike ``torch.profiler``'s count (which has
    missed ``clip_norm``'s cooperative launch after other sessions) this
    one does not depend on what ran before it. ``fn`` runs once first on
    the capturing stream, so that what a wrapper keeps for each stream
    (the transmit pair's ticket counter) exists before the capture."""
    import ctypes
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    graph.reset()
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


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
        bound, by = bound_ms(*kernel.work(n, elem))
        fns = {"kernel": lambda: kernel.clip_norm(x, clip),
               "plain": lambda: ref.clip_norm_ref(x, clip),
               "library_first_pass": lambda: torch.linalg.vector_norm(x)}
        times = {k: time_ms(f) for k, f in fns.items()}
        line.update({"times_ms": times,
                     "cold_ms": {k: cold_ms(f) for k, f in fns.items()},
                     "bytes": kernel.work(n, elem)[0],
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


def gather_ptxas():
    """The gather kernel's registers and spills, by (dtype, vector
    path)."""
    found = _ptxas("randk_gather",
                   r"gather_kernelI(f|13__nv_bfloat16)Lb([01])E")
    return {f"{'f32' if dt == 'f' else 'bf16'} "
            f"{'vector' if vec else 'scalar'}": v
            for (dt, vec), v in found.items()}


def check_gather_at(rows, k_rows, dtype_name, seed, timed,
                    misaligned=False):
    """The gather with a tensor scale and with a number scale (each
    bit-equal to the plain version given the same scale), twice for
    bit-identity; on a view off 16-byte alignment also bit-equal to the
    aligned copy's result. Timed: both scales, the plain version and
    ``index_select`` alone, warm and cold, and the device kernels of one
    call with each scale."""
    import torch
    from repro_torch.kernels.randk_gather import kernel, ref
    delta = _randn((rows, 128), seed, dtype_name, scale=0.01)
    idx = _row_indices(rows, k_rows, seed)
    t_scale = torch.tensor(GATHER_SCALE, device="cuda")   # beta / |h_i|
    src = _misaligned(delta) if misaligned else delta
    o1 = kernel.randk_gather(src, idx, t_scale)
    o2 = kernel.randk_gather(src, idx, t_scale)
    o_n = kernel.randk_gather(src, idx, GATHER_SCALE)
    o_al = kernel.randk_gather(delta, idx, t_scale) if misaligned else o1
    o_p = ref.randk_gather_ref(delta, idx, t_scale)
    o_pn = ref.randk_gather_ref(delta, idx, GATHER_SCALE)
    torch.cuda.synchronize()
    same = bool(torch.equal(o1, o_p))
    same_n = bool(torch.equal(o_n, o_pn))
    aligned = bool(torch.equal(o1, o_al))
    bit = bool(torch.equal(o1, o2))
    line = {"phase": "kernels", "kernel": "randk_gather",
            "shape": {"R": rows, "k_rows": k_rows, "lanes": 128},
            "dtype": dtype_name, "misaligned": misaligned,
            "bit_identical_to_plain": same,
            "number_scale_bit_identical_to_plain": same_n,
            "equal_to_aligned_copy": aligned,
            "max_abs_err": float((o1.float() - o_p.float()).abs().max()),
            "bit_identical": bit, "tolerance": "bit-identical"}
    summary = None
    if timed:
        elem = delta.element_size()
        n_bytes, flops = kernel.work(k_rows, elem)
        bound, by = bound_ms(n_bytes, flops)
        fns = {"kernel": lambda: kernel.randk_gather(delta, idx, t_scale),
               "kernel_number_scale": lambda: kernel.randk_gather(
                   delta, idx, GATHER_SCALE),
               "plain": lambda: ref.randk_gather_ref(delta, idx, t_scale),
               "index_select": lambda: torch.index_select(delta, 0, idx)}
        times = {k: time_ms(f) for k, f in fns.items()}
        cold = {k: cold_ms(f) for k, f in fns.items()}
        line.update({
            "times_ms": times, "cold_ms": cold, "bytes": n_bytes,
            "bound_ms": bound, "cold_share_of_bound": bound / cold["kernel"],
            "device_kernels_per_call": {
                "tensor_scale": device_kernels(fns["kernel"]),
                "number_scale": device_kernels(
                    fns["kernel_number_scale"])},
            "ptxas": gather_ptxas(),
            "library": "none: no one PyTorch call gathers and scales; "
                       "index_select is the gather without the scale"})
        summary = {"max_abs_err": line["max_abs_err"], "ms": times["kernel"],
                   "plain_ms": times["plain"], "bound_ms": bound,
                   "bound_by": by, "library_ms": None,
                   "index_select_ms": times["index_select"],
                   "cold_ms": cold,
                   "device_kernels_per_call":
                       line["device_kernels_per_call"]}
    emit(line)
    failures = []
    if timed and set(line["device_kernels_per_call"].values()) != {1}:
        failures.append(f"randk_gather ran {line['device_kernels_per_call']}"
                        f" device kernels a call, expected 1")
    if not (same and same_n):
        failures.append(f"randk_gather {rows}x{k_rows} {dtype_name} "
                        f"(misaligned {misaligned}) disagrees with its plain "
                        f"version")
    if not aligned:
        failures.append(f"randk_gather {rows}x{k_rows} {dtype_name}: the "
                        f"misaligned view differs from the aligned copy")
    if not bit:
        failures.append(f"randk_gather {rows}x{k_rows} is not bit-identical "
                        f"run to run")
    if failures:
        raise AssertionError("; ".join(failures))
    return summary


def check_gather_out_of_range():
    """Indices outside [0, R) give rows of NaN, on the vector and the
    scalar path, in both dtypes; the rows in range are the plain
    version's."""
    import torch
    from repro_torch.kernels.randk_gather import kernel, ref
    rows = 40
    idx = torch.tensor([7, rows, -1, 0, 2 ** 31 - 1, 39, -2 ** 31],
                       dtype=torch.int32, device="cuda")
    bad = torch.tensor([False, True, True, False, True, False, True],
                       device="cuda")
    results = {}
    for dtype in ("float32", "bfloat16"):
        delta = _randn((rows, 128), 30, dtype)
        for misaligned in (False, True):
            src = _misaligned(delta) if misaligned else delta
            out = kernel.randk_gather(src, idx, 0.5)
            want = ref.randk_gather_ref(delta, idx[~bad], 0.5)
            results[f"{dtype}{' misaligned' if misaligned else ''}"] = bool(
                torch.isnan(out[bad]).all() and torch.equal(out[~bad], want))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "randk_gather",
          "what": "indices out of range give NaN rows", "rows": rows,
          "idx": idx.tolist(), "nan_rows_and_plain_rows": results})
    if not all(results.values()):
        raise AssertionError(f"randk_gather out-of-range rows: {results}")


def check_gather_large_rows():
    """bf16 delta of more than 2^24 rows (4.3 GB), gathered at indices
    past row 2^24, where the element offset passes 2^31: bit-equal to the
    plain version with a number and a tensor scale."""
    import torch
    from repro_torch.kernels.randk_gather import kernel, ref
    rows = GATHER_LARGE_ROWS
    g = torch.Generator(device="cuda").manual_seed(32)
    delta = torch.empty((rows, 128), dtype=torch.bfloat16,
                        device="cuda").normal_(generator=g)
    idx = torch.cat([
        torch.randint(0, rows, (4_096,), generator=g, device="cuda",
                      dtype=torch.int32),
        torch.tensor([2 ** 24, rows - 1, 2 ** 24 + 1], dtype=torch.int32,
                     device="cuda")])
    t_scale = torch.tensor(GATHER_SCALE, device="cuda")
    o_t = kernel.randk_gather(delta, idx, t_scale)
    o_n = kernel.randk_gather(delta, idx, GATHER_SCALE)
    same_t = bool(torch.equal(o_t, ref.randk_gather_ref(delta, idx,
                                                        t_scale)))
    same_n = bool(torch.equal(o_n, ref.randk_gather_ref(delta, idx,
                                                        GATHER_SCALE)))
    max_offset = int(idx.max()) * 128
    emit({"phase": "kernels", "kernel": "randk_gather",
          "shape": {"R": rows, "k_rows": int(idx.numel()), "lanes": 128},
          "dtype": "bfloat16", "delta_bytes": delta.numel() * 2,
          "max_element_offset": max_offset,
          "bit_identical_to_plain": {"tensor_scale": same_t,
                                     "number_scale": same_n},
          "tolerance": "bit-identical"})
    del delta
    torch.cuda.empty_cache()
    if max_offset < 2 ** 31 or not (same_t and same_n):
        raise AssertionError("randk_gather past 2^24 rows disagrees with "
                             "its plain version")


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
        n_bytes, flops = kernel.work(k_rows, elem)
        bound, by = bound_ms(n_bytes, flops)
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
    (the combine with duplicate rows too; all three also on operands off
    16-byte alignment; the gather also at odd k_rows, out of range and
    past 2^24 rows), the clip above L2's size, then timed at the VGG-11
    shapes in f32 (the gather in bf16 too) with the device kernels of one
    call counted."""
    for i, (rows, k_rows) in enumerate(ROW_SMALL):
        for dtype in ("float32", "bfloat16"):
            check_clip_at(rows, dtype, seed=i, timed=False)
            check_gather_at(rows, k_rows, dtype, seed=i, timed=False)
            check_combine_at(rows, k_rows, dtype, seed=i, timed=False)
            check_combine_at(rows, 4 * k_rows, dtype, seed=i, timed=False,
                             duplicates=True)
            check_clip_at(rows, dtype, seed=i, timed=False, misaligned=True)
            check_gather_at(rows, k_rows, dtype, seed=i, timed=False,
                            misaligned=True)
            check_combine_at(rows, k_rows, dtype, seed=i, timed=False,
                             misaligned=True)
            check_combine_at(rows, 4 * k_rows, dtype, seed=i, timed=False,
                             duplicates=True, misaligned=True)
    for i, (rows, k_rows) in enumerate(GATHER_SMALL):
        for dtype in ("float32", "bfloat16"):
            check_gather_at(rows, k_rows, dtype, seed=10 + i, timed=False)
    check_gather_out_of_range()
    check_gather_large_rows()
    # x of 268 MB, above the 50 MB L2: the second read comes from HBM
    check_clip_at(CLIP_ABOVE_L2_ROWS, "float32", seed=20, timed=False)
    k_rows = MAIN_K // 128
    summary = {"clip_norm": check_clip_at(VGG_ROWS, "float32", seed=21,
                                          timed=True),
               "randk_gather": check_gather_at(VGG_ROWS, k_rows, "float32",
                                               seed=22, timed=True),
               "aircomp_combine": check_combine_at(VGG_ROWS, k_rows,
                                                   "float32", seed=23,
                                                   timed=True)}
    check_gather_at(VGG_ROWS, k_rows, "bfloat16", seed=24, timed=True)
    return summary


def phase_kernels():
    # ragged small shapes; d = 1, 2 and 3 mod 4 at r = 3 (rows at every
    # offset from 16-byte alignment), r = 128 (coefficients past one
    # warp), and FEMNIST's ResNet-18 at r = 32
    for r, d, m_ant, dropped in ((1, 4100, 4, 0), (3, 4100, 4, 1),
                                 (4, 26_122, 1, 0), (3, 4101, 4, 1),
                                 (3, 4102, 4, 1), (3, 4103, 1, 0),
                                 (128, 100_003, 4, 16),
                                 (MAIN_R, FEMNIST_D, 1, 0)):
        check_kernels_at(r, d, m_ant, seed=r, dropped=dropped, timed=False)
    for i, d in enumerate((MAIN_D, 4101)):
        check_row_independence(d, seed=40 + i)
    ptxas = transmit_ptxas()
    emit({"phase": "kernels", "what": "pfels_transmit ptxas",
          "ptxas": ptxas})
    timed = check_transmit_timed()
    summary = timed["main_path"]
    for name in ("client_sumsq", "fused_combine"):
        summary[name]["per_shard"] = [
            {"r": r, **timed[label][name]}
            for label, r, *_ in TRANSMIT_TIMED if label.startswith("per_")]
    for name in ("client_sumsq", "fused_combine"):
        summary[name]["ptxas"] = ptxas.get(f"{name}_kernel")
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
    # the new families' shapes in both routes, the bf16 one also against
    # its emulated rounding; timed but for the small Sq > Skv shape
    by_shape = []
    for i, (shape, causal) in enumerate(FLASH_FAMILIES):
        timed = shape[1] != 300
        for dtype in ("bfloat16", "float32"):
            row = check_flash_at(shape, dtype, seed=30 + i, timed=timed,
                                 emulate=dtype == "bfloat16", causal=causal)
            if row:
                by_shape.append({"shape": list(shape[:6]), "causal": causal,
                                 "dtype": dtype, **row})
    summary["flash_attention_fwd"]["by_shape"] = by_shape
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
    the prefill's profile line, the three prefills' seconds (unlike
    ``serve``'s first prefill, these run warm) and the first one's peak
    memory (reset after the params and tokens are made)."""
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_prefill()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if len(warm) == 1:  # later ones run beside the last one's outputs
            peak = torch.cuda.max_memory_allocated()
    pre = profile_call(f"{arch} prefill, batch {batch}, prompt "
                       f"{prompt_len}", run_prefill)
    if steps:
        profile_call(f"{arch} {steps} decode steps, batch {batch}",
                     run_decode)
    del params, box
    torch.cuda.empty_cache()
    return pre, warm, peak


# the device memory one round of the main path may leave allocated
ROUND_GROWTH_LIMIT = 2 ** 20


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
    allocated = []

    def on_round(t, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        allocated.append(torch.cuda.memory_allocated())

    kernel.reset_launch_counts()
    end, metrics = trainer.run(state, x, y, rounds=rounds, on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    test_loss, test_acc = trainer.evaluate(end, xt, yt)

    m = {k: [float(v) for v in metrics[k]] for k in metrics}
    finite = all(math.isfinite(v) for vs in m.values() for v in vs)
    eps_ok = all(v <= cfg.epsilon for v in m["eps_round"])
    digests = _run_digests(end, metrics)
    line = {"phase": "main_path", "model": cfg_m.name, "d": d,
            "k": int(m["subcarriers"][0]), "n_clients": cfg.num_clients,
            "r": cfg.clients_per_round, "tau": cfg.local_steps,
            "data_bytes": x.numel() * x.element_size(),
            "setup_s": setup_s, "rounds": rounds,
            "round_wall_s": [b - a for a, b in zip(marks, marks[1:])],
            "peak_memory_bytes": peak,
            "allocated_bytes_after_round": allocated,
            "launches": launches,
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
    # what a round leaves allocated is its metrics (a few scalars), not
    # a d-sized buffer: a run of the default 2000 rounds must fit
    if allocated[-1] - allocated[-2] >= ROUND_GROWTH_LIMIT:
        failures.append(f"a round left {allocated[-1] - allocated[-2]} "
                        f"bytes allocated")
    if failures:
        raise AssertionError("; ".join(failures))
    if profile:
        profile_round(trainer, end, x, y)
    del x, y, xt, yt, end, state, trainer
    torch.cuda.empty_cache()
    return launches, {"digests": digests,
                      "round_wall_s": line["round_wall_s"]}


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


def vgg_problem():
    """The main path's params and synthetic data (VGG-11 from key 0, 1000
    clients of 50 CIFAR-size images from key 0, on the card), shared by
    the phases that run VGG-11 at its config: (params, x, y, d)."""
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10
    from repro_torch.data import make_federated_classification
    from repro_torch.models import cnn
    params = cnn.init_cnn(prng.PRNGKey(0), PAPER_VGG11_CIFAR10)
    d = sum(p.numel() for p in params.values())
    x, y, _, _ = make_federated_classification(
        prng.PRNGKey(0), n_clients=1000, per_client=50, num_classes=10,
        image_shape=(3, 32, 32))
    return params, x, y, d


def phase_baselines(profile: bool, problem):
    """``Trainer.run`` of each of the paper's comparators (and PFELS with
    error feedback) at the main path's config on VGG-11, 2 rounds each:
    s/round, peak memory, the metrics and the launches of every kernel;
    with ``profile``, one more round of each under the profiler."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.fl import Trainer
    from repro_torch.models import cnn

    cfg_m = PAPER_VGG11_CIFAR10
    rounds = 2
    params, x, y, d = problem
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
    if failures:
        raise AssertionError("; ".join(failures))


# the scenarios of the golden rows (tools/update_goldens.py), at the main
# path's config: (name, config overrides with the channel's fields under
# "channel" and the schedule's under "schedule", client_sumsq launches a
# round). The transmit clip is applied before the aggregator, so
# client_sumsq is not launched, where error feedback (top_k_ef forces it)
# or an encode hook (stoch_quant) needs the clipped updates.
SCENARIOS = (
    ("markov_fading", {"channel": {"model": "markov_fading",
                                   "markov_rho": 0.9}}, 1),
    ("mimo_mrc_4", {"channel": {"model": "mimo_mrc", "num_antennas": 4}}, 1),
    ("mimo_mrc_8", {"channel": {"model": "mimo_mrc", "num_antennas": 8}}, 1),
    ("dropout", {"channel": {"model": "dropout", "dropout_prob": 0.4}}, 1),
    ("top_k_ef", {"compressor": "top_k_ef", "transmit_clip": 0.5}, 0),
    ("threshold", {"compressor": "threshold", "threshold_frac": 0.3}, 1),
    ("stoch_quant", {"compressor": "stoch_quant", "quant_bits": 6,
                     "transmit_clip": 0.5}, 0),
    ("schedule_linear", {"schedule": {"mode": "linear", "k_end_ratio": 0.5,
                                      "power_end": 0.7}}, 1),
    ("schedule_budget", {"schedule": {"mode": "budget", "eps_floor": 0.1}},
     1),
)
# the fused round 1 against the unfused one from the same state and key,
# as parity_on_card holds the golden problem's runs to the reference
SCENARIO_GAP_TOL = 1e-4


def _config(base, overrides):
    """``base`` (a PFELSConfig) with ``overrides``, whose ``channel`` and
    ``schedule`` entries are dicts of those configs' fields."""
    import dataclasses
    from repro_torch.configs import CompressionSchedule
    kw = dict(overrides)
    if "channel" in kw:
        kw["channel"] = dataclasses.replace(base.channel, **kw["channel"])
    if "schedule" in kw:
        kw["schedule"] = CompressionSchedule(**kw["schedule"])
    return dataclasses.replace(base, **kw)


def _run_digests(end, metrics):
    """Sum, |sum| and sum of squares of a run's end params and last
    Delta_hat, and every round's metrics."""
    from repro_torch.tree import ravel
    out = {"params": _digest(ravel(end.params)),
           "prev_delta": _digest(end.prev_delta)}
    for k in ("train_loss", "update_norm", "beta", "energy", "eps_round",
              "r_realized", "subcarriers"):
        out[k] = [float(v) for v in metrics[k]]
    return out


def phase_scenarios(problem):
    """Each of ``SCENARIOS`` at the main path's config on VGG-11 (N =
    1000, r = 32, tau = 5, transmit clip 0.25, fused kernels): round 1
    unfused (plain torch), then 2 fused rounds from the same state and
    key, launch counters zeroed just before them and read just after; for
    ``markov_fading`` also the streamed bank's 2 rounds from the same key.
    ``top_k_ef`` holds the 36.9 GB residual bank, freed after it."""
    import dataclasses
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.fl import Trainer
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.models import cnn

    params, x, y, d = problem
    rounds = 2
    base = PFELSConfig(transmit_clip=0.25, use_fused_kernel=True,
                       channel=scaled_channel(d))
    loss_fn = lambda p, b: cnn.cnn_loss(p, PAPER_VGG11_CIFAR10, b)
    t0 = time.perf_counter()
    failures = []
    for name, overrides, sumsq_per_round in SCENARIOS:
        cfg = _config(base, overrides)
        trainer = Trainer(cfg, loss_fn, params)
        state = trainer.init(prng.PRNGKey(1))
        unfused = Trainer(dataclasses.replace(cfg, use_fused_kernel=False),
                          loss_fn, params)
        u_dig = _run_digests(*unfused.run(state, x, y, rounds=1))
        del unfused
        if state.residuals is not None:
            # the resident bank is written in place: round 1 starts from
            # the zero memory init() made
            state.residuals.zero_()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]

        def on_round(t, m):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        kernel.reset_launch_counts()
        end, metrics = trainer.run(state, x, y, rounds=1, on_round=on_round)
        f_dig = _run_digests(end, metrics)
        per_round = [metrics]
        for _ in range(rounds - 1):
            end, metrics = trainer.run(end, x, y, rounds=1,
                                       on_round=on_round)
            per_round.append(metrics)
        torch.cuda.synchronize()
        launches = dict(kernel.LAUNCHES)
        m = {k: [float(v) for pr in per_round for v in pr[k]]
             for k in per_round[0]}
        want = {"client_sumsq": sumsq_per_round * rounds,
                "fused_combine": rounds}
        gap = max(_digest_gaps(f_dig, u_dig).values())
        shown = ("r_realized", "subcarriers", "beta", "energy", "eps_round",
                 "train_loss")
        line = {"phase": "scenarios", "scenario": name, **overrides,
                "d": d, "r": cfg.clients_per_round,
                "transmit_clip": cfg.transmit_clip, "rounds": rounds,
                "round_wall_s": [b - a for a, b in zip(marks, marks[1:])],
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "launches": launches, "launches_expected": want,
                **{k: m[k] for k in shown},
                "ledger_eps": trainer.ledger_totals(end)["basic"][0],
                "residuals_bytes": (0 if end.residuals is None else
                                    end.residuals.numel() * 4),
                "fused_vs_unfused_round1": gap,
                "fused_vs_unfused_limit": SCENARIO_GAP_TOL}
        line["finite"] = all(math.isfinite(v) for k in shown
                             for v in m[k]) and \
            math.isfinite(line["ledger_eps"])
        if cfg.channel.model == "markov_fading":
            streamed = Trainer(dataclasses.replace(cfg,
                                                   bank_backend="streamed"),
                               loss_fn, params)
            s_end = streamed.init(prng.PRNGKey(1))
            for _ in range(rounds):
                s_end, _ = streamed.run(s_end, x, y, rounds=1)
            line["carry_streamed_equal"] = bool(torch.equal(end.chan,
                                                            s_end.chan))
            del streamed, s_end
        emit(line)
        if launches != want:
            failures.append(f"{name}: launched {launches}, expected {want}")
        if not line["finite"]:
            failures.append(f"{name}: non-finite metric")
        if not gap <= SCENARIO_GAP_TOL:
            failures.append(f"{name}: fused and unfused round 1 differ by "
                            f"{gap}")
        if not line.get("carry_streamed_equal", True):
            failures.append(f"{name}: the streamed bank's channel carry "
                            f"differs from the resident one's")
        del trainer, state, end, metrics, per_round
        torch.cuda.empty_cache()
    emit({"phase": "scenarios", "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("; ".join(failures))


def _digest(a):
    import numpy as np
    a = np.asarray(a.detach().cpu(), np.float64)
    return [float(a.sum()), float(np.abs(a).sum()), float((a * a).sum())]


def _round_run(model_cfg, params, x, y, cfg, device="cuda"):
    """``Trainer.run`` for ``cfg.rounds`` rounds from ``params`` and data
    ``x``, ``y``, all moved to ``device``, with the golden problem's keys
    (init key 1, run key 2) -> (end state, metrics)."""
    import torch
    from repro_torch import prng
    from repro_torch.fl import Trainer, replace
    from repro_torch.models import cnn

    params = {n: t.to(device) for n, t in params.items()}
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, model_cfg, b),
                      params, device=device)
    state = replace(trainer.init(prng.PRNGKey(1, device)),
                    key=prng.PRNGKey(2, device))
    end, metrics = trainer.run(state, x.to(device), y.to(device),
                               rounds=cfg.rounds)
    if device != "cpu":
        torch.cuda.synchronize()
    return end, metrics


def _round_digests(model_cfg, params, x, y, cfg, device="cuda"):
    """``_run_digests`` of :func:`_round_run`."""
    return _run_digests(*_round_run(model_cfg, params, x, y, cfg, device))


def _golden_run(**overrides):
    """The golden problem's run (``tools/update_goldens.py``: BENCH_MLP,
    N = 20, r = 4, tau = 2, 2 rounds) with the config ``overrides`` on
    the card -> (end state, metrics)."""
    from repro_torch import prng
    from repro_torch.configs import BENCH_MLP, PFELSConfig
    from repro_torch.data import make_federated_classification
    from repro_torch.models import cnn

    key = prng.PRNGKey(0)
    params = cnn.init_cnn(key, BENCH_MLP)
    x, y, _, _ = make_federated_classification(
        key, n_clients=20, per_client=20, num_classes=10,
        image_shape=(1, 8, 8))
    base = PFELSConfig(num_clients=20, clients_per_round=4, local_steps=2,
                       local_lr=0.05, compression_ratio=0.3, epsilon=2.0,
                       rounds=2)
    return _round_run(BENCH_MLP, params, x, y, _config(base, overrides))


def _golden_digests(**overrides):
    return _run_digests(*_golden_run(**overrides))


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


def _scenario_golden_rows():
    """The 22 single-device golden rows of the channel models and
    compressors (``tools/update_goldens.py``), as ``_config`` overrides."""
    rows = {}
    for tag, backend in (("", "resident"), ("-streamed", "streamed")):
        for name, chan in (("markov", {"model": "markov_fading",
                                       "markov_rho": 0.9}),
                           ("mimo_mrc", {"model": "mimo_mrc",
                                         "num_antennas": 8}),
                           ("dropout", {"model": "dropout",
                                        "dropout_prob": 0.4})):
            rows[f"chan_{name}{tag}"] = dict(
                bank_backend=backend, use_fused_kernel=False, channel=chan)
            if name == "mimo_mrc":
                chan = dict(chan, num_antennas=4)
            rows[f"chan_{name}-fused{tag}"] = dict(bank_backend=backend,
                                                   channel=chan)
        rows[f"comp_top_k_ef{tag}"] = dict(
            bank_backend=backend, compressor="top_k_ef", transmit_clip=0.5)
        rows[f"comp_threshold{tag}"] = dict(
            bank_backend=backend, compressor="threshold", threshold_frac=0.3)
        rows[f"comp_stoch_quant{tag}"] = dict(
            bank_backend=backend, compressor="stoch_quant", quant_bits=6,
            transmit_clip=0.5)
    rows.update({
        "comp_top_k_ef-unfused": dict(compressor="top_k_ef",
                                      transmit_clip=0.5,
                                      use_fused_kernel=False),
        "comp_stoch_quant-unfused": dict(compressor="stoch_quant",
                                         quant_bits=6, transmit_clip=0.5,
                                         use_fused_kernel=False),
        "comp_sched_linear": dict(schedule={"mode": "linear",
                                            "k_end_ratio": 0.5,
                                            "power_end": 0.7}),
        "comp_sched_budget": dict(schedule={"mode": "budget",
                                            "eps_floor": 0.1}),
    })
    return rows


GOLDEN_ROWS.update(_scenario_golden_rows())


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
          "rows": len(runs),
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


# the committed *-sharded golden rows (tools/update_goldens.py: 8 devices,
# cohort_shape(4, 8) = (2, 2), as cohort_shape(4, 4) is on 4 ranks), each
# with its one-process counterpart's config
SHARDED_GOLDEN_ROWS = {
    **{f"{alg}-sharded": dict(algorithm=alg, use_fused_kernel=False)
       for alg in ("pfels", "wfl_p", "wfl_pdp", "dp_fedavg", "fedavg")},
    "pfels-sharded-fused": {},
    "comp_stoch_quant-sharded": dict(compressor="stoch_quant", quant_bits=6,
                                     transmit_clip=0.5),
}
# a sharded row against its one-process run on the card: the gloo ring
# sums the 4 shards' partials in another order (on the CPU the gap is at
# most 2.2e-7, tests/test_torch_sharded.py)
SHARDED_VS_ONE_PROCESS_TOL = 1e-5
SHARDED_ROUNDS = 3
SHARDED_TIMEOUT_S = 600


def _state_sha256(end, metrics):
    """A hash of a run's end params, last Delta_hat, bank residuals and
    metrics, byte for byte: equal hashes on two ranks are equal bits."""
    import hashlib
    from repro_torch.tree import ravel
    h = hashlib.sha256()
    parts = [ravel(end.params), end.prev_delta]
    if end.bank.residuals is not None:
        parts.append(end.bank.residuals)
    parts += [metrics[k] for k in sorted(metrics)]
    for t in parts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sharded_rank(rank, world, init_file, out_path):
    """One rank of the ``sharded`` phase, in a process of its own: joins a
    gloo world over ``init_file`` on card 0, runs the seven sharded golden
    rows and then the main path's config with the cohort sharded, and
    writes what it saw to ``out_path`` as JSON. Each collective is timed
    between two synchronisations (which the round times then include)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    comm = []

    def timed(name, arg):
        real = getattr(dist, name)

        def call(*args, **kw):
            t = args[arg]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            comm.append((name, t.numel() * t.element_size(),
                         time.perf_counter() - t0))
            return out
        return call

    dist.all_reduce = timed("all_reduce", 0)
    dist.all_gather = timed("all_gather", 1)

    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.fl import Trainer
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.models import cnn

    out = {"rank": rank, "rows": {}}
    for name, kw in SHARDED_GOLDEN_ROWS.items():
        kernel.reset_launch_counts()
        end, metrics = _golden_run(client_sharding="cohort", **kw)
        out["rows"][name] = {"digests": _run_digests(end, metrics),
                             "sha256": _state_sha256(end, metrics),
                             "launches": dict(kernel.LAUNCHES)}
    del end, metrics

    params, x, y, d = vgg_problem()
    cfg = PFELSConfig(transmit_clip=0.25, use_fused_kernel=True,
                      channel=scaled_channel(d), client_sharding="cohort")
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(
        p, PAPER_VGG11_CIFAR10, b), params)
    state = trainer.init(prng.PRNGKey(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.clear()
    marks, per_round = [time.perf_counter()], []

    def on_round(t, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_round.append({
            "calls": {n: sum(1 for c in comm if c[0] == n)
                      for n in ("all_reduce", "all_gather")},
            "bytes": {n: sum(c[1] for c in comm if c[0] == n)
                      for n in ("all_reduce", "all_gather")},
            "seconds": {n: sum(c[2] for c in comm if c[0] == n)
                        for n in ("all_reduce", "all_gather")}})
        comm.clear()

    kernel.reset_launch_counts()
    end, metrics = trainer.run(state, x, y, rounds=SHARDED_ROUNDS,
                               on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # each of SHARDED_ROUNDS steps from the state the sharded steps reached,
    # beside (on rank 0) one step of the one-process round from the same
    # state: the gap of each round on its own, without the drift of the
    # rounds before it
    one_process = (Trainer(dataclasses.replace(cfg, client_sharding="none"),
                           trainer.loss_fn, params) if rank == 0 else None)
    steps, cur = [], state
    for _ in range(SHARDED_ROUNDS):
        nxt, m = trainer.step(cur, x, y)
        m = {k: v[None] for k, v in m.items()}
        row = {"sha256": _state_sha256(nxt, m)}
        if one_process is not None:
            ref_state, ref_m = one_process.step(cur, x, y)
            row["gap_vs_one_process"] = _digest_gaps(
                _run_digests(nxt, m), _run_digests(
                    ref_state, {k: v[None] for k, v in ref_m.items()}))
        steps.append(row)
        cur = nxt
    out["full_width"] = {
        "steps": steps,
        "d": d, "shards": trainer.cohort.shards,
        "clients": [trainer.cohort.clients.start,
                    trainer.cohort.clients.stop],
        "round_wall_s": [b - a for a, b in zip(marks, marks[1:])],
        "launches": launches,
        "peak_memory_bytes": peak,
        "collectives_per_round": per_round,
        "digests": _run_digests(end, metrics),
        "sha256": _state_sha256(end, metrics)}
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _spawn_ranks(world):
    """Starts ``world`` ranks of :func:`_sharded_rank` (spawned, gloo over
    a ``file://`` rendezvous) -> (processes, temporary directory)."""
    import multiprocessing
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank,
                         args=(rank, world, os.path.join(tmp, "init"),
                               os.path.join(tmp, f"rank{rank}.json")))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs, tmp


def _join_ranks(procs, tmp):
    """Waits for every rank, stops any left running, and reads what each
    wrote; any rank that failed fails the phase."""
    import shutil
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    codes = [p.exitcode for p in procs]
    try:
        if any(c != 0 for c in codes):
            raise AssertionError(f"sharded ranks exited with {codes}")
        results = []
        for rank in range(len(procs)):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _vgg_unfused_rounds():
    """The main path's config in this process, unfused: ``SHARDED_ROUNDS`` rounds that differ from ``main_path``
    only in the order of the transmit's f32 sums -> their digests."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_VGG11_CIFAR10, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.fl import Trainer
    from repro_torch.models import cnn
    params, x, y, d = vgg_problem()
    cfg = PFELSConfig(transmit_clip=0.25, use_fused_kernel=False,
                      channel=scaled_channel(d))
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(
        p, PAPER_VGG11_CIFAR10, b), params)
    out = _run_digests(*trainer.run(trainer.init(prng.PRNGKey(1)), x, y,
                                    rounds=SHARDED_ROUNDS))
    del params, x, y, trainer
    torch.cuda.empty_cache()
    return out


def phase_sharded(main_info, yardstick=False):
    """The sharded cohort (``client_sharding="cohort"``) on
    ``SHARDED_WORLD`` gloo ranks sharing the card, each a spawned process
    that holds the whole replicated state: the seven sharded golden rows
    against the committed digests and against their one-process runs
    (run before the ranks start, so that the ranks have the card to
    themselves), every rank's end state equal bit for bit; then the main
    path's config at full width (8 clients a rank, ``fused_combine`` at
    (8, d) with zero noise) against ``main_info``, the main path's
    digests and round times: round 1 against the main path's, each of 3
    steps against the one-process step from the same state, and the 3
    rounds' drift from the main path. With ``yardstick`` (``--sharded``)
    that drift is printed beside the one of unfused one-process rounds,
    run after the ranks have ended. Returns the transmit pair's launches
    summed over the ranks, by path."""
    import torch
    from repro_torch.kernels.pfels_transmit import kernel
    t_phase = time.perf_counter()
    one_process = {name: _golden_digests(**kw)
                   for name, kw in SHARDED_GOLDEN_ROWS.items()}
    torch.cuda.empty_cache()
    ranks = _join_ranks(*_spawn_ranks(SHARDED_WORLD))
    vgg_unfused = _vgg_unfused_rounds() if yardstick else None
    torch.cuda.empty_cache()
    with open(os.path.join(ROOT, "tests", "goldens",
                           "golden_digests.json")) as f:
        golden = json.load(f)["cases"]
    failures = []
    gaps, launches = {}, {}
    for name in SHARDED_GOLDEN_ROWS:
        got = ranks[0]["rows"][name]["digests"]
        g = golden[name]
        want = {"params": g["params"], "prev_delta": g["prev_delta"],
                **{k: g["metrics"][k] for k in ("train_loss", "update_norm",
                                                "beta", "energy",
                                                "eps_round")}}
        gaps[name] = {"vs_reference": _max_rel_gap(got, want),
                      "vs_one_process": _max_rel_gap(got,
                                                     one_process[name])}
        launches[name] = [r["rows"][name]["launches"] for r in ranks]
        if not gaps[name]["vs_reference"] <= 1e-4:
            failures.append(f"{name} disagrees with the reference")
        if not gaps[name]["vs_one_process"] <= SHARDED_VS_ONE_PROCESS_TOL:
            failures.append(f"{name} disagrees with its one-process run")
        if len({r["rows"][name]["sha256"] for r in ranks}) != 1:
            failures.append(f"{name}: the ranks' states differ")
        fused = SHARDED_GOLDEN_ROWS[name].get("use_fused_kernel", True)
        want_launches = {"client_sumsq": 0,
                         "fused_combine": 2 if fused else 0}
        if any(n != want_launches for n in launches[name]):
            failures.append(f"{name}: launches {launches[name]}, expected "
                            f"{want_launches} on each rank")
    emit({"phase": "sharded", "part": "golden rows",
          "ranks": SHARDED_WORLD, "backend": "gloo", "rows": len(gaps),
          "max_rel_gap": gaps, "launches_by_rank": launches,
          "ranks_bit_equal": {n: len({r["rows"][n]["sha256"]
                                      for r in ranks}) == 1
                              for n in SHARDED_GOLDEN_ROWS},
          "tolerance": {"vs_reference": 1e-4,
                        "vs_one_process": SHARDED_VS_ONE_PROCESS_TOL}})

    full = [r["full_width"] for r in ranks]
    main_d = main_info["digests"]
    got = full[0]["digests"]
    round1 = {k: abs(got[k][0] - main_d[k][0]) / abs(main_d[k][0])
              for k in ("train_loss", "update_norm")}
    digest_gaps = _digest_gaps(got, main_d)
    step_gaps = [st["gap_vs_one_process"] for st in full[0]["steps"]]
    # each rank's hashes: the 3-round run's end state, then each step's
    hashes = [[f["sha256"]] + [st["sha256"] for st in f["steps"]]
              for f in full]
    ranks_equal = all(h == hashes[0] for h in hashes)
    expected = {"client_sumsq": SHARDED_ROUNDS,
                "fused_combine": SHARDED_ROUNDS}
    emit({"phase": "sharded", "part": "full width",
          "model": "VGG-11", "d": full[0]["d"], "r": MAIN_R,
          "ranks": SHARDED_WORLD, "shards": full[0]["shards"],
          "rounds": SHARDED_ROUNDS,
          "main_path_round_wall_s": main_info["round_wall_s"],
          "per_rank": [{k: f[k] for k in ("clients", "round_wall_s",
                                          "launches", "peak_memory_bytes",
                                          "collectives_per_round")}
                       for f in full],
          "launches_expected_per_rank": expected,
          "round1_rel_gap_vs_main_path": round1,
          "digest_rel_gap_vs_main_path": digest_gaps,
          "unfused_one_process_rel_gap_vs_main_path": (
              None if vgg_unfused is None
              else _digest_gaps(vgg_unfused, main_d)),
          "step_rel_gaps_vs_one_process_from_same_state": step_gaps,
          "ranks_bit_equal": ranks_equal,
          "tolerance": {"round1": 1e-6,
                        "step_vs_one_process": SHARDED_VS_ONE_PROCESS_TOL},
          "nvidia_smi": nvidia_smi()})
    if any(f["launches"] != expected for f in full):
        failures.append("full width: a rank's launches differ from "
                        f"{expected}")
    if not ranks_equal:
        failures.append("full width: the ranks' states differ")
    if not max(round1.values()) <= 1e-6:
        failures.append(f"full width: round 1 off the main path {round1}")
    if not max(max(g.values()) for g in step_gaps) <= \
            SHARDED_VS_ONE_PROCESS_TOL:
        failures.append("full width: a sharded step off the one-process "
                        "step from the same state")
    finite = all(math.isfinite(v) for vs in got.values() for v in vs)
    if not finite:
        failures.append("full width: non-finite digests")
    emit({"phase": "sharded", "seconds": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError("; ".join(failures))
    return {name: {"golden_rows": sum(n[name] for ls in launches.values()
                                      for n in ls),
                   "full_width": sum(f["launches"][name] for f in full)}
            for name in kernel.LAUNCHES}


# conv_parity_on_card's tolerances, derived on the CPU by
# tests/test_torch_cnn.py with f64 convolutions (which move what summing
# in another order moves, and more) and with TF32-rounded operands in
# place of f32 ones. One local step's gradient: f64 moves it by less than
# a tenth of the limit, TF32 by more than ten times it. Two rounds of
# BENCH_CNN_CIFAR at the default config, with these keys: the same. At
# other keys a ReLU or max-pool somewhere among the 32 x 5 steps can
# switch under any f32 difference and move the digests as far as TF32
# does. One step can switch a ReLU too, where a pre-activation lies
# within f32 rounding of 0: FEMNIST's ResNet-18 step on client 0 switches
# two (pre-activations 6.0e-8 and 9.5e-7), and the card's and the CPU's
# steps are each as far from the step in f64 (1.3e-5, 3.8e-5 of max|g|)
# as from each other (3.8e-5). So femnist holds the CPU's step with the
# card's ReLU pattern to the limit, and prints the gap without it.
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


def _step_gradient(model_cfg, params, x, y, device, relu_masks=None,
                   replay=False):
    """The gradient of ``local_train``'s first step (read in a hook on
    each param leaf, inside the port's own scope) and its loss, on
    ``device``. With ``relu_masks`` (a list) each ``torch.relu`` of the
    step records its output's pattern (input > 0) into it, or with
    ``replay`` applies the recorded patterns in order instead of its
    own; a replay also returns how many elements its own pattern would
    have switched."""
    import torch
    from repro_torch import prng
    from repro_torch.fl.client import local_train
    from repro_torch.models import cnn
    from repro_torch.tree import ravel

    grads = {}
    switched = [0]

    def loss_fn(p, batch):
        for n, t in p.items():
            t.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach()))
        return cnn.cnn_loss(p, model_cfg, batch)

    real_relu = torch.relu
    pattern = iter(relu_masks or ())

    def relu(t):
        if not replay:
            relu_masks.append((t > 0).detach().cpu())
            return real_relu(t)
        m = next(pattern).to(t.device)
        switched[0] += int(((t > 0) != m).sum())
        return t * m.to(t.dtype)

    if relu_masks is not None:
        torch.relu = relu
    try:
        _, loss = local_train({n: t.to(device) for n, t in params.items()},
                              x.to(device), y.to(device),
                              prng.PRNGKey(5, device), loss_fn=loss_fn,
                              steps=1, lr=0.05, clip=1.0, momentum=0.9)
    finally:
        torch.relu = real_relu
    g = ravel({n: grads[n] for n in params}).cpu()
    return (g, float(loss), switched[0]) if replay else (g, float(loss))


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


# ------------------------------------------------ the paper's second model

# kernel names of csrc/pfels_transmit.cu as the profiler shows them
TRANSMIT_KERNEL_NAMES = ("client_sumsq_kernel", "fused_combine_kernel")


def round_split(prof):
    """A profiled FL round's device time by kernel name: cuDNN's
    convolutions (its implicit-GEMM, Winograd, FFT and direct engines),
    other GEMMs (the dense layer), the int64 element-wise ops (the PRNG's
    threefry and index arithmetic; the models compute in f32), the two
    PFELS transmit kernels, the rest."""
    parts = {"convolutions": 0.0, "other_gemm": 0.0,
             "int64_elementwise_prng": 0.0, "transmit_kernels": 0.0,
             "other": 0.0}
    calls = dict.fromkeys(parts, 0)
    for ms, n, name in prof["all"]:
        low = name.lower()
        if any(t in low for t in TRANSMIT_KERNEL_NAMES):
            part = "transmit_kernels"
        elif any(t in low for t in ("conv", "cudnn", "implicit_gemm",
                                    "dgrad", "wgrad", "fprop", "winograd",
                                    "cf32")):
            part = "convolutions"
        elif "gemm" in low:
            part = "other_gemm"
        elif "<long" in low or "int64" in low:
            part = "int64_elementwise_prng"
        else:
            part = "other"
        parts[part] += ms
        calls[part] += n
    busy_ms = prof["device_busy_s"] * 1e3
    return {k: {"device_ms": v, "calls": calls[k],
                "share_of_device_time": v / busy_ms if busy_ms else None}
            for k, v in parts.items()}


def _label_skew(y, num_classes):
    """How far each client's labels are from uniform: the mean over
    clients of its largest class share and of its distinct classes."""
    import torch
    hist = torch.zeros((y.shape[0], num_classes), dtype=torch.int64,
                       device=y.device)
    hist.scatter_add_(1, y, torch.ones_like(y))
    share = hist.float() / y.shape[1]
    return {"mean_top_class_share": float(share.max(dim=1).values.mean()),
            "mean_distinct_classes": float((hist > 0).sum(dim=1)
                                           .float().mean()),
            "global_top_class_share": float(hist.sum(0).max())
            / y.numel()}


def phase_femnist():
    """The paper's second experiment (§8.1) through ``Trainer.run``: PFELS
    with the default config on the full-width ResNet-18 of FEMNIST (d =
    11,189,886), N = 1000 clients of 50 synthetic 1x28x28 images, 62
    classes, Dirichlet(0.5) label skew, all drawn on the card; r = 32,
    tau = 5, transmit clip 0.25, fused kernels, 3 rounds with the launch
    counters zeroed just before and read just after. Then one more round
    twice from the same state and key (bit-equal; the second under the
    profiler: device busy time, idle share, time by kernel kind), and one
    ``local_train`` step's gradient at this width on the card against the
    CPU under PyTorch's default cuDNN flags (the package's scope must
    hold it within ``CONV_GRAD_TOL`` of max|g|, the CPU's step taking the
    card's ReLU pattern; the gap with the CPU's own pattern and the count
    of switched ReLU outputs printed beside it)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import PAPER_RESNET18_FEMNIST, PFELSConfig
    from repro_torch.core.channel import scaled_channel
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import Trainer
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.models import cnn
    from repro_torch.tree import ravel

    cfg_m = PAPER_RESNET18_FEMNIST
    rounds = 3
    t0 = time.perf_counter()
    params = cnn.init_cnn(prng.PRNGKey(0), cfg_m)
    d = sum(p.numel() for p in params.values())
    x, y, xt, yt = make_federated_classification(
        prng.PRNGKey(0), n_clients=1000, per_client=50,
        num_classes=cfg_m.num_classes, image_shape=(1, 28, 28), alpha=0.5)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = PFELSConfig(transmit_clip=0.25, use_fused_kernel=True,
                      channel=scaled_channel(d))
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, cfg_m, b), params)
    state = trainer.init(prng.PRNGKey(1))
    kernel.reset_launch_counts()
    end, metrics, stats = _fl_run(trainer, state, x, y, rounds)
    launches = dict(kernel.LAUNCHES)
    test_loss, test_acc = trainer.evaluate(end, xt, yt)
    m = {k: [float(v) for v in metrics[k]] for k in metrics}
    finite = all(math.isfinite(v) for vs in m.values() for v in vs) and \
        bool(torch.isfinite(ravel(end.params)).all())

    box = {}

    def again():
        box["out"] = trainer.step(end, x, y)

    again()
    first = box["out"]
    prof = profile_call("one more ResNet-18 round (femnist)", again)
    second = box["out"]
    repeat_bit_equal = (
        torch.equal(ravel(first[0].params), ravel(second[0].params))
        and torch.equal(first[0].prev_delta, second[0].prev_delta)
        and all(torch.equal(first[1][k], second[1][k]) for k in first[1]))

    masks = []
    with _pytorch_cudnn_flags():
        g_card, _ = _step_gradient(cfg_m, params, x[0], y[0], "cuda",
                                   relu_masks=masks)
        g_cpu, _, switched = _step_gradient(cfg_m, params, x[0], y[0],
                                            "cpu", relu_masks=masks,
                                            replay=True)
        g_own, _ = _step_gradient(cfg_m, params, x[0], y[0], "cpu")
    scale = float(g_cpu.abs().max())
    grad_gap = float((g_card - g_cpu).abs().max()) / scale
    own_gap = float((g_card - g_own).abs().max()) / scale

    line = {"phase": "femnist", "model": cfg_m.name, "d": d,
            "k": int(m["subcarriers"][0]), "n_clients": cfg.num_clients,
            "r": cfg.clients_per_round, "tau": cfg.local_steps,
            "dirichlet_alpha": 0.5, "data_bytes": x.numel() * 4,
            "label_skew": _label_skew(y, cfg_m.num_classes),
            "setup_s": setup_s, "rounds": rounds, **stats,
            "launches": launches,
            "train_loss": m["train_loss"], "beta": m["beta"],
            "energy": m["energy"], "eps_round": m["eps_round"],
            "update_norm": m["update_norm"], "test_loss": test_loss,
            "test_acc": test_acc, "finite": finite,
            "repeat_round_bit_equal": repeat_bit_equal,
            "profiled_round": {"wall_s": prof["wall_s"],
                               "device_busy_s": prof["device_busy_s"],
                               "device_idle_share":
                                   prof["device_idle_share"],
                               "split": round_split(prof)},
            "step_gradient_gap_rel_to_max": grad_gap,
            "step_gradient_relu_switched": switched,
            "step_gradient_gap_own_relu_pattern": own_gap,
            "tolerance": {"step_gradient": f"{CONV_GRAD_TOL} of max|g|, the "
                                           f"CPU with the card's ReLU "
                                           f"pattern"}}
    emit(line)
    failures = []
    if d != 11_189_886:
        failures.append(f"ResNet-18 has d={d}, expected 11,189,886")
    if launches != {"client_sumsq": rounds, "fused_combine": rounds}:
        failures.append(f"launched {launches} in {rounds} rounds")
    if not finite:
        failures.append("non-finite metric or params")
    if not all(v <= cfg.epsilon for v in m["eps_round"]):
        failures.append("eps_round above the per-round budget")
    if not repeat_bit_equal:
        failures.append("the ResNet-18 round does not repeat bit for bit")
    if not grad_gap <= CONV_GRAD_TOL:
        failures.append(f"the step gradient on the card is {grad_gap:.3g} "
                        f"of max|g| off the CPU's")
    # IID labels (50 draws over 62 classes) give a top share near 0.07
    if not line["label_skew"]["mean_top_class_share"] > 0.1:
        failures.append("the Dirichlet labels show no skew")
    del x, y, xt, yt, end, state, trainer, first, second, box
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# ------------------------------------------------------ the streamed bank

def _fl_run(trainer, state, x, y, rounds):
    """``trainer.run`` timed a round at a time on the host clock (each
    round ends in a synchronisation), with the run's peak memory."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]

    def on_round(t, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    end, metrics = trainer.run(state, x, y, rounds=rounds, on_round=on_round)
    torch.cuda.synchronize()
    return end, metrics, {
        "round_wall_s": [b - a for a, b in zip(marks, marks[1:])],
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _same_run(a, am, b, bm):
    """Params, prev_delta, every metric, and the bank, bit for bit."""
    import torch
    from repro_torch.tree import ravel
    same = {"params": torch.equal(ravel(a.params), ravel(b.params)),
            "prev_delta": torch.equal(a.prev_delta, b.prev_delta),
            "metrics": am.keys() == bm.keys() and all(
                torch.equal(am[k], bm[k]) for k in am),
            "lanes": torch.equal(a.bank.lanes.cpu(), b.bank.lanes.cpu()),
            "counts": torch.equal(a.bank.counts.cpu(), b.bank.counts.cpu())}
    if a.residuals is not None:
        same["residuals"] = torch.equal(a.residuals.cpu(),
                                        b.residuals.cpu())
    return same


def phase_streamed():
    """``bank_backend="streamed"`` against ``"resident"`` from the same
    state and key: the main path's config (VGG-11, N = 1000, 3 rounds;
    the streamed run first, with the data only in pinned host memory and
    the bank there too, then the resident one with the data on the card),
    and PFELS with error feedback at BENCH_CNN_CIFAR's width (N = 100, so
    that clients return and carry their residuals; the VGG-11 EF bank
    would take 36.9 GB of pinned host memory). Params, prev_delta,
    metrics, lanes, counts (and residuals) must be bit-equal."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import (BENCH_CNN_CIFAR, PAPER_VGG11_CIFAR10,
                                     PFELSConfig)
    from repro_torch.core.channel import scaled_channel
    from repro_torch.data import ArraySource, make_federated_classification
    from repro_torch.fl import Trainer
    from repro_torch.kernels.pfels_transmit import kernel
    from repro_torch.models import cnn

    failures = []
    runs = (("vgg11", PAPER_VGG11_CIFAR10, 1000, {}, 3),
            ("bench_cnn_ef", BENCH_CNN_CIFAR, 100,
             {"error_feedback": True}, 3))
    for label, cfg_m, n, extra, rounds in runs:
        params = cnn.init_cnn(prng.PRNGKey(0), cfg_m)
        d = sum(p.numel() for p in params.values())
        size = cfg_m.image_size
        x, y, _, _ = make_federated_classification(
            prng.PRNGKey(0), n_clients=n, per_client=50, num_classes=10,
            image_shape=(3, size, size))
        source = ArraySource(x, y)
        del x, y
        torch.cuda.empty_cache()
        lines = {}
        out = {}
        for backend in ("streamed", "resident"):
            cfg = PFELSConfig(num_clients=n, transmit_clip=0.25,
                              use_fused_kernel=True,
                              channel=scaled_channel(d),
                              bank_backend=backend, **extra)
            trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, cfg_m, b),
                              params)
            state = trainer.init(prng.PRNGKey(1))
            kernel.reset_launch_counts()
            if backend == "streamed":
                end, metrics, stats = _fl_run(trainer, state, source, None,
                                              rounds)
            else:
                x, y = source.x.cuda(), source.y.cuda()
                end, metrics, stats = _fl_run(trainer, state, x, y, rounds)
                del x, y
            stats["launches"] = dict(kernel.LAUNCHES)
            stats["bank_device"] = str(end.bank.counts.device)
            lines[backend] = stats
            out[backend] = (end, metrics)
            del trainer, state
        same = _same_run(*out["streamed"], *out["resident"])
        end, metrics = out["streamed"]
        counts = end.bank.counts
        line = {"phase": "streamed", "run": label, "model": cfg_m.name,
                "d": d, "n_clients": n, "r": cfg.clients_per_round,
                "rounds": rounds, **extra,
                "bit_equal": same, "streamed": lines["streamed"],
                "resident": lines["resident"],
                "clients_seen_twice": int((counts >= 2).sum()),
                "train_loss": [float(v) for v in metrics["train_loss"]],
                "finite": all(bool(torch.isfinite(v).all())
                              for v in metrics.values())}
        emit(line)
        if not all(same.values()):
            failures.append(f"{label}: streamed and resident differ: {same}")
        if not line["finite"]:
            failures.append(f"{label}: non-finite metric")
        if lines["streamed"]["bank_device"] != "cpu":
            failures.append(f"{label}: the streamed bank is not on the host")
        want = rounds if not extra else 0
        if lines["streamed"]["launches"]["fused_combine"] != rounds or \
                lines["streamed"]["launches"]["client_sumsq"] != want:
            failures.append(f"{label}: launched "
                            f"{lines['streamed']['launches']}")
        if extra and not line["clients_seen_twice"]:
            failures.append(f"{label}: no client came back, so no residual "
                            f"was carried")
        del out, end, metrics, source
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


# ------------------------------------------------- the training entry point

TRAIN_CLI_RUNS = (
    ("defaults", ["--rounds", "10", "--eval-every", "5"]),
    ("population", ["--model", "cnn", "--bank", "streamed", "--clients",
                    "100000", "--rounds", "3", "--eval-every", "3"]),
)


def phase_train_cli():
    """``python -m repro_torch.launch.train`` as a user runs it, in a
    process of its own: the reference's defaults for 10 rounds, and the
    population-scale use (BENCH_CNN_CIFAR, streamed bank, 100,000 clients
    made on demand). Each run's ``--out`` JSON (under ``experiments/``)
    must hold finite losses, accuracies in [0, 1] and the privacy
    totals."""
    out_dir = os.path.join(ROOT, "experiments", "train_cli")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    failures = []
    for label, argv in TRAIN_CLI_RUNS:
        path = os.path.join(out_dir, f"train_cli_{label}.json")
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--out", path], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train CLI {label} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        with open(path) as f:
            out = json.load(f)
        hist = out["history"]
        priv = out["privacy"]
        healthy = {
            "finite_losses": all(math.isfinite(h["train_loss"])
                                 for h in hist),
            "accuracies_in_unit_interval": all(0.0 <= h["test_acc"] <= 1.0
                                               for h in hist),
            "privacy_totals": all(
                k in priv for k in ("per_round_eps_max",
                                    "basic_composition",
                                    "advanced_composition"))
            and all(math.isfinite(v) for v in priv["basic_composition"]),
            "all_rounds": hist[-1]["round"] == out["config"]["rounds"] - 1}
        emit({"phase": "train_cli", "run": label, "argv": argv,
              "process_wall_s": wall, "train_wall_s": out["wall_s"],
              "config": out["config"], "history": hist,
              "energy_total": out["energy_total"], "privacy": priv,
              "healthy": healthy,
              "stdout_tail": proc.stdout.strip().splitlines()[-3:]})
        if not all(healthy.values()):
            failures.append(f"{label}: {healthy}")
    if failures:
        raise AssertionError("; ".join(failures))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def flash_launches_expected(cfg, decode_steps, prefix=True):
    """The flash kernel's launches of one prefill and ``decode_steps``
    decode steps: one a self-attention block in prefill (two under a VLM
    prefix: the prefix's rows, then the text rows), and for an
    encoder-decoder one an encoder block plus one a cross-attention in
    prefill and in every decode step (decode's self-attention runs plain
    ops)."""
    n_attn = sum(k != "mamba" for k in cfg.block_pattern) \
        * cfg.resolved_repeat()
    n = n_attn * (2 if cfg.family == "vlm" and prefix else 1)
    if cfg.is_encoder_decoder:
        n += cfg.n_encoder_layers + n_attn * (1 + decode_steps)
    return n


def launches_expected(cfg, decode_steps):
    n_mamba = cfg.block_pattern.count("mamba") * cfg.resolved_repeat()
    return {"ssd_scan": n_mamba,
            "flash_attention_fwd": flash_launches_expected(cfg,
                                                           decode_steps)}


def _serve_batch(cfg, batch, prompt, device):
    """The prompt's tokens and the family's stub prefix in f32, drawn on
    the CPU from fixed seeds and moved to ``device``."""
    from repro_torch import prng
    out = {"tokens": prng.randint(prng.PRNGKey(1, "cpu"), (batch, prompt),
                                  0, cfg.vocab_size)}
    if cfg.family == "vlm":
        out["vision_embeds"] = 0.02 * prng.normal(
            prng.PRNGKey(2, "cpu"), (batch, cfg.vision_prefix, cfg.d_model))
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = 0.02 * prng.normal(
            prng.PRNGKey(3, "cpu"), (batch, cfg.encoder_seq, cfg.d_model))
    return {k: v.to(device) for k, v in out.items()}


# the reduced configs of serve_parity_on_card: the hybrid and SSM ones,
# and the MoE (6 padded experts over 4), Whisper and VLM families
SERVE_PARITY = (("zamba2-2.7b", None), ("mamba2-130m", None),
                ("granite-moe-3b-a800m", 6), ("whisper-tiny", None),
                ("qwen2-vl-72b", None))


def phase_serve_parity():
    """The reduced configs in f32: prefill, 8 greedy decode steps, then 8
    sampled ones (``prng.categorical`` from one key a step) on the card
    (kernels) against the same params, prompt and prefix on the CPU (plain
    versions); the kernel launches on the card against those the config
    implies."""
    import dataclasses

    import torch
    from repro_torch import prng
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import transformer as T

    steps, tol = 8, 1e-4
    failures, lines = [], []
    for arch, padded in SERVE_PARITY:
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                                  param_dtype="float32")
        if padded:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, padded_experts=padded))
        params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
        runs = {}
        ssd_kernel.reset_launch_counts()
        flash_kernel.reset_launch_counts()
        for dev in ("cuda", "cpu"):
            p = _tree_to(params, dev)
            logits, caches, enc = T.prefill(
                p, cfg, _serve_batch(cfg, 4, 128, dev),
                extra_slots=2 * steps)
            out, tok = [logits.float().cpu()], torch.argmax(logits, dim=-1)
            toks_out = [tok.cpu()]
            for i in range(2 * steps):
                logits, caches = T.decode_step(p, cfg, tok, caches,
                                               enc_out=enc)
                if i < steps:
                    tok = torch.argmax(logits, dim=-1)
                else:
                    key = prng.fold_in(prng.PRNGKey(4, dev), i)
                    tok = prng.categorical(key, logits[:, -1])[:, None]
                out.append(logits.float().cpu())
                toks_out.append(tok.cpu())
            runs[dev] = (torch.stack(out), torch.cat(toks_out, dim=1))
            if dev == "cuda":
                launches = {**ssd_kernel.LAUNCHES, **flash_kernel.LAUNCHES}
        (lc, tc), (lp, tp) = runs["cuda"], runs["cpu"]
        gap = float((lc - lp).abs().max() / lp.abs().max())
        greedy_same = bool(torch.equal(tc[:, :steps + 1], tp[:, :steps + 1]))
        sampled_same = bool(torch.equal(tc[:, steps + 1:],
                                        tp[:, steps + 1:]))
        want = launches_expected(cfg, 2 * steps)
        lines.append({"arch": cfg.name, "padded_experts": padded,
                      "launches_on_card": launches,
                      "launches_expected": want,
                      "max_logit_gap_rel_to_max": gap,
                      "greedy_tokens_equal": greedy_same,
                      "sampled_tokens_equal": sampled_same})
        if launches != want:
            failures.append(f"{arch}: launched {launches}, expected {want}")
        if not (gap <= tol and greedy_same and sampled_same):
            failures.append(f"{arch}: the card and the CPU disagree")
    emit({"phase": "serve_parity_on_card", "problem": "reduced, f32, "
          "batch 4, prompt 128, 8 greedy then 8 sampled steps", "runs": lines,
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


# the serve phase's runs: (arch, depth (None: the whole stack), batch,
# prompt length, greedy tokens, sampled tokens); random bf16 weights from
# seed 0. qwen2-vl-72b runs 16 of its 80 layers: all 80 take about 145 GB
# in bf16, past one card's 80 GB
SERVE_RUNS = (("zamba2-2.7b", None, 8, 2048, 64, 0),
              ("mamba2-130m", None, 8, 2048, 64, 0),
              ("granite-moe-3b-a800m", None, 8, 2048, 64, 64),
              ("whisper-tiny", None, 8, 128, 64, 64),
              ("qwen2-vl-72b", 16, 4, 2048, 32, 0))


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


def phase_serve(profile: bool, predicted: dict):
    """The serving main paths through ``serve``, the entry point a user
    calls, at full width: greedy, then (where the run asks) sampled from
    the same params; the launch counters are zeroed just before each call
    and read just after, and each model is freed before the next. Then
    three warm zamba2-2.7b prefills, the first one's peak memory beside
    ``predicted`` (the dry run's record of that prefill; printed, not
    held), and one more prefill under the profiler (and, with
    ``profile``, 8 decode steps). Returns the launches of every call,
    summed by kernel, and by run."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    total = {"ssd_scan": 0, "flash_attention_fwd": 0}
    by_run = {}
    failures = []
    for arch, depth, batch, prompt_len, n_greedy, n_sampled in SERVE_RUNS:
        torch.cuda.empty_cache()
        params = None
        for greedy, new_tokens in ((True, n_greedy), (False, n_sampled)):
            if not new_tokens:
                continue
            torch.cuda.reset_peak_memory_stats()
            ssd_kernel.reset_launch_counts()
            flash_kernel.reset_launch_counts()
            t0 = time.perf_counter()
            r = serve(arch, reduced=False, batch=batch,
                      prompt_len=prompt_len, new_tokens=new_tokens, seed=0,
                      greedy=greedy, depth=depth, params=params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**ssd_kernel.LAUNCHES, **flash_kernel.LAUNCHES}
            peak = torch.cuda.max_memory_allocated()
            cfg = r["cfg"]
            if n_sampled:  # the sampled run serves the same params
                params = r["params"]
            want = launches_expected(cfg, new_tokens)
            vpad = layers.pad_vocab(cfg.vocab_size)
            toks = r["tokens"]
            finite = bool(torch.isfinite(r["logits"].float()).all())
            in_vocab = bool(((toks >= 0) & (toks < vpad)).all())
            shape_ok = tuple(toks.shape) == (batch, new_tokens)
            mode = "greedy" if greedy else "sampled"
            emit({"phase": "serve", "arch": arch, "mode": mode,
                  "batch": batch, "prompt_len": prompt_len,
                  "new_tokens": new_tokens, "dtype": cfg.dtype,
                  "n_layers": cfg.n_layers,
                  "params": T.param_count(T.init_params(None, cfg, "meta")),
                  "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
                  "decode_tok_per_s": r["tok_per_s"],
                  "decode_ms_per_step": r["decode_s"] / new_tokens * 1e3,
                  "wall_s_with_init": wall, "peak_memory_bytes": peak,
                  "moe_prefill_drop_fraction": r["drop_fraction"],
                  "launches": launches, "launches_expected": want,
                  "finite_logits": finite,
                  "tokens_in_padded_vocab": in_vocab,
                  "tokens_shape_ok": shape_ok,
                  "sample_tokens": toks[0, :12].tolist()})
            if launches != want:
                failures.append(f"{arch} ({mode}): launched {launches}, "
                                f"expected {want}")
            if not (finite and in_vocab and shape_ok):
                failures.append(f"{arch} ({mode}): bad output (finite "
                                f"{finite}, in vocab {in_vocab}, shape "
                                f"{shape_ok})")
            by_run[f"{arch} {mode}"] = launches
            for name, n in launches.items():
                total[name] += n
            del r
        del params
    torch.cuda.empty_cache()
    # more zamba2-2.7b prefills: three warm ones on the host clock (serve's
    # first prefill also pays first-call costs), then one under the
    # profiler: the flash kernel's device time and its share of the
    # prefill's device time
    pre, warm, peak = profile_serve("zamba2-2.7b", 8, 2048,
                                    steps=8 if profile else 0)
    pred_peak = predicted["memory"]["peak_bytes_per_device"]
    emit({"phase": "serve", "arch": "zamba2-2.7b",
          "what": "three warm prefills, then one profiled (batch 8, "
                  "prompt 2048)",
          "prefill_warm_s": warm, "prefill_peak_memory_bytes": peak,
          "predicted_prefill_peak_bytes": pred_peak,
          "peak_over_prediction": peak / pred_peak, **prefill_split(pre)})
    if failures:
        raise AssertionError("; ".join(failures))
    return total, by_run


# ----------------------------------------------------------- llm_train

# the production step's settings: the reference example's
# (examples/llm_finetune_fl.py) at zamba2-2.7b's full width; tau of each
# timed step in order
LLM_TRAIN_TAUS = (1, 1, 1, 2)
LLM_TRAIN_BATCH, LLM_TRAIN_SEQ = 8, 512
# the reduced config's step on the card against the CPU route, at the
# CPU tests' tolerances (tests/test_torch_llm_train.py): metrics 1e-5
# relative; theta 1e-4 of the leaf's largest update plus one f32 ulp
LLM_METRIC_RTOL, LLM_THETA_OF_UPDATE = 1e-5, 1e-4
# the masks' density: Bernoulli(p) over 2.9e9 coordinates, within 1% of p
LLM_MASK_DENSITY_TOL = 0.01
# a step's measured peak against the dry run's prediction: within 10% (the
# prediction counts the storages the step's ops create on the meta device,
# rounded to the allocator's 512-byte blocks; it does not see what a
# library allocates inside one op, cuBLAS's workspace, or the allocator
# handing out a cached block up to 1 MiB larger than asked)
DRYRUN_PEAK_TOL = 0.10
# granite-moe-3b-a800m's production step on the card: full width, at the
# deepest cut of its 32 layers whose predicted peak is at most this
GRANITE_ARCH = "granite-moe-3b-a800m"
GRANITE_LIMIT_BYTES = 70e9
GRANITE_STEPS = 3
# the reduced families' steps on the card against the CPU
LLM_PARITY_ARCHS = ("whisper-tiny", "qwen2-vl-72b")


def _pfels_llm_config(d, tau, n_clients=1):
    from repro_torch.configs import PFELSConfig
    from repro_torch.core.channel import scaled_channel
    return PFELSConfig(num_clients=1000, clients_per_round=n_clients,
                       compression_ratio=0.5, epsilon=4.0, local_lr=0.1,
                       local_steps=tau, channel=scaled_channel(d))


def _lm_batch(data, key, batch):
    """The example's draw: ``batch`` sequences of ``data`` at randint
    indices, split into tokens and next-token labels."""
    from repro_torch import prng
    seqs = data[prng.randint(key, (batch,), 0, data.shape[0])].long()
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def _stub_embeds(cfg, batch):
    """The VLM's vision prefix or Whisper's audio frames of a train
    batch, 0.02 N(0, 1) drawn on the CPU from a seed (the stub inputs of
    the serving path); none for the other families."""
    from repro_torch import prng
    out = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = 0.02 * prng.normal(
            prng.PRNGKey(4, "cpu"), (batch, cfg.vision_prefix, cfg.d_model))
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = 0.02 * prng.normal(
            prng.PRNGKey(5, "cpu"), (batch, cfg.encoder_seq, cfg.d_model))
    return out


def llm_train_parity(arch="zamba2-2.7b", n_clients=1, phase="llm_train"):
    """One production step of the reduced ``arch`` in f32 on the card
    (the clip kernel) against the CPU route (its plain version), from the
    same params, batch and key (with the VLM's vision prefix or Whisper's
    audio frames); with ``n_clients`` > 1 the multi-pod step from the
    params copied to each client."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import convert, prng
    from repro_torch.configs import reduced_config
    from repro_torch.data import make_lm_sequences
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.launch.steps import (clientize_params,
                                          make_pfels_train_step)
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduced_config(arch),
                              dtype="float32", param_dtype="float32")
    params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    d = T.param_count(params)
    if n_clients > 1:
        params = clientize_params(params, n_clients)
    data = make_lm_sequences(prng.PRNGKey(1, "cpu"), n_seqs=16, seq_len=65,
                             vocab=cfg.vocab_size)
    batch = dict(_lm_batch(data, prng.PRNGKey(2, "cpu"), 8),
                 **_stub_embeds(cfg, 8))
    step = make_pfels_train_step(cfg, _pfels_llm_config(d, 1, n_clients), d,
                                 n_clients=n_clients)
    out = {}
    clip_kernel.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        new, m = step(_tree_to(params, dev), _tree_to(batch, dev),
                      prng.PRNGKey(3, dev))
        out[dev] = (dict(convert._walk(_tree_to(new, "cpu"))),
                    {k: float(v) for k, v in m.items()})
        if dev == "cuda":
            launches = clip_kernel.LAUNCHES["clip_norm"]
    (tc, mc), (tp, mp) = out["cuda"], out["cpu"]
    metric_gaps = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30)
                   for k in ("loss", "grad_norm", "beta", "energy")}
    worst = 0.0
    for name, before in convert._walk(params):
        want = tp[name].float().numpy()
        scale = float(np.abs(want - before.float().numpy()).max())
        gap = np.abs(tc[name].float().numpy() - want)
        limit = LLM_THETA_OF_UPDATE * scale + np.spacing(np.abs(want))
        worst = max(worst, float((gap / limit).max()))
    line = {"phase": phase, "part": "reduced parity on the card",
            "arch": cfg.name, "dtype": cfg.dtype, "d": d,
            "n_clients": n_clients,
            "launches_on_card": {"clip_norm": launches},
            "metric_rel_gaps": metric_gaps,
            "theta_gap_over_limit": worst,
            "tolerance": f"metrics {LLM_METRIC_RTOL} relative; theta "
                         f"{LLM_THETA_OF_UPDATE} of the leaf's largest "
                         f"update plus one f32 ulp"}
    emit(line)
    failures = []
    if launches != n_clients:
        failures.append(f"reduced step launched clip_norm {launches} "
                        f"times, expected {n_clients}")
    if not (max(metric_gaps.values()) <= LLM_METRIC_RTOL and worst <= 1.0):
        failures.append("reduced step: the card and the CPU disagree")
    if failures:
        raise AssertionError("; ".join(failures))


MULTI_POD_ARCH, MULTI_POD_CLIENTS, MULTI_POD_STEPS = "mamba2-130m", 2, 3


def phase_multi_pod():
    """The multi-pod production step (``make_pfels_train_step`` with
    ``n_clients`` 2: a client dim on every param, each client's local
    update on its half of the batch, the AirComp sum over the clients):
    first the reduced config on the card against the CPU, then
    mamba2-130m at its full published width and depth (its dtype, random
    weights from seed 0, the example's settings, batch 8 x 512 tokens,
    4 rows a client), ``MULTI_POD_STEPS`` steps at tau = 1: s/step, the
    steps' peak memory, the ``clip_norm`` launches (once a client a local step) and
    finite metrics and params; then, for comparison, one single-client
    step on one client's slice (its time and peak). Returns the multi-pod
    steps' launches."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_sequences
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.launch.steps import (clientize_params,
                                          make_pfels_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    llm_train_parity(MULTI_POD_ARCH, MULTI_POD_CLIENTS, phase="sharded")
    n = MULTI_POD_CLIENTS
    cfg = get_config(MULTI_POD_ARCH)
    key = prng.PRNGKey(0)
    torch.cuda.empty_cache()
    params = T.init_params(key, cfg)
    d = T.param_count(params)
    params = clientize_params(params, n)
    data = make_lm_sequences(prng.PRNGKey(1), n_seqs=2 * LLM_TRAIN_BATCH,
                             seq_len=LLM_TRAIN_SEQ + 1, vocab=cfg.vocab_size)
    step = make_pfels_train_step(cfg, _pfels_llm_config(d, 1, n), d,
                                 n_clients=n)
    keys = [prng.fold_in(key, i) for i in range(MULTI_POD_STEPS)]
    batches = [_lm_batch(data, k, LLM_TRAIN_BATCH) for k in keys]
    torch.cuda.synchronize()
    # the steps' own peak: make_lm_sequences' (vocab, vocab) f32 logits
    # (50,280^2 x 4 bytes = 10.1 GB) and their temporaries are freed
    torch.cuda.reset_peak_memory_stats()
    clip_kernel.reset_launch_counts()
    secs, metrics = [], []
    for batch, k in zip(batches, keys):
        t0 = time.perf_counter()
        params, m = step(params, batch, k)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({name: float(v) for name, v in m.items()})
    launches = clip_kernel.LAUNCHES["clip_norm"]
    expected = n * MULTI_POD_STEPS
    peak = torch.cuda.max_memory_allocated()
    finite_params = all(bool(torch.isfinite(x).all())
                        for x in tree_leaves(params))
    replicas_equal = all(bool(torch.equal(x[0], x[i]))
                         for x in tree_leaves(params) for i in range(1, n))
    finite = all(math.isfinite(m[k]) for m in metrics
                 for k in ("loss", "grad_norm", "beta", "energy"))
    # one client's own step on its slice of the first batch, beside
    single = make_pfels_train_step(cfg, _pfels_llm_config(d, 1), d)
    one = tree_map(lambda x: x[0].clone(), params)
    half = {k: v[:LLM_TRAIN_BATCH // n] for k, v in batches[0].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    single(one, half, keys[0])
    torch.cuda.synchronize()
    single_client = {"s": time.perf_counter() - t0,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del one
    emit({"phase": "sharded", "part": "multi-pod step, full width",
          "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "d": d,
          "n_clients": n, "batch": LLM_TRAIN_BATCH, "seq": LLM_TRAIN_SEQ,
          "tau": 1, "s_per_step": secs, "peak_memory_bytes": peak,
          "launches": {"clip_norm": launches},
          "launches_expected": {"clip_norm": expected},
          "metrics": metrics, "finite_metrics": finite,
          "finite_params": finite_params,
          "client_replicas_equal": replicas_equal,
          "single_client_step_on_one_slice": single_client,
          "seconds": time.perf_counter() - t_phase})
    del params, data, batches
    torch.cuda.empty_cache()
    if launches != expected or not (finite and finite_params
                                    and replicas_equal):
        raise AssertionError(f"multi-pod step: clip_norm launched "
                             f"{launches} times (expected {expected}), "
                             f"finite {finite} and {finite_params}, "
                             f"replicas equal {replicas_equal}")
    return launches


def check_clip_flat(n, seed):
    """``clip_norm`` on a flat f32 vector of ``n`` elements (zamba2-2.7b's
    gradient, padded to whole rows): against its plain version (compared
    in slices, so that no full-size difference is held), bit-identical run
    to run, timed beside the plain version and ``vector_norm``. At 11.6 GB
    x cannot stay on chip between the passes: the bound counts x read once
    and out written once all the same."""
    import torch
    from repro_torch.kernels.clip_norm import kernel, ref
    clip = 1.0
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n // 128, 128), generator=g, device="cuda")
    x.mul_(1e-4)
    o1, n1 = kernel.clip_norm(x, clip)
    o_p, n_p = ref.clip_norm_ref(x, clip)
    torch.cuda.synchronize()
    err = rel = 0.0
    step = 1 << 26
    f1, fp = o1.view(-1), o_p.view(-1)
    for a in range(0, n, step):
        diff = (f1[a:a + step] - fp[a:a + step]).abs()
        err = max(err, float(diff.max()))
        rel = max(rel, float((diff / fp[a:a + step].abs().clamp_min(
            1e-30)).max()))
    del o_p, f1, fp
    o2, n2 = kernel.clip_norm(x, clip)
    bit = bool(torch.equal(o1, o2) and torch.equal(n1, n2))
    del o1, o2
    norm_rel = abs(float(n1) - float(n_p)) / float(n_p)
    fns = {"kernel": lambda: kernel.clip_norm(x, clip),
           "plain": lambda: ref.clip_norm_ref(x, clip),
           "library_first_pass": lambda: torch.linalg.vector_norm(x)}
    times = {k: time_ms(f, reps=10, warmup=2) for k, f in fns.items()}
    n_bytes, flops = kernel.work(n, 4)
    bound, by = bound_ms(n_bytes, flops)
    line = {"phase": "kernels", "kernel": "clip_norm",
            "shape": {"R": n // 128, "lanes": 128, "elements": n},
            "dtype": "float32", "what": "zamba2-2.7b's flat gradient",
            "clip": clip, "norm": float(n1), "norm_rel_gap": norm_rel,
            "out_max_rel_gap": rel, "out_max_abs_err": err,
            "bit_identical": bit, "times_ms": times, "bytes": n_bytes,
            "bound_ms": bound, "share_of_bound": bound / times["kernel"],
            "tolerance": f"norm 1e-6 relative; output "
                         f"{CLIP_OUT_TOL['float32']} relative",
            "library": "torch.linalg.vector_norm: the first pass (the "
                       "norm) only"}
    emit(line)
    del x
    torch.cuda.empty_cache()
    if not (norm_rel <= 1e-6 and rel <= CLIP_OUT_TOL["float32"] and bit):
        raise AssertionError(f"clip_norm at {n} elements: norm gap "
                             f"{norm_rel}, output gap {rel}, bit-identical "
                             f"{bit}")
    return {"max_abs_err": err, "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": times["library_first_pass"],
            "elements": n}


def _check_peak(peak, predicted, what):
    """A failure message unless the measured peak is within
    ``DRYRUN_PEAK_TOL`` of the dry run's prediction."""
    if abs(peak - predicted) <= DRYRUN_PEAK_TOL * predicted:
        return []
    return [f"{what}: peak {peak} bytes, predicted {predicted} (limit "
            f"{DRYRUN_PEAK_TOL:.0%})"]


def phase_llm_train(profile: bool, predicted: dict):
    """PFELS as the optimizer of zamba2-2.7b at full width and depth
    (bf16, random weights from seed 0; the example's settings, batch 8 x
    512 tokens drawn by ``make_lm_sequences`` on the card): 3 steps at
    tau = 1 and 1 at tau = 2, timed; the clip_norm launches (zeroed just
    before, read just after) must equal the sum of tau; the metrics finite
    and the masks' density within 1% of p; the tau = 1 steps' peak (reset
    after the data are made) within ``DRYRUN_PEAK_TOL`` of ``predicted``,
    the dry run's record of that step, and the tau = 2 step's own peak
    beside it. With ``profile``, one more tau = 1 step profiled and its
    parts timed one by one. First the reduced config's step against the
    CPU; last the clip kernel at the gradient's flat size. Returns
    (clip_norm launches, the kernel's summary entry)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import randk
    from repro_torch.data import make_lm_sequences
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.launch.steps import make_pfels_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    llm_train_parity()
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-2.7b")
    key = prng.PRNGKey(0)
    t0 = time.perf_counter()
    params = T.init_params(key, cfg)
    d = T.param_count(params)
    data = make_lm_sequences(prng.PRNGKey(1), n_seqs=2 * LLM_TRAIN_BATCH,
                             seq_len=LLM_TRAIN_SEQ + 1, vocab=cfg.vocab_size)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pfels = {tau: _pfels_llm_config(d, tau) for tau in set(LLM_TRAIN_TAUS)}
    steps = {tau: make_pfels_train_step(cfg, pf, d)
             for tau, pf in pfels.items()}
    keys = [prng.fold_in(key, i) for i in range(len(LLM_TRAIN_TAUS))]
    batches = [_lm_batch(data, k, LLM_TRAIN_BATCH) for k in keys]
    torch.cuda.synchronize()
    # the steps' own peaks: make_lm_sequences' (vocab, vocab) f32 logits
    # and the init's temporaries are freed by now
    torch.cuda.reset_peak_memory_stats()
    clip_kernel.reset_launch_counts()
    secs, metrics, peaks = [], [], {}
    for tau, batch, k in zip(LLM_TRAIN_TAUS, batches, keys):
        if tau != 1 and 1 not in peaks:
            peaks[1] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, m = steps[tau](params, batch, k)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({n: float(v) for n, v in m.items()})
    launches = clip_kernel.LAUNCHES["clip_norm"]
    peaks[max(LLM_TRAIN_TAUS)] = torch.cuda.max_memory_allocated()
    pred_peak = predicted["memory"]["peak_bytes_per_device"]
    finite_params = all(bool(torch.isfinite(x).all())
                        for x in tree_leaves(params))
    finite = all(math.isfinite(m[n]) for m in metrics
                 for n in ("loss", "grad_norm", "beta", "energy"))
    # the last step's masks, drawn again from its key
    _, km, _ = prng.split(keys[-1], 3)
    masks = randk.mask_tree(km, params, pfels[1].compression_ratio)
    density = float(sum(torch.count_nonzero(m) for m in
                        tree_leaves(masks))) / d
    del masks
    smi = nvidia_smi()
    line = {"phase": "llm_train", "part": "full width", "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "d": d, "batch": LLM_TRAIN_BATCH,
            "seq": LLM_TRAIN_SEQ, "taus": list(LLM_TRAIN_TAUS),
            "compression_ratio": pfels[1].compression_ratio,
            "setup_s": setup_s, "s_per_step": secs,
            "peak_memory_bytes_tau1_steps": peaks[1],
            "predicted_peak_bytes_tau1": pred_peak,
            "peak_over_prediction": peaks[1] / pred_peak,
            "peak_tolerance": f"{DRYRUN_PEAK_TOL:.0%} of the prediction",
            "peak_memory_bytes_tau2_step": peaks[2],
            "step_share_of_bf16_peak": [
                predicted["model_flops_per_device"]
                / (t * PEAK_BF16_FLOP_PER_S)
                for t, tau in zip(secs, LLM_TRAIN_TAUS) if tau == 1],
            "launches": {"clip_norm": launches},
            "launches_expected": {"clip_norm": sum(LLM_TRAIN_TAUS)},
            "metrics": metrics, "finite_metrics": finite,
            "finite_params": finite_params, "mask_density": density,
            "nvidia_smi": smi}
    emit(line)
    failures = []
    if launches != sum(LLM_TRAIN_TAUS):
        failures.append(f"clip_norm launched {launches} times, expected "
                        f"{sum(LLM_TRAIN_TAUS)}")
    if not (finite and finite_params):
        failures.append("non-finite metrics or params")
    p = pfels[1].compression_ratio
    if not abs(density - p) <= LLM_MASK_DENSITY_TOL * p:
        failures.append(f"mask density {density}, p {p}")
    failures += _check_peak(peaks[1], pred_peak, "zamba2-2.7b tau = 1 steps")
    if failures:
        raise AssertionError("; ".join(failures))
    if profile:
        profile_llm_step(cfg, params, pfels[1], steps[1], batches[0],
                         keys[0], d, smi)
    layout_padded = -(-d // 128) * 128
    del params, data, batches
    torch.cuda.empty_cache()
    summary = check_clip_flat(layout_padded, seed=31)
    emit({"phase": "llm_train", "seconds": time.perf_counter() - t_phase})
    return launches, summary


def profile_llm_step(cfg, params, pfels, step, batch, k, d, smi):
    """``--profile``: one more tau = 1 step under the profiler (device
    busy time and idle share), then its parts timed one by one."""
    import torch
    from repro_torch import prng
    from repro_torch.core import aggregation, randk
    from repro_torch.core.clipping import FlatTree, clip_tree_flat
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.launch.steps import _round_channel, make_train_loss_step
    prof = profile_call("zamba2-2.7b PFELS step, tau 1, batch 8 x 512",
                        lambda: step(params, batch, k), top=15)
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return out

    _, _, grads = timed("forward_backward", lambda: make_train_loss_step(
        cfg)(params, batch))
    layout = FlatTree(grads)
    flat = timed("gather_f32", lambda: layout.gather(grads))
    timed("clip_kernel", lambda: clip_kernel.clip_norm(
        flat.view(-1, 128), 1.0))
    del flat
    update, _, _ = timed("clip_tree_flat", lambda: clip_tree_flat(
        grads, pfels.clip))
    del grads
    kc, km, kn = prng.split(k, 3)
    _, beta = _round_channel(kc, pfels, d, 1)
    utree = layout.tree(update)
    masks = timed("mask_tree", lambda: randk.mask_tree(
        km, utree, pfels.compression_ratio))
    timed("production_aggregate",
          lambda: aggregation.pfels_production_aggregate(
              utree, masks, beta=beta, r=1, sigma0=pfels.channel.noise_std,
              noise_key=kn))
    del update, utree, masks
    emit({"phase": "llm_train", "part": "split of one tau = 1 step",
          "step_wall_s": prof["wall_s"],
          "step_device_busy_s": prof["device_busy_s"],
          "device_idle_share": prof["device_idle_share"],
          "parts_s": parts, "nvidia_smi": smi})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- draws

DRAWS_N = 1 << 24
DRAWS_GAMMA_N = 1 << 18
DRAWS_DIRICHLET_ROWS = (1 << 18) // 62


def _bit_mismatches(a, b) -> int:
    """Elements of a (the card's, moved to the CPU) and b (the CPU's)
    whose bits differ; NaNs of any payload count as equal."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} against "
                             f"{tuple(b.shape)} {b.dtype}")
    if not a.dtype.is_floating_point:
        return int((a != b).sum())
    iview = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float64: torch.int64}[a.dtype]
    nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(iview) != b.view(iview)) & ~nan).sum())


def phase_draws():
    """The port's draws and XLA-CPU f32 functions on the card against the
    CPU route, bit for bit: one line a case with its size, its mismatches
    and the seconds of the card's and the CPU's call, then the phase's
    line. Any mismatch raises."""
    import torch
    from repro_torch import prng, xla_samples
    from repro_torch.configs import ChannelConfig
    from repro_torch.core.channels import markov
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or threads)
    t0 = time.perf_counter()
    n, ng = DRAWS_N, DRAWS_GAMMA_N
    mcfg = ChannelConfig(model="markov_fading", markov_rho=0.9)

    def key(dev, seed=0):
        return prng.PRNGKey(seed, dev)

    def markov_step(dev):
        carry = prng.normal(key(dev, 1), (n,))
        sel = torch.arange(0, n, 4096, device=dev)
        z, cr = markov._step(carry, mcfg, int(sel.numel()), sel,
                             key(dev, 2), key(dev, 3))
        return torch.cat([z, cr.gains])

    cases = [
        ("uniform", n, lambda d: prng.uniform(key(d), (n,))),
        ("normal_f32", n, lambda d: prng.normal(key(d), (n,))),
        ("normal_bf16", n,
         lambda d: prng.normal(key(d), (n,), dtype=torch.bfloat16)),
        ("normal_fma", n, lambda d: prng.normal_fma(
            key(d), (n,), 0.7, prng.uniform(key(d, 9), (n,)))),
        ("exponential", n, lambda d: prng.exponential(key(d), (n,))),
    ]
    for alpha in (0.1, 0.5, 1.0, 3.0):
        cases += [(f"gamma_{alpha}", ng,
                   lambda d, a=alpha: prng.gamma(key(d), a, (ng,))),
                  (f"loggamma_{alpha}", ng,
                   lambda d, a=alpha: prng.loggamma(key(d), a, (ng,)))]
    cases += [
        ("dirichlet_0.5x62", DRAWS_DIRICHLET_ROWS * 62,
         lambda d: prng.dirichlet(key(d), torch.full((62,), 0.5, device=d),
                                  (DRAWS_DIRICHLET_ROWS,))),
        ("markov_gains", n, lambda d: markov._gains_from_latent(
            prng.normal(key(d, 4), (n,)), mcfg)),
        ("markov_step", n + n // 4096, markov_step),
    ]
    for name, (fn, _, _) in sorted(xla_samples.FUNCTIONS.items()):
        x = torch.from_numpy(xla_samples.sample(name))
        cases.append((f"{fn}_stratified", x.numel(),
                      lambda d, f=getattr(prng, fn), x=x: f(x.to(d))))
    total = 0
    for name, size, fn in cases:
        t1 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = fn("cpu")
        t3 = time.perf_counter()
        bad = _bit_mismatches(got.cpu(), want)
        total += bad
        emit({"phase": "draws", "draw": name, "n": size,
              "mismatches": bad, "seconds_card": t2 - t1,
              "seconds_cpu": t3 - t2})
        del got, want
    torch.set_num_threads(threads)
    emit({"phase": "draws", "cases": len(cases), "mismatches_total": total,
          "seconds": time.perf_counter() - t0})
    if total:
        raise AssertionError(f"{total} draws differ between the card and "
                             f"the CPU")


# ------------------------------------------------------------ the dry run

def _dryrun_job(job):
    """One prediction in a worker process: ``job`` = (label, arch, kind,
    seq, batch, depth or None) -> ``launch.dryrun.dryrun_one``'s record
    of the step on the meta device, on a one-device mesh (the train step
    with ``_pfels_llm_config``'s settings at tau = 1)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import transformer as T
    label, arch, kind, seq, batch, depth = job
    cfg = get_config(arch)
    if depth is not None:
        cfg = cut_depth(cfg, depth)
    pfels = None
    if kind == "train":
        pfels = _pfels_llm_config(T.param_count(T.init_shapes(cfg)), 1)
    return dryrun.dryrun_one(arch, InputShape(label, seq, batch, kind),
                             mesh=make_host_mesh((1, 1)), cfg=cfg,
                             pfels=pfels, verbose=False)


def _prediction(predicts, rec, **extra):
    line = {"phase": "dryrun", "predicts": predicts, "arch": rec["arch"],
            "kind": rec["step_kind"], "n_layers": rec["n_layers"],
            "batch": rec["global_batch"], "seq": rec["seq_len"],
            "d": rec["n_params"], "device": rec["device"],
            "peak_bytes": rec["memory"]["peak_bytes_per_device"],
            "argument_bytes": rec["memory"]["argument_bytes_one_device"],
            "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes"],
            "model_flops": rec["model_flops_per_device"],
            "useful_flops_ratio": rec["useful_flops_ratio"],
            "t_compute_s": rec["roofline"]["t_compute_s"],
            "t_memory_s": rec["roofline"]["t_memory_s"],
            "dominant": rec["roofline"]["dominant"], "ops": rec["ops"],
            "build_s": rec["build_s"], "kernels": rec["kernels"]}
    line.update(extra)
    emit(line)


def phase_dryrun():
    """Predictions of the runs below, before they run, by
    ``repro_torch.launch.dryrun.dryrun_one`` on the meta device with a
    one-device mesh, in parallel worker processes: zamba2-2.7b's
    production step at 8 x 512 and tau = 1 (``llm_train``), its serve
    prefill at 8 x 2048 (``serve``), and granite-moe-3b-a800m's step at
    8 x 512, tau = 1, at every depth from its full 32 layers down until
    one is predicted to peak at no more than ``GRANITE_LIMIT_BYTES``: the
    deepest such is the depth its card run takes. Returns the three
    records."""
    import multiprocessing

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    n_workers = max(3, min(8, os.cpu_count() or 3))
    fixed = [("llm_train", "zamba2-2.7b", "train", LLM_TRAIN_SEQ,
              LLM_TRAIN_BATCH, None),
             ("serve_prefill", "zamba2-2.7b", "prefill", 2048, 8, None)]
    full = get_config(GRANITE_ARCH).n_layers
    depths = list(range(full, 0, -1))
    searched, chosen = {}, None
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n_workers) as pool:
        pending = [pool.apply_async(_dryrun_job, (j,)) for j in fixed]
        width = n_workers - len(fixed)
        while chosen is None and depths:
            batch, depths = depths[:width], depths[width:]
            recs = pool.map(_dryrun_job, [
                ("granite_train", GRANITE_ARCH, "train", LLM_TRAIN_SEQ,
                 LLM_TRAIN_BATCH, n) for n in batch])
            searched.update(zip(batch, recs))
            fits = [n for n in batch if searched[n]["memory"][
                "peak_bytes_per_device"] <= GRANITE_LIMIT_BYTES]
            chosen = max(fits) if fits else None
            width = n_workers
        zamba_train, zamba_prefill = (p.get() for p in pending)
    if chosen is None:
        raise AssertionError(f"no depth of {GRANITE_ARCH} is predicted to "
                             f"fit {GRANITE_LIMIT_BYTES} bytes")
    _prediction("llm_train: zamba2-2.7b production step, tau 1",
                zamba_train)
    _prediction("serve: zamba2-2.7b prefill", zamba_prefill)
    _prediction(f"llm_train: {GRANITE_ARCH} production step, tau 1, at "
                f"{chosen} of {full} layers", searched[chosen],
                limit_bytes=GRANITE_LIMIT_BYTES, full_n_layers=full,
                peak_bytes_by_n_layers={
                    n: r["memory"]["peak_bytes_per_device"]
                    for n, r in sorted(searched.items())},
                deeper_predicted_above_limit=all(
                    searched[n]["memory"]["peak_bytes_per_device"]
                    > GRANITE_LIMIT_BYTES for n in searched if n > chosen))
    emit({"phase": "dryrun", "workers": n_workers,
          "seconds": time.perf_counter() - t0})
    return {"llm_train": zamba_train, "serve_prefill": zamba_prefill,
            "granite_train": searched[chosen]}


def _expandable_segments(on: bool) -> None:
    """The caching allocator's expandable segments, on or off for the
    segments it makes from now on."""
    import torch
    setting = f"expandable_segments:{on}"
    fn = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    if fn is not None:
        fn(setting)
    else:
        torch.cuda.memory._set_allocator_settings(setting)


def phase_llm_train_families(predicted: dict):
    """granite-moe-3b-a800m's production step on the card
    (``make_pfels_train_step``): full width (d_model 1536, 40 experts
    top-8 padded to 48, bf16, random weights from seed 0) at the depth
    the dry run chose, the example's settings, batch 8 x 512 tokens drawn
    by ``make_lm_sequences``, ``GRANITE_STEPS`` steps at tau = 1: s/step,
    the steps' peak (reset after the data are made) within
    ``DRYRUN_PEAK_TOL`` of the prediction, the step's share of the bf16
    peak (the prediction's model FLOPs over s/step x 989 TFLOP/s), the
    ``clip_norm`` launches (zeroed just before, read just after: one a
    step), finite metrics and params, and the masks' density within 1%
    of p. The steps run with the allocator's expandable segments (from an
    empty cache): without them, on an NVIDIA H100 80GB HBM3 at 700 W, the
    aggregate's per-leaf f64 temporaries of the 1.1e9-element expert
    tensors left 19.7 GiB reserved but free in pieces, and an 8.2 GiB
    block found no room below the predicted peak. Then one step of the reduced whisper-tiny and qwen2-vl-72b on
    the card against the CPU. Returns the granite steps' launches."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _expandable_segments(True)
    try:
        launches = _granite_steps(predicted)
    finally:
        torch.cuda.empty_cache()
        _expandable_segments(False)
    for arch in LLM_PARITY_ARCHS:
        llm_train_parity(arch)
    emit({"phase": "llm_train", "part": "families",
          "seconds": time.perf_counter() - t_phase})
    return launches


def _granite_steps(predicted: dict) -> int:
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import randk
    from repro_torch.data import make_lm_sequences
    from repro_torch.kernels.clip_norm import kernel as clip_kernel
    from repro_torch.launch.serve import cut_depth
    from repro_torch.launch.steps import make_pfels_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    full = get_config(GRANITE_ARCH)
    cfg = cut_depth(full, predicted["n_layers"])
    key = prng.PRNGKey(0)
    t0 = time.perf_counter()
    params = T.init_params(key, cfg)
    d = T.param_count(params)
    data = make_lm_sequences(prng.PRNGKey(1), n_seqs=2 * LLM_TRAIN_BATCH,
                             seq_len=LLM_TRAIN_SEQ + 1, vocab=cfg.vocab_size)
    pfels = _pfels_llm_config(d, 1)
    step = make_pfels_train_step(cfg, pfels, d)
    keys = [prng.fold_in(key, i) for i in range(GRANITE_STEPS)]
    batches = [_lm_batch(data, k, LLM_TRAIN_BATCH) for k in keys]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    clip_kernel.reset_launch_counts()
    secs, metrics = [], []
    for batch, k in zip(batches, keys):
        t0 = time.perf_counter()
        params, m = step(params, batch, k)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({n: float(v) for n, v in m.items()})
    launches = clip_kernel.LAUNCHES["clip_norm"]
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    finite_params = all(bool(torch.isfinite(x).all())
                        for x in tree_leaves(params))
    finite = all(math.isfinite(m[n]) for m in metrics
                 for n in ("loss", "grad_norm", "beta", "energy"))
    _, km, _ = prng.split(keys[-1], 3)
    masks = randk.mask_tree(km, params, pfels.compression_ratio)
    density = float(sum(torch.count_nonzero(m) for m in
                        tree_leaves(masks))) / d
    del masks
    pred_peak = predicted["memory"]["peak_bytes_per_device"]
    s_step = statistics.median(secs)
    emit({"phase": "llm_train", "part": "full width", "arch": cfg.name,
          "n_layers": cfg.n_layers, "full_n_layers": full.n_layers,
          "cut": f"{cfg.n_layers} of {full.n_layers} layers, every width "
                 f"kept (the deepest the dry run predicts at most "
                 f"{GRANITE_LIMIT_BYTES:.0f} bytes)",
          "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
          "experts_padded": cfg.moe.experts_padded(1),
          "top_k": cfg.moe.top_k, "dtype": cfg.dtype, "d": d,
          "batch": LLM_TRAIN_BATCH, "seq": LLM_TRAIN_SEQ, "tau": 1,
          "compression_ratio": pfels.compression_ratio,
          "setup_s": setup_s, "s_per_step": secs,
          "peak_memory_bytes": peak, "predicted_peak_bytes": pred_peak,
          "peak_over_prediction": peak / pred_peak,
          "peak_reserved_bytes": peak_reserved,
          "allocator": "expandable segments",
          "peak_tolerance": f"{DRYRUN_PEAK_TOL:.0%} of the prediction",
          "model_flops_per_step": predicted["model_flops_per_device"],
          "step_share_of_bf16_peak":
              predicted["model_flops_per_device"]
              / (s_step * PEAK_BF16_FLOP_PER_S),
          "launches": {"clip_norm": launches},
          "launches_expected": {"clip_norm": GRANITE_STEPS},
          "metrics": metrics, "finite_metrics": finite,
          "finite_params": finite_params, "mask_density": density,
          "nvidia_smi": nvidia_smi()})
    del params, data, batches
    torch.cuda.empty_cache()
    failures = []
    if launches != GRANITE_STEPS:
        failures.append(f"{GRANITE_ARCH}: clip_norm launched {launches} "
                        f"times, expected {GRANITE_STEPS}")
    if not (finite and finite_params):
        failures.append(f"{GRANITE_ARCH}: non-finite metrics or params")
    p = pfels.compression_ratio
    if not abs(density - p) <= LLM_MASK_DENSITY_TOL * p:
        failures.append(f"{GRANITE_ARCH}: mask density {density}, p {p}")
    failures += _check_peak(peak, pred_peak, f"{GRANITE_ARCH} steps")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


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
    pre, warm, _ = profile_serve("zamba2-2.7b", 8, 2048, steps=0)
    line["zamba2_prefill"] = {"warm_s": warm, **prefill_split(pre)}
    emit(line)


def _warm_cold(fn):
    return {"warm_ms": time_ms(fn), "cold_ms": cold_ms(fn)}


def phase_row_timing():
    """``--time-rows``: the three row kernels alone at the VGG-11 shapes,
    warm and cold L2 (the gather in f32 and bf16, with a tensor and a
    number scale, beside ``index_select`` alone and the device kernels of
    one call), then the ``kernel_api`` chain three times. It uses only
    what every tree of the port has, so a parent commit is measured by
    copying this script into its checkout and running it there and here
    in turns, in one call."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.aircomp_combine import kernel as comb
    from repro_torch.kernels.clip_norm import kernel as clip
    from repro_torch.kernels.randk_gather import kernel as gather
    t0 = time.perf_counter()
    _build.build([m.SOURCE for m in (clip, gather, comb)])
    line = {"phase": "row_timing", "tree": ROOT,
            "build_s": time.perf_counter() - t0}
    k_rows = MAIN_K // 128
    x = _randn((VGG_ROWS, 128), 21, scale=0.01)
    line["clip_norm"] = _warm_cold(lambda: clip.clip_norm(x, 0.25))
    del x
    idx = _row_indices(VGG_ROWS, k_rows, 22)
    t_scale = torch.tensor(GATHER_SCALE, device="cuda")
    for dtype in ("float32", "bfloat16"):
        delta = _randn((VGG_ROWS, 128), 22, dtype, scale=0.01)
        elem = delta.element_size()
        fns = {"tensor_scale": lambda: gather.randk_gather(delta, idx,
                                                           t_scale),
               "number_scale": lambda: gather.randk_gather(delta, idx,
                                                           GATHER_SCALE),
               "index_select": lambda: torch.index_select(delta, 0, idx)}
        entry = {k: _warm_cold(f) for k, f in fns.items()}
        # the same bytes moved by one contiguous copy, and the gather and
        # the copy after a flush that leaves L2 clean
        src = delta[:k_rows]
        dst = torch.empty_like(src)
        entry["copy_same_bytes"] = _warm_cold(lambda: dst.copy_(src))
        entry["cold_ms_clean_l2"] = {
            "tensor_scale": cold_ms(fns["tensor_scale"], read=True),
            "copy_same_bytes": cold_ms(lambda: dst.copy_(src), read=True)}
        del src, dst
        entry["bound_ms"] = bound_ms(*gather.work(k_rows, elem))[0]
        entry["device_kernels_per_call"] = {
            k: device_kernels(fns[k]) for k in ("tensor_scale",
                                                "number_scale")}
        line[f"randk_gather_{dtype}"] = entry
        del delta
    theta = _randn((VGG_ROWS, 128), 23)
    y = _randn((k_rows, 128), 24, scale=0.01)
    inv = 1.0 / (MAIN_R * 0.05)
    line["aircomp_combine"] = _warm_cold(
        lambda: comb.aircomp_combine(theta, y, idx, inv))
    del theta, y
    torch.cuda.empty_cache()
    emit(line)
    for _ in range(3):
        phase_kernel_api()


def phase_transmit_timing():
    """``--time-transmit``: the pair alone at ``TRANSMIT_TIMED``, warm and
    cold, beside ``vector_norm(u, dim=1)``, with the device kernels of one
    call and the kernels' registers. It uses only what every tree of the
    port has, so a parent commit is measured by copying this script into
    its checkout and running it there and here in turns, in one call."""
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(["pfels_transmit"])
    emit({"phase": "transmit_timing", "tree": ROOT,
          "build_s": time.perf_counter() - t0, "ptxas": transmit_ptxas()})
    for i, (label, r, d, m_ant, dropped, share, zero) in enumerate(
            TRANSMIT_TIMED):
        args = _kernel_inputs(r, d, m_ant, 7 + i, dropped, share, zero)
        emit({"phase": "transmit_timing", "tree": ROOT, "shape": label,
              "r": r, "d": d, "M": m_ant, **_transmit_times(*args)})
        del args
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path round and one more "
                         "round of each baseline after the checked ones, "
                         "and 8 zamba2-2.7b decode steps after the serve "
                         "phase's profiled prefill, and one more "
                         "zamba2-2.7b PFELS step with its parts timed "
                         "(device busy time, time by kernel)")
    ap.add_argument("--time-ssd", action="store_true",
                    help="only time ssd_scan at the two serving prefills "
                         "and a warm zamba2-2.7b prefill (no checks, no "
                         "result line): the comparison with a parent tree")
    ap.add_argument("--sharded", action="store_true",
                    help="only the transmit pair at the per-shard shapes, "
                         "the main path, the sharded cohort on 4 gloo "
                         "ranks sharing the card and the multi-pod step "
                         "(no result line)")
    ap.add_argument("--draws", action="store_true",
                    help="only the draws phase: the port's draws on the "
                         "card against the CPU route (no result line)")
    ap.add_argument("--llm-train", action="store_true",
                    help="only the build, dryrun and llm_train phases (no "
                         "result line): the comparison with a parent tree")
    ap.add_argument("--time-transmit", action="store_true",
                    help="only time the PFELS transmit pair warm and cold "
                         "at its main-path and per-shard shapes beside "
                         "vector_norm (no result line): the comparison "
                         "with a parent tree")
    ap.add_argument("--time-rounds", action="store_true",
                    help="only build the transmit pair and run the main "
                         "path's 3 rounds and one profiled round (no "
                         "result line): the comparison with a parent "
                         "tree")
    ap.add_argument("--time-rows", action="store_true",
                    help="only time the three row kernels at the VGG-11 "
                         "shapes and run the kernel_api chain (no result "
                         "line): the comparison with a parent tree")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    smi = phase_device()
    if args.time_ssd:
        phase_ssd_timing()
        print(smi, flush=True)
        return 0
    if args.time_transmit:
        phase_transmit_timing()
        print(smi, flush=True)
        return 0
    if args.time_rounds:
        from repro_torch.kernels import _build
        _build.build(["pfels_transmit"])
        phase_main_path(profile=True)
        print(smi, flush=True)
        return 0
    if args.time_rows:
        phase_row_timing()
        print(smi, flush=True)
        return 0
    if args.draws:
        phase_draws()
        print(smi, flush=True)
        return 0
    phase_build()
    if args.llm_train:
        predicted = phase_dryrun()
        phase_llm_train(args.profile, predicted["llm_train"])
        phase_llm_train_families(predicted["granite_train"])
        print(smi, flush=True)
        return 0
    if args.sharded:
        check_transmit_timed(("per_shard_r8", "per_shard_r1"))
        _, main_info = phase_main_path(False)
        phase_multi_pod()
        phase_sharded(main_info, yardstick=True)
        print(smi, flush=True)
        return 0
    phase_draws()
    predicted = phase_dryrun()
    summary = phase_kernels()
    launches, main_info = phase_main_path(args.profile)
    launches.update(phase_kernel_api())
    problem = vgg_problem()
    phase_baselines(args.profile, problem)
    phase_scenarios(problem)
    del problem
    torch.cuda.empty_cache()
    phase_parity()
    sharded_launches = phase_sharded(main_info)
    multi_pod_launches = phase_multi_pod()
    phase_conv_parity()
    phase_femnist()
    phase_streamed()
    phase_train_cli()
    phase_serve_parity()
    serve_launches, serve_by_run = phase_serve(args.profile,
                                               predicted["serve_prefill"])
    launches.update(serve_launches)
    for name in serve_launches:
        summary[name]["launches_by_path"] = {
            run: n[name] for run, n in serve_by_run.items()}
    phase_serve_parity_bf16()
    # clip_norm's main path is the production step's gradient clip: its
    # launches and its time at that flat size replace the kernel_api
    # chain's (kept beside them)
    api_launches, at_vgg11 = launches["clip_norm"], summary["clip_norm"]
    launches["clip_norm"], summary["clip_norm"] = phase_llm_train(
        args.profile, predicted["llm_train"])
    granite_launches = phase_llm_train_families(predicted["granite_train"])
    summary["clip_norm"].update({"launches_kernel_api": api_launches,
                                 "launches_multi_pod": multi_pod_launches,
                                 "launches_granite_step": granite_launches,
                                 "at_vgg11_rows": at_vgg11})
    for name, by_path in sharded_launches.items():
        summary[name]["launches_by_path"] = {
            "main_path": launches[name],
            "sharded_summed_over_ranks": by_path}
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
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
