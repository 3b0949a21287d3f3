"""Device operations by class, from their names in the profiler's trace.

The order of the tests and the convolution patterns are ``chip_smoke.py``
``round_split``'s; the GEMM patterns add cuBLAS's Hopper kernel families
(``nvjet``, ``cutlass``, ``xmma``); the PRNG's class adds f64 element-wise
kernels to the int64 ones (the models compute in bf16 and f32, so only
the draws' exact arithmetic runs in f64); the port's own kernels are
named by their CUDA entry points (``csrc/*.cu``)."""
from __future__ import annotations

KERNELS = {
    "transmit": ("client_sumsq_kernel", "fused_combine_kernel"),
    "clip_norm": ("clip_kernel",),
    "ssd_scan": ("ssd_scan",),
    "flash_attn": ("flash_fwd",),
}
CONV = ("conv", "cudnn", "implicit_gemm", "dgrad", "wgrad", "fprop",
        "winograd", "cf32")
GEMM = ("gemm", "nvjet", "cutlass", "xmma", "splitk")
# the PRNG: its threefry hash in int64 ops, its exact f32 arithmetic in f64
RNG = ("<long", "int64", "<double", "float64")
COPY = ("memcpy", "memset")


def op_class(name: str) -> str:
    low = name.lower()
    for cls, pats in KERNELS.items():
        if any(p in low for p in pats):
            return cls
    for cls, pats in (("conv", CONV), ("gemm", GEMM), ("rng", RNG),
                      ("copy", COPY)):
        if any(p in low for p in pats):
            return cls
    return "other"
