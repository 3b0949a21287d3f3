"""Roofline terms of a step on one NVIDIA H100 (port of
``repro/launch/hlo_analysis.py``).

    compute    = FLOPs (per device) / peak FLOP/s
    memory     = bytes moved (per device) / HBM rate
    collective = per-device collective bytes (ring model per kind) / link rate

The reference reads its FLOPs, bytes and collectives from compiled HLO
text; the port has no compiler, so ``launch.op_cost`` counts them from the
ops a step dispatches, and ``normalize_cost`` and the HLO regexes have no
counterpart here. ``collective_bytes``' ring model per collective kind is
``ring_bytes``.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet (dense rates, no sparsity, at the 700 W
# limit): bf16 tensor cores, f32 outside the tensor cores, HBM3's rate
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
# NVLink 4 (H100 SXM data sheet and the Hopper white paper): 900 GB/s a
# card to the others of its host, 450 GB/s each way
LINK_BYTES_PER_S = 450e9
# the data sheet's 80 GB of HBM3 a card
HBM_BYTES = 80e9

PEAK_FLOPS = PEAK_BF16_FLOP_PER_S

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def ring_bytes(kind: str, result_bytes: float, group_size: int) -> float:
    """Bytes one device sends for one collective whose result holds
    ``result_bytes`` on each of ``group_size`` devices, in the reference's
    ring model (``hlo_analysis.collective_bytes``): an all-reduce moves
    2 (g - 1)/g of its result, an all-gather and an all-to-all (g - 1)/g,
    a reduce-scatter (g - 1)/g of its input (g times its result), a
    collective-permute its result."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}; expected one of "
                         f"{KINDS}")
    g = int(group_size)
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "reduce-scatter":
        return frac * result_bytes * g
    if kind == "collective-permute":
        return float(result_bytes)
    return frac * result_bytes


def roofline_terms(cost: Dict, coll: Dict, n_chips: int) -> Dict:
    """``cost`` {"flops", "bytes accessed"} and ``coll`` {"total"} of one
    device -> the three times and the one that dominates (the reference's
    keys, without its ``hlo_`` prefix: the counts come from dispatched
    ops)."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / PEAK_BYTES_PER_S
    t_coll = float(coll["total"]) / LINK_BYTES_PER_S
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": float(coll["total"]),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "n_chips": n_chips,
    }


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6 N D for a train step (forward and backward), 2 N D
    for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
