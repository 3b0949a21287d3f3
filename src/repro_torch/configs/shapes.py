"""The four assigned input shapes (a copy of ``repro/configs/shapes.py``).

Decode shapes run ``launch.steps.make_serve_step`` (one new token with a
KV cache of ``seq_len``); ``prefill_32k`` runs ``make_prefill_step``;
``train_4k`` runs the PFELS ``make_pfels_train_step`` (``launch.dryrun``
runs each on the meta device).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
