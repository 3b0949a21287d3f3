"""Tiny cells for the CPU tests: a temporary root holding a manifest,
configuration, traffic and limits files at a few-thousand-parameter size,
beside the benchmark's own drivers, metrics and references."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_LM = {
    "n_layers": 12, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "block_pattern": ["mamba", "mamba", "mamba", "mamba", "mamba", "attn"],
    "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2, "chunk_size": 16,
            "conv_width": 4, "dt_min": 0.001},
    "mlp_act": "swiglu", "norm": "rmsnorm", "norm_eps": 1e-6,
    "rope_theta": 10000.0, "dtype": "float32", "param_dtype": "float32"}


def tiny_lm_config(dtype="float32"):
    """The zamba2 configuration file with the tiny model."""
    cfg = json.loads((REPO / "bench/configs/zamba2-2.7b.json").read_text())
    cfg["name"] = "tiny-lm"
    cfg["model"] = dict(copy.deepcopy(TINY_LM), dtype=dtype,
                        param_dtype=dtype)
    return cfg


def make_root(tmp: Path, cells):
    """A root with BENCHMARK.json and bench/ (drivers, metrics and
    references copied from the repo) holding ``cells``: [(cell name,
    config dict, traffic name, traffic dict, limits dict, the cell of
    BENCHMARK.json it stands for)]; it reports that cell's metrics."""
    shutil.copytree(REPO / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"], manifest["workloads"] = [], []
    stands = {}
    for cell, cfg, tname, traffic, limits, real in cells:
        stands.setdefault(real, []).append(cell)
        path = f"bench/configs/{cfg['name']}.json"
        (tmp / path).write_text(json.dumps(cfg))
        (tmp / f"bench/traffic/{tname}.json").write_text(json.dumps(traffic))
        (tmp / f"bench/limits/{cell}.json").write_text(json.dumps(limits))
        if cfg["name"] not in [c["name"] for c in manifest["configs"]]:
            manifest["configs"].append(
                {"name": cfg["name"], "source": cfg["source"], "file": path,
                 "reduced": [], "why": "tiny"})
        manifest["workloads"].append({"name": cell, "config": cfg["name"],
                                      "traffic": tname, "chips": 1,
                                      "why": "tiny"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for w in m["workloads"]
                              for c in stands.get(w, [])]
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
