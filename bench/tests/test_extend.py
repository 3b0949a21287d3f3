"""A configuration, a traffic mix and a per-layer metric are each added
by new files and new entries in BENCHMARK.json alone: no file that is
already there is edited, and the harness finds and runs them."""
import hashlib
import json

from bench import harness
from bench.tests import cells, tiny

METRIC = '''"""Host seconds a traced unit, a metric added by a new file."""


def read(rec):
    if rec.units <= 0:
        return None
    return rec.window_s / rec.units
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_picked_up(tmp_path):
    root = cells.root_with(tmp_path, cells.STEP)
    before = _digests(root)
    cfg = tiny.tiny_lm_config()
    cfg["name"] = "tiny-lm-wide"
    cfg["model"]["d_model"] = 96
    (root / "bench/configs/tiny-lm-wide.json").write_text(json.dumps(cfg))
    traffic = dict(cells.STEP[2], batch=4, seq=16)
    (root / "bench/traffic/step_4x16.json").write_text(json.dumps(traffic))
    (root / "bench/limits/tiny-wide-step.json").write_text(
        json.dumps(cells.STEP[3]))
    (root / "bench/metrics/step.host_s.py").write_text(METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-lm-wide", "source": "tiny",
                                "file": "bench/configs/tiny-lm-wide.json",
                                "reduced": [], "why": "wider"})
    manifest["workloads"].append({"name": "tiny-wide-step",
                                  "config": "tiny-lm-wide",
                                  "traffic": "step_4x16", "chips": 1,
                                  "why": "new files only"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and "tiny-step" in m["workloads"]:
            m["workloads"].append("tiny-wide-step")
    manifest["per_layer"].append({"name": "step.host_s", "unit": "s",
                                  "better": "lower", "source": "host_clock",
                                  "layer": "production step",
                                  "moves": "step_s",
                                  "workloads": ["tiny-step",
                                                "tiny-wide-step"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digests(root)
    assert all(after[p] == h for p, h in before.items())
    for cell in ("tiny-wide-step", "tiny-step"):
        res, table = harness.run_cell(cell, 5, 0.2, True, root=root,
                                      device="cpu", require_cuda=False)
        assert res["correct"], table
        assert res["metrics"]["step.host_s"]["value"] > 0
    res, _ = harness.run_cell("tiny-wide-step", 5, 0.2, False, root=root,
                              device="cpu", require_cuda=False)
    assert set(res["metrics"]) == {"setup_s", "step_s", "peak_mem_gb"}
