"""BENCHMARK.json holds to the benchmark's contract, and every file a
cell needs is where the harness looks for it."""
import json
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        # the harness reads a per-layer metric only in the cells it lists
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_and_metrics(cell):
    manifest, entry, config, traffic, limits, driver = harness.cell_files(
        ROOT, cell)
    for hook in ("setup", "unit", "finish", "failed", "check",
                 "end_to_end", "work", "calibrate"):
        assert callable(getattr(driver, hook)), hook
    e2e, per_layer = harness.cell_metrics(manifest, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert set(limits) == {n for n in limits}
    assert config["name"] == entry["config"]


def test_per_layer_layers_named_once():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert "\n" not in m["layer"] and m["layer"]
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(n.endswith("_roofline") for n in layers["kernels"])
