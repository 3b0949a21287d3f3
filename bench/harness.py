"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

The cell names a configuration and a traffic mix; the traffic file names
the driver kind (``drivers/<kind>.py``); per-layer metrics are readers in
``metrics/<name>.py``; the limits of the cell's comparison are in
``limits/<cell>.json``. A driver module provides:

- ``SPANS``: [(module, attribute, span name)], the program's calls that
  the traced run wraps in a span;
- ``setup(ctx) -> state``: builds the program and its inputs and warms
  every shape the window uses; time it spends for the check is added to
  ``ctx.check_s`` and not counted as set-up;
- ``unit(state, i)``: the window's i-th step, batch or round;
- ``finish(state, ctx) -> kept``: after the window and the memory
  reading, keeps what the check needs and frees the program's state;
- ``failed(state) -> int``: units whose outputs were not finite;
- ``check(ctx, kept) -> [(name, value)]``: the numbers compared, from a
  plain reference in ``reference/``;
- ``end_to_end(ctx, units, window_s) -> {metric: value}``;
- ``work(ctx) -> {size: value}``, the sizes the per-layer metrics use;
- ``CONTROL`` and ``calibrate(ctx, kinds)``: the readings
  ``bench/calibrate.py`` prints to set the limits from.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class HarnessError(Exception):
    """A fault of the harness, its files or the machine: no result."""


@dataclass
class Ctx:
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    root: Path
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Optional[float]]
    chips: int = 1
    check_s: float = 0.0

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()


def load_json(path: Path):
    if not path.is_file():
        raise HarnessError(f"missing {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    if not path.is_file():
        raise HarnessError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(root: Path, cell: str):
    """The manifest, the cell's entry, its configuration, traffic,
    limits and the driver module, each found by name."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise HarnessError(f"no workload {cell!r} in BENCHMARK.json")
    entry = cells[cell]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "bench" / "traffic" /
                        f"{entry['traffic']}.json")
    limits = load_json(root / "bench" / "limits" / f"{cell}.json")
    driver = load_module(root / "bench" / "drivers" /
                         f"{traffic['driver']}.py",
                         f"bench_driver_{traffic['driver']}")
    return manifest, entry, config, traffic, limits, driver


def cell_metrics(manifest, cell: str):
    """The cell's end-to-end metrics (those that list no cells are every
    cell's), and the per-layer metrics that list it."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per_layer = [m for m in manifest["per_layer"]
                 if cell in m["workloads"]]
    return e2e, per_layer


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def judge(checks, limits):
    """(correct, {name: {value, limit}}): every number that has a limit
    at most its limit; a number without one is printed, not held."""
    table, ok = {}, True
    for name, value in checks:
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        if limit is not None and not (value is not None
                                      and math.isfinite(value)
                                      and value <= limit):
            ok = False
    return ok, table


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda",
             require_cuda: bool = True):
    """One run of ``cell``; returns (result dict, check table)."""
    import torch

    from bench.yardstick import trace as tr
    manifest, entry, config, traffic, limits, driver = cell_files(root, cell)
    if require_cuda:
        if not torch.cuda.is_available():
            raise HarnessError("no CUDA device: the benchmark measures the "
                               "card and does not fall back")
        n = torch.cuda.device_count()
        if n < entry["chips"]:
            raise HarnessError(f"the cell needs {entry['chips']} cards, "
                               f"{n} seen")
    ctx = Ctx(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device, root=root, config=config,
              traffic=traffic, limits=limits, chips=entry["chips"])
    e2e_specs, layer_specs = cell_metrics(manifest, cell)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0 - ctx.check_s
    record, unit_s = None, []
    with tr.wrap_calls(_resolve(driver.SPANS), trace):
        if trace:
            record = tr.profile_units(lambda i: driver.unit(state, i),
                                      int(traffic["traced_units"]),
                                      ctx.sync, cuda=device == "cuda")
            units = 2 * record.units + record.span_units
            window_s = record.window_s
        else:
            units, t1 = 0, time.perf_counter()
            last = t1
            while True:
                driver.unit(state, units)
                ctx.sync()
                units += 1
                now = time.perf_counter()
                unit_s.append(now - last)
                last = now
                if now - t1 >= ctx.seconds:
                    break
            window_s = last - t1
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise HarnessError(f"modules loaded that the port may not load: "
                           f"{bad}")
    failed = driver.failed(state)
    if trace:
        record.cell, record.work = cell, driver.work(ctx)
    kept = driver.finish(state, ctx)
    del state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(ctx, kept)
    correct, table = judge(checks, limits)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for spec in layer_specs:
            reader = load_module(root / "bench" / "metrics" /
                                 f"{spec['name']}.py",
                                 "bench_metric_" + spec["name"]
                                 .replace(".", "_").replace("-", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[spec["name"]] = {"value": value,
                                         "unit": spec["unit"]}
    else:
        values = dict(driver.end_to_end(ctx, units, window_s),
                      setup_s=setup_s, peak_mem_gb=peak / 1e9)
        for spec in e2e_specs:
            if spec["name"] not in values:
                raise HarnessError(f"the driver gives no {spec['name']}")
            metrics[spec["name"]] = {"value": values[spec["name"]],
                                     "unit": spec["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = record.busy_s()
        dev["window_s"] = window_s
        result["breakdown"] = tr.breakdown(record)
    else:
        # each unit's host seconds, to tell drift from jitter
        result["unit_s"] = unit_s
    result["checks"] = table
    bad = forbidden_modules()
    if bad:
        raise HarnessError(f"modules loaded that the port may not load: "
                           f"{bad}")
    return result, table


def _resolve(spans):
    out = []
    for modname, attr, label in spans:
        mod = sys.modules.get(modname)
        if mod is None:
            try:
                mod = importlib.import_module(modname)
            except ImportError:
                continue
        out.append((mod, attr, label))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    # one process with one CPU thread: the host paces the FL round, and
    # idle intra-op threads only add to its spread
    torch.set_num_threads(1)
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        result, table = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace))
    except HarnessError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    from bench.yardstick.peaks import card_power_limit
    print(f"card: {card_power_limit()}", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
