"""Readings for the limits of a cell's comparison: the program against
the plain reference, and the control and faults put in the program's
place, on several seeds in one process:

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--kinds fp8 half_batch]

Prints one JSON line a seed. Not run by the benchmark's own runs."""
import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / "src"))


def main(argv=None):
    import torch

    from bench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, entry, config, traffic, limits, driver = harness.cell_files(
        harness.ROOT, args.workload)
    for seed in args.seeds:
        ctx = harness.Ctx(cell=args.workload, seed=seed, seconds=0,
                          trace=False, device=args.device,
                          root=harness.ROOT, config=config,
                          traffic=traffic, limits=limits)
        t0 = time.perf_counter()
        out = driver.calibrate(ctx, args.kinds)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                          "readings": {k: dict(v) for k, v in out.items()},
                          "limits": limits}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
