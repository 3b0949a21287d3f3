"""The control: the reference computed in the precision below the
configuration's (fp8 for bf16, TF32 for f32 with TF32 off), put in the
program's place, reads well above the program.
On the CPU at a small size against the tiny bf16 program; on the card
(marked ``cuda``) at each cell's own size, against its limits."""
import json
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.tests import cells

ROOT = Path(__file__).resolve().parents[2]
# the number of each cell the control must fail, and by how much more
# than the bf16 program it reads at this size
KEY = {"tiny-step": ("fp8", "loss_gap"), "tiny-prefill": ("fp8", "logits_err"),
       "tiny-round": ("tf32", "loss_gap")}


@pytest.mark.parametrize("cell", cells.CELLS_ALL, ids=lambda c: c[0])
def test_control_reads_above_the_program_on_the_cpu(cell, tmp_path):
    root = cells.root_of(tmp_path, cell, dtype="bfloat16")
    _, entry, config, traffic, limits, driver = harness.cell_files(
        root, cell[0])
    ctx = harness.Ctx(cell=cell[0], seed=5, seconds=0, trace=False,
                      device="cpu", root=root, config=config,
                      traffic=traffic, limits=limits)
    kind, name = KEY[cell[0]]
    out = {k: dict(v) for k, v in driver.calibrate(ctx, [kind]).items()}
    assert out[kind][name] >= 3 * out["program"][name], out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_the_cells_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    _, entry, config, traffic, limits, driver = harness.cell_files(
        ROOT, cell)
    ctx = harness.Ctx(cell=cell, seed=1234567, seconds=0, trace=False,
                      device="cuda", root=ROOT, config=config,
                      traffic=traffic, limits=limits)
    kind = driver.CONTROL
    out = driver.calibrate(ctx, [kind])
    assert harness.judge(out["program"], limits)[0], out
    assert not harness.judge(out[kind], limits)[0], out
