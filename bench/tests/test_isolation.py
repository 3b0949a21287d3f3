"""Nothing under bench/ imports JAX, jaxlib, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port);
nothing under bench/reference/ imports the port; and a CPU rehearsal of
each driver leaves none of them in ``sys.modules``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return [n.split(".")[0] for n in out]


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    bad = [n for n in _imports(path) if n in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in _imports(path), path


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench.reference.hybrid_lm, bench.reference.pfels_step\n"
            "import bench.reference.threefry, bench.reference.fl_round\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'jax', 'jaxlib', 'flax', 'repro')]\n"
            "assert not bad, bad\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


REHEARSAL = r"""
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [%(root)r, %(src)r]
from bench import harness
from bench.tests import tiny
from bench.tests import cells
which = json.loads(%(args)r)
cell = [c for c in cells.CELLS_ALL if c[0] == which][0]
root = cells.root_of(Path(tempfile.mkdtemp()), cell)
harness.run_cell(which, 7, 0.1, False, root=root, device="cpu",
                 require_cuda=False)
print(json.dumps(harness.forbidden_modules()))
"""

@pytest.mark.parametrize("cell", ["tiny-step", "tiny-prefill", "tiny-round"])
def test_driver_rehearsal_loads_no_jax(cell, tmp_path):
    code = REHEARSAL % {"root": str(ROOT), "src": str(ROOT / "src"),
                        "args": json.dumps(cell)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
