"""The port stands alone: nothing under ``src/repro_torch`` imports JAX or
the JAX package ``repro`` (only the tests import both)."""
import ast
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "src", "repro_torch")


def _modules():
    for dirpath, _, files in os.walk(_PKG):
        for fname in sorted(files):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, _PKG))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == [], f"{os.path.relpath(path, _ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    names = []
    for path in _modules():
        rel = os.path.relpath(path, os.path.join(_ROOT, "src"))[:-3]
        mod = rel.replace(os.sep, ".")
        names.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                     else mod)
    code = ("import importlib, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(" + repr(names) + "))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(names) > 20


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(_ROOT, "chip_smoke.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_forbidden(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert not _forbidden(node.module)
