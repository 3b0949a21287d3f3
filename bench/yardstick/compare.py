"""The comparisons that decide ``correct``: gaps between the program's
readings and a plain reference's, each a relative number the cell's
limits file holds."""
from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch


@contextlib.contextmanager
def exact_f32():
    """f32 matrix products and convolutions without TF32 while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def rel(a: float, b: float) -> float:
    """|a - b| / |b|; inf where a is not finite."""
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def step_gaps(steps: Sequence[Dict[str, float]],
              ref: Sequence[Dict[str, float]]) -> List[Tuple[str, float]]:
    """The largest relative gap over the steps of the loss, beta and the
    energy, and the gap of the first step's gradient norm (the later
    steps' gradients are taken at params the two sides rounded apart); a
    missing step counts as infinite."""
    out = []
    for name in ("loss", "grad_norm", "beta", "energy"):
        pairs = list(zip(steps, ref))[:1 if name == "grad_norm" else None]
        gaps = [rel(float(s[name]), r[name]) for s, r in pairs]
        if len(steps) != len(ref) or not gaps:
            gaps.append(math.inf)
        out.append((f"{name}_gap", max(gaps)))
    return out


def per_step(steps, ref, name: str) -> List[float]:
    """The relative gap of ``name`` at each step."""
    return [rel(float(s[name]), r[name]) for s, r in zip(steps, ref)]


def _leaves(theta, paths):
    return ([theta[p] for p in paths] if isinstance(theta, dict)
            else list(theta))


def change_gap(theta0: Dict, theta, ref: Dict,
               leaf_grad_norms: Sequence[float]) -> float:
    """The worst leaf's gap between the norms of the parameters' change,
    | ||theta - theta0|| - ||ref - theta0|| |, over the larger of the
    reference's change of that leaf and of the median leaf. Leaves whose
    reference gradient at step 1 is under a thousandth of the median
    leaf's are left out: they move by round-off alone."""
    paths = list(theta0)
    prog = _leaves(theta, paths)
    if len(prog) != len(paths):
        return math.inf
    med_g = statistics.median(leaf_grad_norms)
    changes = []
    for p, x in zip(paths, prog):
        t0 = theta0[p].double()
        a = float(torch.linalg.vector_norm(x.to(t0.device).double() - t0))
        b = float(torch.linalg.vector_norm(ref[p].double() - t0))
        changes.append((a, b))
    med = statistics.median(b for _, b in changes)
    worst = 0.0
    for (a, b), g in zip(changes, leaf_grad_norms):
        if g < 1e-3 * med_g:
            continue
        if not math.isfinite(a):
            return math.inf
        worst = max(worst, abs(a - b) / max(b, med, 1e-30))
    return worst


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f64; inf where got is not finite."""
    got = got.to(want.device).double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    want = want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))
