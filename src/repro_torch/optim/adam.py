"""Adam (for the server-side adaptive-FL option and the LLM fine-tune
example); port of ``repro/optim/adam.py``: plain functions on params
trees, the moments in f32, the params kept in their dtype."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def adam_init(params):
    z = lambda x: torch.zeros_like(x, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0):
    """Returns (new params, new state)."""
    t = state["t"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"],
                 grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                 state["v"], grads)
    tf = t.float()
    mhat_s = 1.0 / (1 - b1 ** tf)
    vhat_s = 1.0 / (1 - b2 ** tf)

    def upd(p, m, v):
        step = lr * (m * mhat_s) / (torch.sqrt(v * vhat_s) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.float()
        return (p.float() - step).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
