"""SGD with momentum (paper §8.1: momentum 0.9); port of
``repro/optim/sgd.py``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def sgd_init(params):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params)


def sgd_update(params, grads, state, *, lr, momentum: float = 0.0):
    """Returns (new params, new state)."""
    new_v = tree_map(lambda v, g: momentum * v + g.float(), state, grads)
    new_p = tree_map(lambda p, v: (p.float() - lr * v).to(p.dtype), params,
                     new_v)
    return new_p, new_v
