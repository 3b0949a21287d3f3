"""Client-side local training (Alg. 2 lines 6-12): tau steps of clipped
SGD with momentum (port of ``repro/fl/client.py``).

One client at a time; the round loops over the r sampled clients.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import prng
from repro_torch.core.clipping import clip_by_global_norm
from repro_torch.data.loader import sample_batch
from repro_torch.models import cnn
from repro_torch.tree import Params


def local_train(params: Params, x, y, key, *, loss_fn: Callable, steps: int,
                lr: float, clip: float, momentum: float = 0.0,
                batch_size: int = 50):
    """Run tau local steps; returns (new_params, mean_loss).

    The step keys are ``split(key, steps)``. Assumption 1 (bounded
    gradient) is enforced by clipping each stochastic gradient to C1
    before the SGD step [21]. The forward and the backward pass run
    inside ``f32_convs()``: f32, deterministic cuDNN convolutions."""
    p = {n: t.detach() for n, t in params.items()}
    v = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in p.items()}
    losses = []
    for k in prng.split(key, steps):
        batch = sample_batch(k, x, y, batch_size)
        leaves = {n: t.requires_grad_(True) for n, t in p.items()}
        # the backward convolutions read cuDNN's flags when they launch
        with torch.enable_grad(), cnn.f32_convs():
            loss, _ = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        g, _ = clip_by_global_norm(dict(zip(leaves, grads)), clip)
        with torch.no_grad():
            v = {n: momentum * v[n] + g[n].float() for n in v}
            p = {n: (p[n].float() - lr * v[n]).to(p[n].dtype) for n in p}
        losses.append(loss.detach())
    return p, torch.stack(losses).mean()


def model_update(params_before: Params, params_after: Params) -> Params:
    """Delta_i = theta_i^{t,tau} - theta^t (Alg. 2 line 11)."""
    return {n: params_after[n].float() - params_before[n].float()
            for n in params_before}
