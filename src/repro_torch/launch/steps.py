"""Production step functions (port of ``repro/launch/steps.py``).

``make_pfels_train_step``: PFELS as the optimizer of one transformer that
is one FL client (DESIGN.md §3): a clipped local update, sparsified by
seeded Bernoulli masks per tensor (the shared A^t), power-scaled, sent
over the channel with its noise, and applied. The gradient clip runs
through the ``clip_norm`` kernel on the card (``core.clipping.
clip_tree_flat``): the whole gradient tree as one flat f32 buffer, one
launch a local step. The forward and backward take the plain model
functions under autograd, as the reference trains.

The reference's multi-pod path (a leading client dim on every param, the
AirComp sum over it) and its ``clientize_*`` helpers belong with the
sharded cohort and raise ``NotImplementedError``. The port needs no mesh.

``make_prefill_step`` / ``make_serve_step``: thin wrappers over the
port's ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, PFELSConfig
from repro_torch.core import aggregation, channel, power_control, randk
from repro_torch.core.clipping import clip_tree_flat
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_SHARDED = "ROADMAP Queue 1, item 11"


def _round_channel(key, pfels: PFELSConfig, d: int, n_clients: int):
    """The round's channel gains and Theorem-5 beta (the same on every
    client)."""
    kg, kp = prng.split(key)
    gains = channel.sample_gains(kg, n_clients, pfels.channel)
    p_lims = channel.sample_power_limits(kp, n_clients, d, pfels.channel)
    k_coords = max(int(round(pfels.compression_ratio * d)), 1)
    beta = power_control.beta_pfels(
        gains, p_lims, d=d, k=k_coords, c1=pfels.clip, eta=pfels.local_lr,
        tau=max(pfels.local_steps, 1), epsilon=pfels.epsilon, r=n_clients,
        n=max(pfels.num_clients, n_clients), delta=pfels.resolved_delta(),
        sigma0=pfels.channel.noise_std)
    return gains, beta


def value_and_grad(loss_fn, params, *args):
    """((loss, aux), grads) of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to every leaf of the nested ``params``; the grads in the
    params' structure and dtypes, aux detached."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    aux = tree_map(lambda t: t.detach(), aux)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def _split_batch(batch, n: int):
    """``n`` equal slices of every leaf's leading (batch) dim."""
    b0 = tree_leaves(batch)[0].shape[0]
    return [tree_map(lambda x: x[i * (b0 // n):(i + 1) * (b0 // n)], batch)
            for i in range(n)]


def make_pfels_train_step(cfg: ModelConfig, pfels: PFELSConfig, d: int, *,
                          remat: bool = True, n_clients: int = 1):
    """Returns step(params, batch, key) -> (new params, metrics), metrics
    {loss, aux_loss, beta, grad_norm, energy} as 0-dim tensors. ``d`` is
    the params' element count (``transformer.param_count``). One client
    (``n_clients`` 1) only: more is the reference's multi-pod path."""
    if n_clients != 1:
        raise NotImplementedError(f"the multi-pod PFELS step (a client dim "
                                  f"on every param) is not ported yet: "
                                  f"{_SHARDED}")
    sigma0 = pfels.channel.noise_std
    accum = max(pfels.grad_accum, 1)
    tau = max(pfels.local_steps, 1)
    lr = pfels.local_lr

    def loss_fn(p, b):
        return T.forward_train(p, cfg, b, remat=remat)

    def grads_of(params, batch):
        """(loss, metrics), grads, with ``accum`` microbatches: each
        microbatch's outputs added to the first's in their dtypes, then
        divided by ``accum``, as the reference's scan does."""
        if accum == 1:
            return value_and_grad(loss_fn, params, batch)
        parts = _split_batch(batch, accum)
        acc = value_and_grad(loss_fn, params, parts[0])
        for b_i in parts[1:]:
            out = value_and_grad(loss_fn, params, b_i)
            acc = tree_map(lambda a, x: a + x.to(a.dtype), acc, out)
        return tree_map(lambda x: (x / accum).to(x.dtype), acc)

    def local_update(params, batch):
        """The client's update Delta as a flat f32 buffer and its tree of
        views. tau == 1: Delta = -eta clip(grad). tau > 1: tau clipped SGD
        steps, each on a 1/tau slice of the batch, the params kept in
        their dtype; Delta = theta_tau - theta_0 in f32."""
        if tau == 1:
            (loss, metrics), grads = grads_of(params, batch)
            flat, gnorm, layout = clip_tree_flat(grads, pfels.clip)
            del grads
            flat.mul_(-lr)
            return layout.tree(flat), loss, metrics, gnorm
        b0 = tree_leaves(batch)[0].shape[0]
        if b0 % tau != 0:
            raise ValueError(
                f"PFELS local_steps={tau} must divide the per-client batch "
                f"{b0} (each local step trains on one 1/tau slice)")
        p = params
        losses, ms, gnorms = [], [], []
        for b_s in _split_batch(batch, tau):
            (loss, m), g = value_and_grad(loss_fn, p, b_s)
            flat, gnorm, layout = clip_tree_flat(g, pfels.clip)
            del g
            p = tree_map(lambda p_, g_: (p_.float() - lr * g_).to(p_.dtype),
                         p, layout.tree(flat))
            del flat
            losses.append(loss)
            ms.append(m)
            gnorms.append(gnorm)
        flat = layout.gather(p)
        flat.sub_(layout.gather(params))
        metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                   for k in ms[0]}
        return (layout.tree(flat), torch.mean(torch.stack(losses)),
                metrics, torch.mean(torch.stack(gnorms)))

    def step(params, batch, key):
        update, loss, metrics, gnorm = local_update(params, batch)
        kc, km, kn = prng.split(key, 3)
        gains, beta = _round_channel(kc, pfels, d, 1)
        masks = randk.mask_tree(km, update, pfels.compression_ratio)
        # the energy's sum of squares before the aggregate: the masked
        # update is a temporary of one leaf at a time
        sq = 0
        for x, m in zip(tree_leaves(update), tree_leaves(masks)):
            sq = sq + torch.sum(torch.square(x * m.to(x.dtype)))
        delta = aggregation.pfels_production_aggregate(
            update, masks, beta=beta, r=1, sigma0=sigma0, noise_key=kn,
            unbiased_rescale=pfels.unbiased_rescale,
            compression_p=pfels.compression_ratio)
        del update, masks
        new_params = tree_map(
            lambda p_, u: (p_.float() + u.float()).to(p_.dtype),
            params, delta)
        energy = (beta / gains[0]) ** 2 * sq
        return new_params, dict(metrics, loss=loss, beta=beta,
                                grad_norm=gnorm, energy=energy)

    return step


def clientize_shapes(shapes, n_clients: int):
    raise NotImplementedError(f"the multi-pod client dim is not ported yet: "
                              f"{_SHARDED}")


def clientize_logical(logical, n_clients: int):
    raise NotImplementedError(f"the multi-pod client dim is not ported yet: "
                              f"{_SHARDED}")


def clientize_params(params, n_clients: int):
    raise NotImplementedError(f"the multi-pod client dim is not ported yet: "
                              f"{_SHARDED}")


def make_train_loss_step(cfg: ModelConfig, *, remat: bool = True):
    """A plain (non-FL) train step: step(params, batch) -> (loss, metrics,
    grads)."""
    def step(params, batch):
        (loss, m), g = value_and_grad(
            lambda p: T.forward_train(p, cfg, batch, remat=remat), params)
        return loss, m, g
    return step


def make_prefill_step(cfg: ModelConfig, window: Optional[int] = None):
    def step(params, batch):
        logits, caches, _ = T.prefill(params, cfg, batch, window=window)
        return logits, caches
    return step


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None):
    """ONE new token given the caches (updated in place)."""
    def step(params, token, caches, enc_out=None):
        return T.decode_step(params, cfg, token, caches, window=window,
                             enc_out=enc_out)
    return step
