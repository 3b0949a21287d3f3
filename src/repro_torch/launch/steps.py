"""Production step functions (port of ``repro/launch/steps.py``).

``make_pfels_train_step``: PFELS as the optimizer of one transformer that
is one FL client (DESIGN.md §3): a clipped local update, sparsified by
seeded Bernoulli masks per tensor (the shared A^t), power-scaled, sent
over the channel with its noise, and applied. The gradient clip runs
through the ``clip_norm`` kernel on the card (``core.clipping.
clip_tree_flat``): the whole gradient tree as one flat f32 buffer, one
launch a local step. The forward and backward take the plain model
functions under autograd, as the reference trains.

With ``n_clients`` > 1 it is the reference's multi-pod path, in one
process: every param carries a leading client dim (``clientize_params``),
each client takes its local update on its slice of the batch, and the
AirComp superposition is the sum over the client dim. The port needs no
mesh.

``make_prefill_step`` / ``make_serve_step``: thin wrappers over the
port's ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng, tracing
from repro_torch.configs.base import ModelConfig, PFELSConfig
from repro_torch.core import aggregation, channel, power_control, randk
from repro_torch.core.clipping import clip_tree_flat
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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
    the element count of one client's params
    (``transformer.param_count``).

    ``n_clients`` > 1 is the multi-pod step: ``params`` carry a leading
    (n_clients,) dim on every leaf, client i trains on rows ``[i B/n,
    (i + 1) B/n)`` of the batch, one mask tree is drawn from client 0's
    update (the shared A^t), ``sum_i beta A Delta_i`` gets the channel
    noise and the 1/(n beta) unscale, and the result is added to every
    client's params; energy is ``sum_i (beta/g_i)^2 ||A Delta_i||^2`` and
    the other metrics are the means over the clients."""
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1, got {n_clients}")
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
            with tracing.span("forward_backward"):
                (loss, metrics), grads = grads_of(params, batch)
            with tracing.span("clip"):
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
            with tracing.span("forward_backward"):
                (loss, m), g = value_and_grad(loss_fn, p, b_s)
            with tracing.span("clip"):
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
        with tracing.span("step"):
            update, loss, metrics, gnorm = local_update(params, batch)
            kc, km, kn = prng.split(key, 3)
            with tracing.span("channel"):
                gains, beta = _round_channel(kc, pfels, d, 1)
            with tracing.span("masks"):
                masks = randk.mask_tree(km, update, pfels.compression_ratio)
            # the energy's sum of squares before the aggregate: the masked
            # update is a temporary of one leaf at a time
            with tracing.span("energy"):
                sq = 0
                for x, m in zip(tree_leaves(update), tree_leaves(masks)):
                    sq = sq + torch.sum(torch.square(x * m.to(x.dtype)))
            with tracing.span("aggregate"):
                delta = aggregation.pfels_production_aggregate(
                    update, masks, beta=beta, r=1, sigma0=sigma0,
                    noise_key=kn, unbiased_rescale=pfels.unbiased_rescale,
                    compression_p=pfels.compression_ratio)
            del update, masks
            with tracing.span("apply"):
                new_params = tree_map(
                    lambda p_, u: (p_.float() + u.float()).to(p_.dtype),
                    params, delta)
            energy = (beta / gains[0]) ** 2 * sq
            return new_params, dict(metrics, loss=loss, beta=beta,
                                    grad_norm=gnorm, energy=energy)

    def step_multi(params_c, batch, key):
        with tracing.span("step"):
            return _step_multi(params_c, batch, key)

    def _step_multi(params_c, batch, key):
        b_local = tree_leaves(batch)[0].shape[0] // n_clients
        updates, losses, ms, gnorms = [], [], [], []
        for i in range(n_clients):
            update, loss, metrics, gnorm = local_update(
                tree_map(lambda x: x[i], params_c),
                tree_map(lambda x: x[i * b_local:(i + 1) * b_local], batch))
            updates.append(tree_leaves(update))
            losses.append(loss)
            ms.append(metrics)
            gnorms.append(gnorm)
        kc, km, kn = prng.split(key, 3)
        with tracing.span("channel"):
            gains, beta = _round_channel(kc, pfels, d, n_clients)
        with tracing.span("masks"):
            masks = tree_leaves(randk.mask_tree(
                km, tree_unflatten(params_c, updates[0]),
                pfels.compression_ratio))
        # each client's masked sum of squares, one leaf at a time
        with tracing.span("energy"):
            sq = [0] * n_clients
            for j, m in enumerate(masks):
                for i in range(n_clients):
                    x = updates[i][j]
                    sq[i] = sq[i] + torch.sum(torch.square(
                        x * m.to(x.dtype)))
            energy = torch.sum((beta / gains[:n_clients]) ** 2
                               * torch.stack(sq))
        # the superposition, one leaf at a time
        with tracing.span("aggregate"):
            scale = 1.0 / (n_clients * beta)
            if pfels.unbiased_rescale:
                scale = scale / pfels.compression_ratio
            delta = []
            for j, (m, k) in enumerate(zip(masks,
                                           prng.split(kn, len(masks)))):
                x0 = updates[0][j]
                with tracing.span("aggregate.noise"):
                    z = prng.normal(k, tuple(x0.shape)).to(x0.dtype)
                with tracing.span("aggregate.combine"):
                    summed = None
                    for i in range(n_clients):
                        x = updates[i][j]
                        masked = (x * m.to(x.dtype)) * beta
                        summed = masked if summed is None else summed + masked
                    mf = m.to(summed.dtype)
                    delta.append((summed + (sigma0 * mf) * z) * scale)
        del updates, masks
        with tracing.span("apply"):
            new_params = tree_map(
                lambda p_, u: (p_.float() + u.float()[None]).to(p_.dtype),
                params_c, tree_unflatten(params_c, delta))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        return new_params, dict(metrics,
                                loss=torch.mean(torch.stack(losses)),
                                beta=beta,
                                grad_norm=torch.mean(torch.stack(gnorms)),
                                energy=energy)

    return step if n_clients == 1 else step_multi


def clientize_shapes(shapes, n_clients: int):
    """The leading client dim added to a tree of param shapes: each leaf
    a tensor (on any device, ``meta`` included) -> a ``meta`` tensor of
    shape (n_clients,) + its shape, in its dtype."""
    return tree_map(lambda x: torch.empty((n_clients,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"),
                    shapes)


def _is_logical_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def clientize_logical(logical, n_clients: int):
    """Every logical spec (a tuple of axis names or None) of a nested
    tree prefixed with the ``"clients"`` axis."""
    if _is_logical_spec(logical):
        return ("clients",) + logical
    if isinstance(logical, dict):
        return {k: clientize_logical(v, n_clients)
                for k, v in logical.items()}
    if isinstance(logical, (list, tuple)):
        return type(logical)(clientize_logical(v, n_clients)
                             for v in logical)
    return logical


def clientize_params(params, n_clients: int):
    """Real params copied along a new leading client dim (the start of a
    multi-pod run): each client's replica is its own memory."""
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (n_clients,) + (1,) * x.ndim), params)


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
