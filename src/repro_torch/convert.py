"""Carry weights and state across from the JAX reference, as numpy.

The JAX side hands over pytrees of numpy arrays (``jax.device_get``); no
JAX import is needed here. bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays, which torch cannot take directly: they cross bit for bit as
16-bit words. Params flatten in ``ravel_pytree`` order: dict keys sorted,
list order kept (``repro_torch.tree``), so a carried-across state
transmits the same coordinates.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import privacy
from repro_torch.fl.api import TrainState
from repro_torch.fl.bank import BankState
from repro_torch.tree import Params, leaf_names

Device = Union[str, torch.device]


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tensor_from_numpy(a, device: Device = "cuda") -> torch.Tensor:
    """A numpy array (or scalar) -> a tensor of the same dtype and bits;
    a bf16 array goes through its 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`tensor_from_numpy`. A bf16 tensor becomes an
    ``ml_dtypes.bfloat16`` array (the numpy dtype JAX uses)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; only needed for bf16 leaves
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Any, device: Device = "cuda") -> Params:
    """A JAX params pytree (of numpy arrays) -> ``dict[str, Tensor]``
    named by path (``convs.3``, ``out.w``), in pytree leaf order."""
    return {name: tensor_from_numpy(leaf, device)
            for name, leaf in _walk(tree)}


def _nested(tree, device):
    if isinstance(tree, dict):
        return {k: _nested(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_nested(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def lm_params_from_jax(tree: Any, cfg, device: Device = "cuda"):
    """A ``repro.models.transformer.init_params`` tree (numpy leaves) ->
    the port's LLM params: the same nesting, the same layouts (matrices
    stay (d_in, d_out), ``conv_w`` stays (W, C), every block leaf keeps
    its leading repeat dim), the same dtypes and bits. Raises if a leaf's
    path, shape or dtype differs from what the port builds for ``cfg``."""
    from repro_torch.models import transformer
    params = _nested(tree, device)
    want = transformer.init_params(None, cfg, device="meta")
    got_leaves = dict(_walk(params))
    want_leaves = dict(_walk(want))
    if sorted(got_leaves) != sorted(want_leaves):
        raise ValueError(f"param paths differ from the port's for "
                         f"{cfg.name}: extra "
                         f"{sorted(set(got_leaves) - set(want_leaves))}, "
                         f"missing "
                         f"{sorted(set(want_leaves) - set(got_leaves))}")
    for name, w in want_leaves.items():
        g = got_leaves[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(f"{name}: got {g.dtype} {tuple(g.shape)}, the "
                             f"port builds {w.dtype} {tuple(w.shape)}")
    return params


def params_to_jax(params: Params) -> Any:
    """The inverse of :func:`params_from_jax`: nested dicts and lists of
    numpy arrays (a path part that is a number is a list index)."""
    root: Dict = {}
    for name in leaf_names(params):
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = numpy_from_tensor(params[name])

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def train_state_from_jax(state: Any, device: Device = "cuda") -> TrainState:
    """A ``repro.fl.api.TrainState`` (its leaves as numpy, e.g. through
    ``jax.device_get``) -> the port's ``TrainState``: params, power
    limits, bank (error-feedback residuals, lanes and counts), prev_delta,
    key, round and ledger. Channel carries are not ported yet."""
    if getattr(state, "chan", None) is not None:
        raise NotImplementedError("stateful channel carries are not "
                                  "ported yet: ROADMAP Queue 1, item 9")
    t = lambda a, dt: tensor_from_numpy(a, device).to(dt)
    return TrainState(
        params=params_from_jax(state.params, device),
        power_limits=t(state.power_limits, torch.float32),
        bank=BankState(residuals=(None if state.bank.residuals is None
                                  else t(state.bank.residuals,
                                         torch.float32)),
                       lanes=prng.key_from_words(state.bank.lanes, device),
                       counts=t(state.bank.counts, torch.int32)),
        prev_delta=t(state.prev_delta, torch.float32),
        key=prng.key_from_words(state.key, device),
        round=t(state.round, torch.int32),
        ledger=privacy.LedgerState(
            eps_sum=t(state.ledger.eps_sum, torch.float32),
            eps_max=t(state.ledger.eps_max, torch.float32),
            spends=t(state.ledger.spends, torch.int32)),
        chan=None)
