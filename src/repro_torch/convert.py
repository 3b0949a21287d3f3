"""Carry weights and state across from the JAX reference, as numpy.

The JAX side hands over pytrees of numpy arrays (``jax.device_get``); no
JAX import is needed here. Params flatten in ``ravel_pytree`` order: dict
keys sorted, list order kept (``repro_torch.tree``), so a carried-across
state transmits the same coordinates.
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


def params_from_jax(tree: Any, device: Device = "cuda") -> Params:
    """A JAX params pytree (of numpy arrays) -> ``dict[str, Tensor]``
    named by path (``convs.3``, ``out.w``), in pytree leaf order."""
    return {name: torch.as_tensor(np.array(leaf), device=device)
            for name, leaf in _walk(tree)}


def params_to_jax(params: Params) -> Any:
    """The inverse of :func:`params_from_jax`: nested dicts and lists of
    numpy arrays (a path part that is a number is a list index)."""
    root: Dict = {}
    for name in leaf_names(params):
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = params[name].detach().cpu().numpy()

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
    limits, bank lanes and counts, prev_delta, key, round and ledger.
    Error-feedback residuals and channel carries are not ported yet."""
    if getattr(state.bank, "residuals", None) is not None:
        raise NotImplementedError("error-feedback residuals are not "
                                  "ported yet: ROADMAP Queue 1, item 7")
    if getattr(state, "chan", None) is not None:
        raise NotImplementedError("stateful channel carries are not "
                                  "ported yet: ROADMAP Queue 1, item 9")
    t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt, device=device)
    return TrainState(
        params=params_from_jax(state.params, device),
        power_limits=t(state.power_limits, torch.float32),
        bank=BankState(residuals=None,
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
