"""Flat views of a params dict, in ``jax.flatten_util.ravel_pytree`` order.

Params are ``dict[str, Tensor]`` whose names are the reference pytree's
paths joined with ``.`` (``convs.3``, ``out.w``). Rand-k indices and the
transmit mask index the FLAT vector, so the flatten order is part of the
parity contract: JAX sorts dict keys (``fc1.b`` before ``fc1.w``) and
keeps list order (``convs.0`` ... ``convs.7``), which :func:`path_key`
reproduces whatever order the dict was built in.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]


def path_key(name: str) -> Tuple:
    """Sort key of a param name: list indices numerically, dict keys as
    strings — the pytree leaf order."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def leaf_names(params: Params) -> List[str]:
    return sorted(params, key=path_key)


def ravel(params: Params) -> torch.Tensor:
    """(d,) f32 concatenation of the leaves in pytree order."""
    return torch.cat([params[n].reshape(-1).float()
                      for n in leaf_names(params)])


class Unravel:
    """The inverse of :func:`ravel` for one params layout."""

    def __init__(self, template: Params):
        self.names = leaf_names(template)
        self.shapes = [tuple(template[n].shape) for n in self.names]
        self.sizes = [template[n].numel() for n in self.names]
        self.d = sum(self.sizes)

    def __call__(self, flat: torch.Tensor) -> Params:
        parts = torch.split(flat, self.sizes)
        return {n: p.reshape(s)
                for n, p, s in zip(self.names, parts, self.shapes)}


# ------------------------------------------------------------ nested trees
#
# The LLM stack's params are nested: dicts of dicts, with a tuple of
# stacked blocks (``models/transformer.py``). The helpers below visit the
# leaves of such a tree in ``jax.tree.flatten`` order (dict keys sorted,
# list and tuple order kept, None an empty subtree). A flat dict of
# ``Params`` is the special case of one level, sorted by :func:`path_key`.


def _dict_keys(d) -> List[str]:
    return sorted(d, key=path_key)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested tree, in pytree leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in _dict_keys(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of the same
    structure; the leaves are visited in pytree order, so ``fn`` may draw
    from an iterator that :func:`tree_leaves` order matches."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in _dict_keys(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (pytree order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
