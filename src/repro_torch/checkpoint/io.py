"""Checkpointing: trees of tensors -> npz of flattened key paths + JSON
metadata (port of ``repro/checkpoint/io.py``), in the reference's
on-disk layout, so that a checkpoint written by either package restores
in the other.

The layout: one npz entry a leaf, keyed by the leaf's path in the
reference's pytree, its parts joined by "/": dict keys (a port params
name such as ``convs.3`` is the reference's nested ``convs/3``), list and
tuple indices, and ``.field`` for a field of ``TrainState``,
``BankState`` or ``LedgerState``; None fields have no entry. bf16 is
widened to f32 (npz has no bf16), and a PRNG key (``TrainState.key``,
``BankState.lanes``, int64 words in the port) is stored as the
reference's uint32 words. The JSON sidecar sits beside the npz.

``restore`` puts each leaf where its template leaf lives, in its dtype:
device tensors on their device (the resident bank), host tensors on the
host, pinned where the template is (the streamed bank), so a checkpoint
taken under one bank resumes under the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.tree import path_key

# the fields of the port's state dataclasses that hold PRNG keys
_KEY_FIELDS = ("key", "lanes")


def _walk(tree, prefix: Tuple[str, ...] = (), is_key: bool = False
          ) -> Iterator[Tuple[str, Any, bool]]:
    """(path, leaf, is_key) of every leaf, in pytree order."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), prefix + ("." + f.name,),
                             f.name in _KEY_FIELDS)
    elif isinstance(tree, dict):
        for k in sorted(tree, key=path_key):
            yield from _walk(tree[k], prefix + tuple(str(k).split(".")),
                             is_key)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),), is_key)
    else:
        yield "/".join(prefix), tree, is_key


def _to_numpy(leaf, is_key: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz cannot hold bf16: widen (exactly)
            t = t.float()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if is_key:
        arr = (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf, is_key)
            for path, leaf, is_key in _walk(tree)}


def save(path: str, tree, meta: Dict[str, Any] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **_flatten(tree))
    if meta is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def _place(arr: np.ndarray, like):
    """``arr`` as a leaf like ``like``: its dtype and where it lives."""
    if not isinstance(like, torch.Tensor):
        return np.asarray(arr).astype(np.asarray(like).dtype)
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(like.dtype)
    else:
        np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        t = torch.from_numpy(np.array(arr).astype(np_dtype))
    if like.device.type == "cpu":
        if like.is_pinned():
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)
        return t
    return t.to(like.device)


def _rebuild(like, leaves: Iterator):
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves)
               for k in sorted(like, key=path_key)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def restore(path: str, like) -> Any:
    """Restore into the structure of ``like`` (the shape and dtype
    template): each leaf in its template's dtype, where the template leaf
    lives."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        paths = [(p, leaf) for p, leaf, _ in _walk(like)]
        want = {p for p, _ in paths}
        if set(data.files) != want:
            raise ValueError(f"checkpoint keys mismatch: "
                             f"{sorted(set(data.files) ^ want)}")
        leaves = [_place(data[p], leaf) for p, leaf in paths]
    return _rebuild(like, iter(leaves))


def load_meta(path: str) -> Dict[str, Any]:
    with open(os.path.splitext(path)[0] + ".json") as f:
        return json.load(f)


# ---------------------------------------------------- TrainState + bank

def save_train_state(path: str, state, *, backend: str = "resident",
                     extra_meta: Dict[str, Any] = None):
    """Checkpoint a :class:`repro_torch.fl.api.TrainState`, bank included.
    The bank's host (streamed) and device (resident) leaves flatten alike,
    so the layout does not depend on the backend; ``backend`` is recorded
    in the metadata for bookkeeping."""
    meta = {"kind": "train_state", "bank_backend": backend,
            "round": int(state.round),
            "spends": int(state.ledger.spends)}
    if extra_meta:
        meta.update(extra_meta)
    save(path, state, meta=meta)


def restore_train_state(path: str, like):
    """Restore a TrainState into the structure of ``like`` (e.g.
    ``trainer.init(key)``): each leaf where the template's lives, which is
    how a resident checkpoint opens as a streamed one and the reverse."""
    return restore(path, like)
