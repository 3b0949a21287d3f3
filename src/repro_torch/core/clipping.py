"""Gradient / update clipping (paper Assumption 1 via [21]); port of
``repro/core/clipping.py``."""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels.clip_norm import ops as clip_ops
from repro_torch.tree import Params, leaf_names, tree_leaves, tree_unflatten


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the leaves' sums of squares, summed in leaf order."""
    total = None
    for n in leaf_names(tree):
        s = torch.sum(torch.square(tree[n].float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def row_norms(u: torch.Tensor) -> torch.Tensor:
    """(rows,) f32 l2 norms of the rows of ``u``, each row's squares added
    by ``torch.sum`` a row at a time: the squares never take (rows, n)
    memory, and on the CPU the sum is pairwise, where
    ``torch.linalg.vector_norm`` keeps one f32 running sum a row (4.2e-5
    off the f64 norm of a ResNet update of 705,486 coordinates)."""
    u = u.float()
    if u.shape[0] == 0:
        return u.new_empty((0,))
    return torch.sqrt(torch.stack([torch.sum(row * row) for row in u]))


def clip_by_global_norm(tree: Params, clip: float):
    """x <- x * min(1, C/max(||x||, 1e-12)). Returns (clipped, pre-clip
    norm). The leaves are summed one by one in leaf order: the FL round's
    per-client clip, held to the golden digests, runs this."""
    nrm = global_norm(tree)
    scale = torch.clamp_max(
        torch.full_like(nrm, clip) / torch.clamp_min(nrm, 1e-12), 1.0)
    return {n: (x * scale).to(x.dtype) for n, x in tree.items()}, nrm


class FlatTree:
    """A nested tree's leaves as views of one flat f32 buffer, in pytree
    order, the buffer padded with zeros to whole 128-lane rows (the clip
    kernel's row view)."""

    def __init__(self, like):
        self.like = like
        leaves = tree_leaves(like)
        self.shapes = [tuple(x.shape) for x in leaves]
        self.dtypes = [x.dtype for x in leaves]
        self.sizes = [x.numel() for x in leaves]
        self.d = sum(self.sizes)
        self.padded = -(-self.d // clip_ops.LANES) * clip_ops.LANES

    def gather(self, tree) -> torch.Tensor:
        """The leaves of ``tree`` copied into a new f32 buffer (bf16 is
        widened exactly)."""
        leaves = tree_leaves(tree)
        flat = torch.empty((self.padded,), dtype=torch.float32,
                           device=leaves[0].device)
        flat[self.d:].zero_()
        for view, x in zip(self.views(flat), leaves):
            view.copy_(x)
        return flat

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        out, o = [], 0
        for shape, n in zip(self.shapes, self.sizes):
            out.append(flat[o:o + n].view(shape))
            o += n
        return out

    def tree(self, flat: torch.Tensor):
        """``like``'s structure over views of ``flat`` (no copy)."""
        return tree_unflatten(self.like, self.views(flat))


def clip_tree_flat(tree, clip: float) -> Tuple[torch.Tensor, torch.Tensor,
                                               FlatTree]:
    """The global-norm clip of a nested tree through one call of the
    ``clip_norm`` kernel: the leaves gathered into one flat f32 buffer
    (the kernel takes one dtype a call, and zamba2's leaves mix bf16 and
    f32), clipped by ``kernels/clip_norm/ops.clip_flat`` (its plain
    version for a CPU tensor), then each leaf's view rounded to the leaf's
    dtype in place, which gives the reference's ``(x * scale).astype(
    x.dtype)`` bit for bit: both form ``x * scale`` in f32. Returns (the
    clipped f32 buffer, padded, the pre-clip norm, and its ``FlatTree``);
    the gathered copy is freed before the return."""
    layout = FlatTree(tree)
    flat = layout.gather(tree)
    clipped, nrm = clip_ops.clip_flat(flat, clip)
    del flat
    for view, dtype in zip(layout.views(clipped), layout.dtypes):
        if dtype != torch.float32:
            view.copy_(view.to(dtype))
    return clipped, nrm, layout
