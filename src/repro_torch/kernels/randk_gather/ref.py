"""Plain PyTorch version of the rand-k row gather with the power scale
(port of ``repro/kernels/randk_gather/ref.py``): x_i = beta/|h_i| *
A^t Delta over 128-lane rows. The CPU route of ``kernel.randk_gather``
runs it; on the card it is the version the kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.kernels._route import scalar_like


def randk_gather_ref(delta_rows: torch.Tensor, idx_rows: torch.Tensor,
                     scale) -> torch.Tensor:
    """delta_rows: (R, 128); idx_rows: (k_rows,) int32 or int64; scale: a
    number or a one-element tensor, cast to delta's dtype first (so in
    bf16 the product rounds to bf16). Returns (k_rows, 128)."""
    return (torch.index_select(delta_rows, 0, idx_rows)
            * scalar_like(scale, delta_rows))
