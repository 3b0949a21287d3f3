"""Entry points of the rand-k row gather (port of
``repro/kernels/randk_gather/ops.py``).

The flat update Delta (d,) is viewed as (d/128, 128) lane-aligned rows and
omega indexes rows: rand-k over 128-coordinate rows is the op's contract
(the reference's TPU mapping, kept so the two draw the same rows)."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.randk_gather.kernel import (LANES, check_shapes,
                                                     randk_gather)
from repro_torch.kernels.randk_gather.ref import randk_gather_ref


def gather_rows(delta_flat: torch.Tensor, idx_rows: torch.Tensor, scale,
                *, use_kernel: bool = True) -> torch.Tensor:
    """delta_flat: (d,) with d % 128 == 0; idx_rows: (k_rows,) int32.
    Returns the scaled gathered payload (k_rows * 128,); with
    ``use_kernel=False`` the plain version on any device."""
    d = delta_flat.shape[0]
    if d % LANES:
        raise ValueError(f"d = {d} is not a multiple of {LANES}")
    rows = delta_flat.reshape(d // LANES, LANES)
    if use_kernel:
        out = randk_gather(rows, idx_rows, scale)
    else:
        check_shapes(rows, idx_rows)
        out = randk_gather_ref(rows, idx_rows, scale)
    return out.reshape(-1)


def row_indices_from_coords(key, d: int, k: int) -> torch.Tensor:
    """rand-k over lane-aligned rows: ``permutation(key, d // 128)[:k_rows]``
    with k_rows = max(k // 128, 1), as int32 on the key's device."""
    rows = d // LANES
    k_rows = max(k // LANES, 1)
    return prng.permutation(key, rows)[:k_rows].to(torch.int32)
