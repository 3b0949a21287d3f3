"""Entry point of the AirComp server combine (port of
``repro/kernels/aircomp_combine/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.aircomp_combine.kernel import (LANES,
                                                        aircomp_combine,
                                                        check_shapes)
from repro_torch.kernels.aircomp_combine.ref import aircomp_combine_ref


def combine(theta_flat: torch.Tensor, y_payload: torch.Tensor,
            idx_rows: torch.Tensor, r: int, beta, *,
            use_kernel: bool = True) -> torch.Tensor:
    """theta_flat: (d,) with d % 128 == 0; y_payload: (k_rows * 128,)
    received signal; idx_rows: (k_rows,) int32. Returns the updated theta
    (d,), a new tensor: the caller's theta is left as it was (the kernel
    updates a clone in place). ``use_kernel=False`` runs the plain version
    on any device."""
    d = theta_flat.shape[0]
    if d % LANES:
        raise ValueError(f"d = {d} is not a multiple of {LANES}")
    theta_rows = theta_flat.reshape(d // LANES, LANES)
    y_rows = y_payload.reshape(-1, LANES)
    inv = 1.0 / (r * beta)
    if use_kernel:
        out = aircomp_combine(theta_rows.clone(), y_rows, idx_rows, inv)
    else:
        check_shapes(theta_rows, y_rows, idx_rows)
        out = aircomp_combine_ref(theta_rows, y_rows, idx_rows, inv)
    return out.reshape(-1)
