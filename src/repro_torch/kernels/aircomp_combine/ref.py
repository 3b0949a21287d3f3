"""Plain PyTorch version of the AirComp server combine (port of
``repro/kernels/aircomp_combine/ref.py``): the server-side reconstruction
Delta_hat = (A^t)^T y / (r beta), fused with the global-model add
theta <- theta + Delta_hat (Alg. 2 lines 15-16), over 128-lane rows. The
CPU route of ``kernel.aircomp_combine`` runs it; on the card it is the
version the kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.kernels._route import scalar_like


def add_rows_(theta_rows: torch.Tensor, y_rows: torch.Tensor,
              idx_rows: torch.Tensor, inv_rbeta) -> torch.Tensor:
    """theta_rows[idx[j]] += (y[j] * inv).astype(theta's dtype) in place,
    inv cast to y's dtype first, in the order of idx (a duplicate row
    receives each of its adds in turn)."""
    upd = (y_rows * scalar_like(inv_rbeta, y_rows)).to(theta_rows.dtype)
    return theta_rows.index_add_(0, idx_rows, upd)


def aircomp_combine_ref(theta_rows: torch.Tensor, y_rows: torch.Tensor,
                        idx_rows: torch.Tensor, inv_rbeta) -> torch.Tensor:
    """theta_rows: (R, 128); y_rows: (k_rows, 128) received subcarrier
    payload; idx_rows: (k_rows,). Returns the updated theta_rows, a new
    tensor (``index_add_`` on a clone)."""
    return add_rows_(theta_rows.clone(), y_rows, idx_rows, inv_rbeta)
