"""Plain PyTorch version of the SSD chunk scan: ``ssd_chunked``, ported
from ``repro/models/mamba2.py`` (the reference's oracle for its Pallas
kernel). The CPU route of ``kernel.ssd_scan`` and ``models.mamba2`` run
it; on the card it is only the yardstick the kernel is held against.
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (b, s, h, p) values; dt: (b, s, h) positive step sizes; A: (h,)
    negative decay rates; B, C: (b, s, n) shared across heads (one B/C
    group). Returns y (b, s, h, p) f32 and the final state (b, h, p, n)
    f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"chunk {chunk} does not divide the sequence {s}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    # log decay per step: la[t] = dt[t] * A  (A < 0)
    la = dtc * A.float()[None, None, None, :]            # (b,nc,chunk,h)
    cum = torch.cumsum(la, dim=2)                         # inclusive
    # intra-chunk: y[i] += sum_{j<=i} exp(cum[i]-cum[j]) (C_i.B_j) dt_j x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,i,j,h)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, -torch.inf))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)          # (b,nc,i,j)
    w = cb[..., None] * decay                             # (b,nc,i,j,h)
    xdt = xc * dtc[..., None]                             # (b,nc,chunk,h,p)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)

    # chunk-final states: S_c = sum_j exp(cum[last]-cum[j]) B_j (dt_j x_j)^T
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)         # (b,nc,chunk,h)
    state_c = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, dec_last, xdt)

    # inter-chunk recurrence: H_c = exp(sum la_c) H_{c-1} + S_c
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,h)
    hcur = (initial_state.float() if initial_state is not None
            else torch.zeros((b, h, p, n), dtype=torch.float32,
                             device=x.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + state_c[:, c]
    hprev = torch.stack(hprevs, dim=1)                    # (b,nc,h,p,n)

    # carried-in contribution: y[i] += C_i . (exp(cum[i]) H_{c-1})
    y = y + torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cum), hprev)
    return y.reshape(b, s, h, p), hcur
