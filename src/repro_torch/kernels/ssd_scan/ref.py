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


def warp_cumsum(la: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim in the order of the kernels'
    one-warp scan (``csrc/ssd_scan.cu`` ``warp_cumsum``), in f32: each of
    32 lanes sums a contiguous segment of ceil(q / 32) values in order,
    the lane totals are scanned Hillis-Steele (offsets 1, 2, 4, 8, 16),
    and each segment adds the total of the lanes before it."""
    q = la.shape[-1]
    per = -(-q // 32)
    v = torch.nn.functional.pad(la.float(), (0, 32 * per - q))
    v = v.reshape(*la.shape[:-1], 32, per)
    runs = [v[..., 0]]
    for k in range(1, per):
        runs.append(runs[-1] + v[..., k])
    seg = torch.stack(runs, dim=-1)                       # (..., 32, per)
    incl = seg[..., -1]
    lane = torch.arange(32, device=la.device)
    for off in (1, 2, 4, 8, 16):
        shifted = torch.nn.functional.pad(incl[..., :-off], (off, 0))
        incl = torch.where(lane >= off, incl + shifted, incl)
    excl = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    out = torch.where(lane[:, None] > 0, seg + excl[..., None], seg)
    return out.reshape(*la.shape[:-1], 32 * per)[..., :q]


def _split(v: torch.Tensor, split: bool):
    """v (f32) as its bf16 halves hi = bf16(v), lo = bf16(v - hi), in f32;
    lo is 0 with ``split=False`` (one bf16 rounding)."""
    hi = v.bfloat16().float()
    lo = (v - hi).bfloat16().float() if split else torch.zeros_like(v)
    return hi, lo


def split_bf16_route(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, chunk: int, *,
                     split: bool = True):
    """The rounding of the kernel's bf16 route (``csrc/ssd_scan.cu``),
    emulated in plain torch ops (f32 matmuls: on a card, TF32 off).

    x (b, s, h, p), B and C (b, s, n) bf16 and exact; dt (b, s, h) and A
    (h,) f32. Per chunk, in order, from a zero state H:
    cum = ``warp_cumsum(dt A)``;
    G[i][j] = (C B^T)[i][j] (exp(cum_i - cum_j) dt_j) for j <= i, else 0;
    W[j][n] = B[j][n] (exp(cum_last - cum_j) dt_j);
    y = exp(cum_i) (C Hhi^T + C Hlo^T) + Ghi x + Glo x;
    H = exp(cum_last) H + x^T Whi + x^T Wlo;
    where v = hi + lo are the bf16 halves of each f32 operand (lo = 0 with
    ``split=False``: one bf16 rounding of G, H and W, which the kernel
    does not do).

    Returns y (b, s, h, p) and the final state (b, h, p, n), f32, and
    their abs-value scales, in f32:
    y_abs = (|C| |B|^T o L o dt) |x| + 2 exp(cum_i) |C| Habs^T and
    state_abs = Habs, with Habs = exp(cum_last) Habs + |x|^T |W| (so
    Habs >= |H|) and L the causal decays. Each half-pair is off its f32
    operand by at most 2^-18 of it, so the split moves y by at most
    2^-18 y_abs (G's residuals, |G| <= |C| |B|^T o L o dt; H's own; the
    residuals of W carried in H) and the state by 2^-18 state_abs. The
    same sums of |terms| bound the f32 sums' order."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"chunk {chunk} does not divide the sequence {s}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    la = dtc * A.float()[None, None, None, :]
    cum = warp_cumsum(la.transpose(2, 3)).transpose(2, 3)   # (b,nc,q,h)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,i,j,h)
    decay = torch.exp(torch.where(causal, seg, 0.0)) * dtc[:, :, None]
    del seg
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    g = torch.where(causal, cb[..., None] * decay, 0.0)
    g_hi, g_lo = _split(g, split)
    y = (torch.einsum("bcijh,bcjhp->bcihp", g_hi, xc)
         + torch.einsum("bcijh,bcjhp->bcihp", g_lo, xc))
    del g, g_hi, g_lo
    cb_abs = torch.einsum("bcin,bcjn->bcij", Cc.abs(), Bc.abs())
    y_abs = torch.einsum("bcijh,bcjhp->bcihp",
                         torch.where(causal, cb_abs[..., None] * decay, 0.0),
                         xc.abs())
    cl = cum[:, :, -1, :]                                   # (b,nc,h)
    w = Bc[:, :, :, None, :] * (torch.exp(cl[:, :, None] - cum)
                                * dtc)[..., None]          # (b,nc,j,h,n)
    w_hi, w_lo = _split(w, split)
    upd = (torch.einsum("bcjhp,bcjhn->bchpn", xc, w_hi)
           + torch.einsum("bcjhp,bcjhn->bchpn", xc, w_lo))
    upd_abs = torch.einsum("bcjhp,bcjhn->bchpn", xc.abs(), w.abs())
    del w, w_hi, w_lo
    ecum = torch.exp(cum)                                   # (b,nc,q,h)
    ecl = torch.exp(cl)
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    habs = torch.zeros_like(hcur)
    carry, carry_abs = [], []
    for c in range(nc):
        h_hi, h_lo = _split(hcur, split)
        carry.append((torch.einsum("bin,bhpn->bihp", Cc[:, c], h_hi)
                      + torch.einsum("bin,bhpn->bihp", Cc[:, c], h_lo))
                     * ecum[:, c, :, :, None])
        carry_abs.append(torch.einsum("bin,bhpn->bihp", Cc[:, c].abs(), habs)
                         * ecum[:, c, :, :, None])
        hcur = ecl[:, c, :, None, None] * hcur + upd[:, c]
        habs = ecl[:, c, :, None, None] * habs + upd_abs[:, c]
    y = torch.stack(carry, dim=1) + y
    y_abs = y_abs + 2 * torch.stack(carry_abs, dim=1)
    return y.reshape(b, s, h, p), hcur, y_abs.reshape(b, s, h, p), habs
