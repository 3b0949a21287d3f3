"""Plain PyTorch version of the flash-attention forward: softmax attention
with GQA and causal / windowed masks over suffix-aligned positions (port
of ``repro/kernels/flash_attn/ref.py``). The CPU route of
``kernel.flash_attention_fwd`` runs it; on the card it is only the
yardstick the kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None
                  ) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's
    dtype, computed in f32. Query row i sits at position i + Skv - Sq."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    s = s / math.sqrt(dh)
    iq = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ik = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= iq >= ik
    if window is not None:
        mask &= iq - ik < window
    s = s.masked_fill(~mask[None, :, None, None, :], -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)
