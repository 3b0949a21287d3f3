"""Plain PyTorch version of the flash-attention forward: softmax attention
with GQA and causal / windowed masks over suffix-aligned positions (port
of ``repro/kernels/flash_attn/ref.py``). The CPU route of
``kernel.flash_attention_fwd`` runs it; on the card it is only the
yardstick the kernel is held against. ``tensor_core_route`` emulates the
rounding of the kernel's bf16 route, for holding the card's output to a
few bf16 ulps.
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


# the finite mask value of the TPU kernel and of the CUDA kernels
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# how far (relative) the card's f32 p may sit from this emulation's: f32
# summation order in S and ex2.approx's error are ~2^-18 of p
P_MARGIN = 2.0 ** -14


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |x| (f32 x): 2^(floor(log2 |x|) - 7); 0 at
    0."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def tensor_core_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rounding of the kernel's bf16 route (``csrc/flash_attn.cu``),
    emulated: KV tiles of the kernel's width (128 keys; 64 at Dh >= 128),
    a running max with the finite NEG_INF for masked pairs and -inf for
    keys past Skv, l summed over the unrounded f32 p, P rounded to bf16 for
    P V (accumulated in f32), the output divided by max(l, 1e-30) and
    rounded to bf16. q: (B, Sq, H, Dh), k and v: (B, Skv, Hkv, Dh), bf16;
    plain torch ops on the inputs' device (f32 matmuls, so on a card with
    TF32 off).

    Returns the output (bf16, q's shape) and, in f32, how far a faithful
    kernel's output may sit from it: 2 bf16 ulps of the output (its
    rounding), the sum of ulp(p_j) |v_j| / l over the pairs whose p lies
    within P_MARGIN of a bf16 rounding midpoint (where the card's p may
    round the other way), and 2^-18 max|v| for the f32 sums' order."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    block = 64 if dh >= 128 else 128
    dev = q.device
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(h // hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    m = torch.full((b, h, sq, 1), NEG_INF, device=dev)
    l = torch.zeros((b, h, sq, 1), device=dev)
    acc = torch.zeros((b, h, sq, dh), device=dev)
    flip = torch.zeros((b, h, sq, dh), device=dev)
    rq = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    for k0 in range(0, skv, block):
        rk = torch.arange(k0, k0 + block, device=dev)[None, :]
        kt = torch.zeros((b, h, block, dh), device=dev)
        vt = torch.zeros((b, h, block, dh), device=dev)
        kt[:, :, :skv - k0] = kf[:, :, k0:k0 + block]
        vt[:, :, :skv - k0] = vf[:, :, k0:k0 + block]
        s = (qf @ kt.transpose(-1, -2)) / math.sqrt(dh)
        masked = torch.zeros((sq, block), dtype=torch.bool, device=dev)
        if causal:
            masked |= rq < rk
        if window is not None:
            masked |= rq - rk >= window
        s = s.masked_fill(masked, NEG_INF).masked_fill(rk >= skv, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vt
        # p's bf16 neighbours below and above, and the midpoint between
        lo = (p.view(torch.int32) & -0x10000).view(torch.float32)
        up = (lo.view(torch.int32) + 0x10000).view(torch.float32) - lo
        near = (p - (lo + up / 2)).abs() <= P_MARGIN * p
        flip = flip * corr + (near * up) @ vt.abs()
        m = m_new
    denom = l.clamp_min(1e-30)
    out = (acc / denom).bfloat16()
    limit = (2 * _bf16_ulp(out.float()) + flip / denom
             + 2.0 ** -18 * vf.abs().max())
    return out.transpose(1, 2), limit.transpose(1, 2)
