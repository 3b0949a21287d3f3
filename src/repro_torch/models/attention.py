"""Attention: GQA with 1-D RoPE, the blockwise (online-softmax) attention
with positions and a validity mask, prefill through the flash kernel, and
decode over a (ring-buffer) KV cache (port of ``repro/models/attention.py``).

Prefill (``attn_train``) sends q, k and v through
``kernels/flash_attn``: the hand-written kernel on the card, its plain
version on the CPU. Training (``attn_train(use_kernel=False)``) takes the
blockwise ``flash_attention`` under autograd, as the reference trains.
The kernel keeps ``q * scale`` and the probabilities in f32, where
the reference's jnp ``flash_attention`` rounds both to the input dtype;
in f32 the two agree to f32 rounding, in bf16 to bf16 rounding. Decode
stays in plain torch ops (``flash_attention`` below): the TPU kernel has
no validity mask or slot positions, so a decode kernel would be no TPU
kernel's counterpart.

Cross-attention and M-RoPE wait for the encoder-decoder and VLM slices.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.models import layers

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attn_init(gen, cfg: ModelConfig, device, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    dtype = layers.torch_dtype(cfg.param_dtype)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": layers.normal(gen, (*lead, d, h * hd), s, dtype, device),
        "wk": layers.normal(gen, (*lead, d, hkv * hd), s, dtype, device),
        "wv": layers.normal(gen, (*lead, d, hkv * hd), s, dtype, device),
        "wo": layers.normal(gen, (*lead, h * hd, d), 1.0 / math.sqrt(h * hd),
                            dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=device)
    return p


# ------------------------------------------------------- blockwise attention

def _kv_block(qf, kc, vc, pc, vld, pos_q, m, l, acc, *, causal: bool,
              window: Optional[int]):
    """One KV block of the online softmax: the updated (m, l, acc)."""
    b, sq = qf.shape[:2]
    # scores (B, Sq, Hkv, G, block), f32
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf.float(), kc.float())
    mask = torch.ones((b, sq, kc.shape[1]), dtype=torch.bool,
                      device=qf.device)
    if causal:
        mask &= pos_q[:, :, None] >= pc[:, None, :]
    if window is not None:
        mask &= pos_q[:, :, None] - pc[:, None, :] < window
    if vld is not None:
        mask &= vld[:, None, :]
    s = s.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bqhgk,bkhd->bqhgd", p.to(vc.dtype).float(), vc.float())
    return m_new, l, acc


def flash_attention(q, k, v, pos_q, pos_kv, *, causal: bool,
                    window: Optional[int], kv_valid=None,
                    block_kv: int = 512):
    """Online-softmax attention over KV blocks, in plain torch ops.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh); pos_q: (B, Sq); pos_kv:
    (B, Skv) absolute positions (ring buffers pass slot positions);
    kv_valid: optional (B, Skv) bool. Returns (B, Sq, H, Dh) in q's dtype.
    As the reference does, ``q * scale`` and the probabilities are rounded
    to the input dtype before their products (accumulated in f32). When a
    gradient is being taken each KV block is checkpointed, as the
    reference's ``jax.checkpoint`` of its scan body: the backward
    recomputes the block's scores instead of keeping its probabilities.
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    qf = (q.float() * scale).to(q.dtype).reshape(b, sq, hkv, g, dh)
    if skv % block_kv != 0:
        block_kv = skv
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, dh), dtype=torch.float32,
                      device=q.device)
    block = functools.partial(_kv_block, causal=causal, window=window)
    for k0 in range(0, skv, block_kv):
        kv = slice(k0, k0 + block_kv)
        vld = kv_valid[:, kv] if kv_valid is not None else None
        m, l, acc = layers.checkpointed(block, qf, k[:, kv], v[:, kv],
                                        pos_kv[:, kv], vld, pos_q, m, l,
                                        acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


# --------------------------------------------------------------- full apply

def _project(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet: ROADMAP Queue 1, "
                                  "item 12 (VLM)")
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(p, cfg: ModelConfig, x, positions, *, window=None,
               use_kernel: bool = True):
    """Causal (optionally windowed) self-attention over positions 0..S-1
    (``transformer.text_positions``), which feed RoPE. With
    ``use_kernel`` (prefill) q, k and v go through ``kernels/flash_attn``
    (the kernel on the card, its plain version on the CPU), whose
    suffix-aligned mask assumes those positions; without it (training,
    which needs a backward the kernel does not have) through the blockwise
    ``flash_attention`` above, the reference's own training route.
    Returns (y, {k, v})."""
    q, k, v = _project(p, cfg, x, positions)
    window = window or cfg.sliding_window
    if use_kernel:
        out = flash_kernel.flash_attention_fwd(q, k, v, causal=True,
                                               window=window)
    else:
        out = flash_attention(q, k, v, positions, positions, causal=True,
                              window=window, block_kv=cfg.attn_block_kv)
    b, s = out.shape[:2]
    y = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return y, {"k": k, "v": v}


def make_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                      window: Optional[int], dtype, device, lead=()):
    """Full mode stores ``cache_len`` slots; sliding-window mode stores
    ``window`` slots as a ring buffer. ``idx`` counts the tokens already
    in context; ``slot_pos`` is the absolute position in each slot."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    slots = min(window, cache_len) if window else cache_len
    return {
        "k": torch.zeros((*lead, batch, slots, hkv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((*lead, batch, slots, hkv, hd), dtype=dtype,
                         device=device),
        "idx": torch.zeros(lead, dtype=torch.int32, device=device),
        "slot_pos": torch.zeros((*lead, slots), dtype=torch.int32,
                                device=device),
    }


def attn_decode(p, cfg: ModelConfig, x, cache, *, window: Optional[int],
                positions=None):
    """One-token decode. x: (B, 1, D). Writes this token's K/V into its
    slot (a ring-buffer write in sliding-window mode) and attends over the
    valid slots. Unlike the reference, the cache is updated in place (no
    copy of the whole KV cache per token) and returned; ``idx`` stays a
    device tensor, so there is no host round trip."""
    b = x.shape[0]
    idx = cache["idx"]
    slots = cache["k"].shape[1]
    if positions is None:
        pos = idx.to(torch.int64).reshape(1, 1).expand(b, 1)
    else:
        pos = positions
    q, k_new, v_new = _project(p, cfg, x, pos)
    if window is None:
        slot = torch.clamp_max(idx, slots - 1).to(torch.int64).reshape(1)
    else:
        slot = torch.remainder(idx, slots).to(torch.int64).reshape(1)
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    cache["slot_pos"].index_copy_(0, slot, idx.reshape(1))
    pos_kv = cache["slot_pos"][None, :].expand(b, slots)
    valid = pos_kv <= idx
    if window is not None:
        valid &= pos_kv > idx - window
    pos_q = idx.reshape(1, 1).expand(b, 1)
    out = flash_attention(q, cache["k"], cache["v"], pos_q, pos_kv,
                          causal=True, window=window, kv_valid=valid,
                          block_kv=2 * cfg.attn_block_kv)
    y = out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    idx.add_(1)
    return y, cache
