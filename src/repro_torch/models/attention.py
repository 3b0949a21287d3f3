"""Attention: GQA with 1-D RoPE or M-RoPE, the blockwise (online-softmax)
attention with positions and a validity mask, prefill through the flash
kernel, decode over a (ring-buffer) KV cache, the Whisper encoder's
bidirectional self-attention and cross-attention (port of
``repro/models/attention.py``).

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

The bidirectional and cross-attention (``attn_bidirectional``,
``cross_attn_apply``) call the kernel with ``causal=False``, q (B, Sq, H,
Dh) against k and v (B, Skv, Hkv, Dh); cross-attention also in decode
(Sq = 1 against the encoder's frames: no mask and no slot positions, the
kernel's own function). With M-RoPE positions over a vision prefix the
reference's causal mask compares the temporal ids, which are 0 over the
whole prefix: the prefix attends to itself both ways. Prefill runs that
mask through the kernel as two launches, the prefix's rows against the
prefix's keys with ``causal=False`` and the text rows against every key
with ``causal=True`` (the kernel's suffix alignment puts text row j at
key position prefix + j).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.models import layers
from repro_torch.sharding.rules import usable_axes

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
    if cfg.mrope and positions.ndim == 3:
        q = layers.apply_mrope(q, positions, cfg.rope_theta)
        k = layers.apply_mrope(k, positions, cfg.rope_theta)
    else:
        pos1 = positions if positions.ndim == 2 else positions[..., 0]
        q = layers.apply_rope(q, pos1, cfg.rope_theta)
        k = layers.apply_rope(k, pos1, cfg.rope_theta)
    return q, k, v


def _prefix_causal_fwd(q, k, v, prefix: int):
    """The kernel under the reference's mask over M-RoPE positions with a
    vision prefix of ``prefix`` rows (temporal id 0 on all of them): the
    prefix's rows attend to the whole prefix, text row j to the prefix and
    to text rows 0..j."""
    vision = flash_kernel.flash_attention_fwd(
        q[:, :prefix].contiguous(), k[:, :prefix].contiguous(),
        v[:, :prefix].contiguous(), causal=False)
    text = flash_kernel.flash_attention_fwd(q[:, prefix:].contiguous(), k,
                                            v, causal=True)
    return torch.cat([vision, text], dim=1)


def attn_train(p, cfg: ModelConfig, x, positions, *, window=None,
               use_kernel: bool = True):
    """Causal (optionally windowed) self-attention over positions 0..S-1
    (``transformer.text_positions``), or over the (B, S, 3) M-RoPE ids of
    ``transformer.mrope_positions``, which feed RoPE. With ``use_kernel``
    (prefill) q, k and v go through ``kernels/flash_attn`` (the kernel on
    the card, its plain version on the CPU), whose suffix-aligned mask
    assumes those positions (a vision prefix takes two launches, see the
    module's docstring); without it (training, which needs a backward the
    kernel does not have) through the blockwise ``flash_attention`` above,
    the reference's own training route, masked by the positions
    themselves (the temporal ids under M-RoPE). Returns (y, {k, v})."""
    q, k, v = _project(p, cfg, x, positions)
    window = window or cfg.sliding_window
    pos1 = positions if positions.ndim == 2 else positions[..., 0]
    prefix = cfg.vision_prefix if positions.ndim == 3 else 0
    if use_kernel and prefix:
        if window is not None:
            raise ValueError("a sliding window over M-RoPE positions is "
                             "not a suffix-aligned window: the kernel "
                             "cannot take it")
        out = _prefix_causal_fwd(q, k, v, prefix)
    elif use_kernel:
        out = flash_kernel.flash_attention_fwd(q, k, v, causal=True,
                                               window=window)
    else:
        out = flash_attention(q, k, v, pos1, pos1, causal=True,
                              window=window, block_kv=cfg.attn_block_kv)
    b, s = out.shape[:2]
    y = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return y, {"k": k, "v": v}


def kv_cache_spec(shape, mesh):
    """The spec of a (B, S, Hkv, Dh) decode cache on ``mesh`` (the
    reference's ``kv_cache_spec``): the batch over (pod, data) when it
    divides, and the head dim over `model` (the reference keeps the
    one-slot token write local that way), else the KV heads over
    `model`, else replicated."""
    usable = usable_axes(mesh)
    b, hkv, dh = shape[0], shape[2], shape[3]
    batch_axes = tuple(a for a in ("pod", "data") if a in usable)
    bsz = 1
    for a in batch_axes:
        bsz *= mesh.shape[a]
    if not batch_axes or b % bsz != 0:
        batch_axes = None
    msize = mesh.shape.get("model", 1)
    if "model" in usable and dh % msize == 0:
        return (batch_axes, None, None, "model")
    if "model" in usable and hkv % msize == 0:
        return (batch_axes, None, "model", None)
    return (batch_axes, None, None, None)


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
        if cfg.mrope:
            pos = pos[..., None].expand(b, 1, 3)
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


def attn_bidirectional(p, cfg: ModelConfig, x, positions, *,
                       use_kernel: bool = True):
    """The Whisper encoder's self-attention: every frame attends to every
    frame (``causal=False``, no window), through the kernel with
    ``use_kernel`` and the blockwise ``flash_attention`` without it (the
    reference's route, at its default KV block)."""
    q, k, v = _project(p, cfg, x, positions)
    if use_kernel:
        out = flash_kernel.flash_attention_fwd(q, k, v, causal=False)
    else:
        q_pos = positions if positions.ndim == 2 else positions[..., 0]
        out = flash_attention(q, k, v, q_pos, q_pos, causal=False,
                              window=None)
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


# ------------------------------------------------------------ cross-attention

def cross_attn_init(gen, cfg: ModelConfig, device, lead=()):
    return attn_init(gen, cfg, device, lead)


def cross_attn_apply(p, cfg: ModelConfig, x, enc_kv, *,
                     use_kernel: bool = True):
    """x (B, Sq, D) attends to the encoder's precomputed k and v (B, Skv,
    Hkv, Dh) with no mask: the kernel with ``causal=False`` (prefill and
    decode alike; k and v cast to the queries' dtype where the encoder ran
    in another), or without ``use_kernel`` the blockwise
    ``flash_attention`` under autograd."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim()
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, h, hd)
    k, v = enc_kv["k"], enc_kv["v"]
    if use_kernel:
        out = flash_kernel.flash_attention_fwd(q, k.to(q.dtype),
                                               v.to(q.dtype), causal=False)
    else:
        pos_q = torch.zeros((b, s), dtype=torch.int32, device=x.device)
        pos_kv = torch.zeros((b, k.shape[1]), dtype=torch.int32,
                             device=x.device)
        out = flash_attention(q, k, v, pos_q, pos_kv, causal=False,
                              window=None)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def encode_cross_kv(p, cfg: ModelConfig, enc_out):
    """The encoder output's k and v for one block's cross-attention, each
    (B, Senc, Hkv, Dh)."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return {"k": k.reshape(b, s, hkv, hd), "v": v.reshape(b, s, hkv, hd)}
