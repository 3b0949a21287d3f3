"""Model assembly of the LLM stack: ``embed -> repeats of the block pattern
-> final norm -> head`` (port of ``repro/models/transformer.py``), with the
serving entry points ``prefill`` and ``decode_step``.

Params are the reference's tree with tensors for leaves:
``{"embed": {"table"}, "blocks": (one dict per pattern position),
"final_norm", "lm_head": {"w"}}``, where every block leaf carries a
leading repeat dim. The forward order is repeat-major:
``for r in range(rep): for i, kind in enumerate(pattern)``. Caches have
the same stacked layout: one dict per pattern position, a leading repeat
dim on every leaf. ``decode_step`` updates them in place.

Ported: the ``mamba`` and ``attn`` blocks (the ssm, hybrid and dense
families). ``moe`` blocks, the Whisper encoder, the VLM prefix with
M-RoPE, sampling and ``forward_train`` raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mamba2

_LATER = "ROADMAP Queue 1, item 12"


def _check_ported(cfg: ModelConfig) -> None:
    if "moe" in cfg.block_pattern:
        raise NotImplementedError(f"moe blocks are not ported yet: {_LATER} "
                                  f"(MoE)")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"the Whisper encoder is not ported yet: "
                                  f"{_LATER} (Whisper)")
    if cfg.family == "vlm" or cfg.mrope:
        raise NotImplementedError(f"the VLM prefix and M-RoPE are not ported "
                                  f"yet: {_LATER} (VLM)")
    if cfg.rope_theta <= 0:
        raise NotImplementedError(f"sinusoidal positions are not ported yet: "
                                  f"{_LATER} (Whisper)")
    for kind in cfg.block_pattern:
        if kind not in ("mamba", "attn"):
            raise NotImplementedError(f"block kind {kind!r} is not ported "
                                      f"yet: {_LATER}")


def text_positions(batch: int, seq: int, device="cuda"):
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos[None].expand(batch, seq)


def layer_view(tree, r: int):
    """The r-th repeat of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, r) for k, v in tree.items()}
    return tree[r]


# -------------------------------------------------------------------- init

def _block_init(gen, kind: str, cfg: ModelConfig, device, lead):
    dtype = layers.torch_dtype(cfg.param_dtype)
    p = {"ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, device, lead)}
    if kind == "mamba":
        p["mamba"] = mamba2.mamba_init(gen, cfg, device, lead)
        return p
    p["attn"] = attention.attn_init(gen, cfg, device, lead)
    p["ln2"] = layers.norm_init(cfg.d_model, cfg.norm, dtype, device, lead)
    p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                               dtype, device, lead)
    return p


def init_params(key: torch.Tensor, cfg: ModelConfig,
                device="cuda") -> Dict[str, Any]:
    """Random params with the reference's shapes, scales and dtypes. The
    draws come from one ``torch.Generator`` on ``device`` seeded from the
    port's PRNG key (not JAX's draws: parity goes through ``convert``).
    On the ``meta`` device nothing is drawn: the tree of shapes."""
    _check_ported(cfg)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        w0, w1 = (int(w) for w in key.tolist())
        gen = torch.Generator(device=device).manual_seed((w0 << 32) | w1)
    rep = cfg.resolved_repeat()
    dtype = layers.torch_dtype(cfg.param_dtype)
    vpad = layers.pad_vocab(cfg.vocab_size)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, vpad, cfg.d_model, dtype, device),
        "blocks": tuple(_block_init(gen, kind, cfg, device, (rep,))
                        for kind in cfg.block_pattern),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": layers.normal(
            gen, (cfg.d_model, vpad), 1 / math.sqrt(cfg.d_model), dtype,
            device)}
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


# ------------------------------------------------------------------- blocks

def _block_apply(p, kind: str, cfg: ModelConfig, x, positions, *, mode: str,
                 cache=None, window=None):
    """Returns (x, cache): the prefill's cache of the block, or the decode
    cache updated in place."""
    h = layers.norm_apply(p["ln1"], x, cfg.norm, impl=cfg.norm_impl)
    if kind == "mamba":
        if mode == "decode":
            y, new_cache = mamba2.mamba_decode(p["mamba"], cfg, h, cache)
        else:
            y, new_cache = mamba2.mamba_train(p["mamba"], cfg, h)
        return x + y, new_cache
    if mode == "decode":
        y, new_cache = attention.attn_decode(p["attn"], cfg, h, cache,
                                             window=window,
                                             positions=positions)
    else:
        y, new_cache = attention.attn_train(p["attn"], cfg, h, positions,
                                            window=window)
    x = x + y
    h2 = layers.norm_apply(p["ln2"], x, cfg.norm, impl=cfg.norm_impl)
    return x + layers.mlp_apply(p["mlp"], h2, cfg.mlp_act), new_cache


def forward_train(*args, **kwargs):
    raise NotImplementedError(f"training of the LLM stack is not ported yet: "
                              f"{_LATER} (training, optim/, steps.py)")


# ----------------------------------------------------------------- serving

def _head(params, cfg, x):
    x = layers.norm_apply(params["final_norm"], x, cfg.norm,
                          impl=cfg.norm_impl)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return layers.logits_apply(head, x, tied=cfg.tie_embeddings)


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int, window, dtype, device, lead=()):
    if kind == "mamba":
        return mamba2.make_mamba_cache(cfg, batch, dtype, device, lead)
    return attention.make_decode_cache(cfg, batch, cache_len, window=window,
                                       dtype=dtype, device=device, lead=lead)


def make_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                window=None, dtype=torch.bfloat16, device="cuda"):
    """Empty stacked caches: one dict per pattern position, a leading
    repeat dim on every leaf."""
    _check_ported(cfg)
    rep = cfg.resolved_repeat()
    return tuple(_init_block_cache(cfg, kind, batch, cache_len, window,
                                   dtype, device, (rep,))
                 for kind in cfg.block_pattern)


def prefill(params, cfg: ModelConfig, batch, *, window=None,
            extra_slots: int = 0):
    """The forward over the prompt ``batch["tokens"]`` (B, S). Returns
    (last logits (B, 1, V), caches, None); the KV caches hold S +
    ``extra_slots`` slots, room for the decode steps that follow."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = layers.embed_apply(params["embed"], tokens)
    pos = text_positions(b, s, device=x.device)
    rep = cfg.resolved_repeat()
    caches = make_caches(cfg, b, s + extra_slots, dtype=x.dtype,
                         device=x.device)
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "mamba":
            caches[i]["idx"].fill_(s)
            caches[i]["slot_pos"].copy_(torch.arange(
                s + extra_slots, dtype=torch.int32, device=x.device))
    for r in range(rep):
        for i, kind in enumerate(cfg.block_pattern):
            blk = layer_view(params["blocks"][i], r)
            x, c = _block_apply(blk, kind, cfg, x, pos, mode="prefill",
                                window=window)
            dst = caches[i]
            if kind == "mamba":
                dst["ssm"][r].copy_(c["ssm"])
                dst["conv"][r].copy_(c["conv"])
            else:
                dst["k"][r, :, :s].copy_(c["k"])
                dst["v"][r, :, :s].copy_(c["v"])
    return _head(params, cfg, x[:, -1:]), caches, None


def decode_step(params, cfg: ModelConfig, token, caches, *, window=None,
                enc_out=None):
    """token: (B, 1) -> (logits (B, 1, V), caches). Unlike the reference,
    the caches are updated in place (and returned)."""
    _check_ported(cfg)
    if enc_out is not None:
        raise NotImplementedError(f"cross-attention is not ported yet: "
                                  f"{_LATER} (Whisper)")
    x = layers.embed_apply(params["embed"], token)
    for r in range(cfg.resolved_repeat()):
        for i, kind in enumerate(cfg.block_pattern):
            blk = layer_view(params["blocks"][i], r)
            x, _ = _block_apply(blk, kind, cfg, x, None, mode="decode",
                                cache=layer_view(caches[i], r),
                                window=window)
    return _head(params, cfg, x), caches
