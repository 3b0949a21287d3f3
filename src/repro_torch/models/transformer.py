"""Model assembly of the LLM stack: ``embed -> repeats of the block pattern
-> final norm -> head`` (port of ``repro/models/transformer.py``), with the
serving entry points ``prefill`` and ``decode_step``.

Params are the reference's tree with tensors for leaves:
``{"embed": {"table"}, "blocks": (one dict per pattern position),
"final_norm", "lm_head": {"w"}}``, where every block leaf carries a
leading repeat dim; an encoder-decoder adds ``enc_blocks`` (stacked the
same way) and ``enc_final_norm``. The forward order is repeat-major:
``for r in range(rep): for i, kind in enumerate(pattern)``. Caches have
the same stacked layout: one dict per pattern position, a leading repeat
dim on every leaf. ``decode_step`` updates them in place.

Every block kind and family of the reference: ``mamba``, ``attn`` and
``moe`` blocks (the ssm, hybrid, dense and MoE families); Whisper's
encoder (bidirectional, sinusoidal positions) with cross-attention in
every decoder block; the VLM's vision prefix with M-RoPE positions. The
MoE blocks' aux loss (their load-balance losses, summed over the pattern,
averaged over the repeats) enters the training loss at 0.01, as in the
reference. Like the reference, ``decode_step`` recomputes the encoder's
cross-attention k and v in every step.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mamba2
from repro_torch.models import moe as moe_lib


def text_positions(batch: int, seq: int, device="cuda"):
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos[None].expand(batch, seq)


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions: (B, S) -> (B, S, d) f32 sinusoids (sines, then
    cosines)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _grid(cfg: ModelConfig):
    """The vision prefix's grid width and the first text position."""
    vp = cfg.vision_prefix
    grid_w = max(int(math.sqrt(max(vp, 1))), 1)
    return grid_w, ((vp + grid_w - 1) // grid_w if vp else 0)


def mrope_positions(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """(B, S, 3) t/h/w ids: the vision prefix as a grid (t 0, row, column),
    then the text tokens at start, start + 1, ... on all three streams."""
    vp = cfg.vision_prefix
    grid_w, start = _grid(cfg)
    i = torch.arange(vp, device=device)
    vis = torch.stack([torch.zeros_like(i), i // grid_w, i % grid_w], dim=-1)
    t = torch.arange(seq - vp, device=device) + start
    txt = torch.stack([t, t, t], dim=-1)
    pos = torch.cat([vis, txt], dim=0).to(torch.int32)
    return pos[None].expand(batch, seq, 3)


def layer_view(tree, r: int):
    """The r-th repeat of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, r) for k, v in tree.items()}
    return tree[r]


# -------------------------------------------------------------------- init

def _block_init(gen, kind: str, cfg: ModelConfig, device, lead, *,
                cross: bool):
    dtype = layers.torch_dtype(cfg.param_dtype)
    p = {"ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, device, lead)}
    if kind == "mamba":
        p["mamba"] = mamba2.mamba_init(gen, cfg, device, lead)
        return p
    p["attn"] = attention.attn_init(gen, cfg, device, lead)
    if cross:
        p["ln_cross"] = layers.norm_init(cfg.d_model, cfg.norm, dtype,
                                         device, lead)
        p["cross"] = attention.cross_attn_init(gen, cfg, device, lead)
    p["ln2"] = layers.norm_init(cfg.d_model, cfg.norm, dtype, device, lead)
    if kind == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg, device, lead,
                                    experts_padded=cfg.moe.experts_padded(1))
    else:
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                   dtype, device, lead)
    return p


def init_params(key: torch.Tensor, cfg: ModelConfig,
                device="cuda") -> Dict[str, Any]:
    """Random params with the reference's shapes, scales and dtypes. The
    draws come from one ``torch.Generator`` on ``device`` seeded from the
    port's PRNG key (not JAX's draws: parity goes through ``convert``).
    On the ``meta`` device nothing is drawn: the tree of shapes."""
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
        "blocks": tuple(
            _block_init(gen, kind, cfg, device, (rep,),
                        cross=cfg.is_encoder_decoder and kind != "mamba")
            for kind in cfg.block_pattern),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": layers.normal(
            gen, (cfg.d_model, vpad), 1 / math.sqrt(cfg.d_model), dtype,
            device)}
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = _block_init(
            gen, "attn", cfg, device, (cfg.n_encoder_layers,), cross=False)
        params["enc_final_norm"] = layers.norm_init(cfg.d_model, cfg.norm,
                                                    dtype, device)
    return params


def init_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The params as ``meta`` tensors (shapes and dtypes, nothing
    allocated): the reference's ``init_shapes`` for the dry run."""
    return init_params(None, cfg, device="meta")


# the logical axis names of each leaf (``sharding.rules`` resolves them),
# as the reference's init functions return them beside their params
_ATTN_LOGICAL = {"wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
                 "wv": ("fsdp", "tensor"), "wo": ("tensor", "fsdp")}
_QKV_BIAS_LOGICAL = {"bq": ("tensor",), "bk": ("tensor",),
                     "bv": ("tensor",)}
_MAMBA_LOGICAL = {"in_proj": ("fsdp", "tensor"), "conv_w": (None, "tensor"),
                  "conv_b": ("tensor",), "A_log": (None,), "D": (None,),
                  "dt_bias": (None,), "norm_scale": ("tensor",),
                  "out_proj": ("tensor", "fsdp")}
_MOE_LOGICAL = {"router": (None, "tensor"), "wi": ("tensor", "fsdp", None),
                "wg": ("tensor", "fsdp", None),
                "wo": ("tensor", None, "fsdp")}


def _norm_logical(kind: str):
    if kind == "rmsnorm":
        return {"scale": (None,)}
    return {"scale": (None,), "bias": (None,)}


def _block_logical(kind: str, cfg: ModelConfig, *, cross: bool):
    attn = dict(_ATTN_LOGICAL, **(_QKV_BIAS_LOGICAL if cfg.qkv_bias
                                  else {}))
    lg = {"ln1": _norm_logical(cfg.norm)}
    if kind == "mamba":
        lg["mamba"] = dict(_MAMBA_LOGICAL)
        return lg
    lg["attn"] = attn
    if cross:
        lg["ln_cross"] = _norm_logical(cfg.norm)
        lg["cross"] = dict(attn)
    lg["ln2"] = _norm_logical(cfg.norm)
    if kind == "moe":
        lg["moe"] = dict(_MOE_LOGICAL)
    elif cfg.mlp_act == "swiglu":
        lg["mlp"] = {"wi": ("fsdp", "tensor"), "wg": ("fsdp", "tensor"),
                     "wo": ("tensor", "fsdp")}
    else:
        lg["mlp"] = {"wi": ("fsdp", "tensor"), "wo": ("tensor", "fsdp")}
    return lg


def _stacked(lg):
    """Every spec of a block's tree with the leading repeat axis."""
    if isinstance(lg, dict):
        return {k: _stacked(v) for k, v in lg.items()}
    return ("layers",) + tuple(lg)


def logical_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The params' tree of logical axis names (a tuple of names or None a
    leaf), the reference's ``logical_axes``: the tree its init functions
    return beside the params (``repro/models/layers.py``, ``attention``,
    ``mamba2``, ``moe``), stacked blocks with a leading ``"layers"``
    axis."""
    lg: Dict[str, Any] = {
        "embed": {"table": ("tensor", "fsdp")},
        "blocks": tuple(
            _stacked(_block_logical(kind, cfg, cross=cfg.is_encoder_decoder
                                    and kind != "mamba"))
            for kind in cfg.block_pattern),
        "final_norm": _norm_logical(cfg.norm),
    }
    if not cfg.tie_embeddings:
        lg["lm_head"] = {"w": ("fsdp", "tensor")}
    if cfg.is_encoder_decoder:
        lg["enc_blocks"] = _stacked(_block_logical("attn", cfg, cross=False))
        lg["enc_final_norm"] = _norm_logical(cfg.norm)
    return lg


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
                 cache=None, window=None, enc_kv=None, causal: bool = True):
    """Returns (x, cache, aux): the prefill's cache of the block (None for
    the encoder's), or the decode cache updated in place; aux holds a MoE
    block's metrics. ``mode="train"`` takes the plain model functions
    under autograd (the kernels have no backward), as the reference
    trains; ``"prefill"`` and ``"decode"`` the kernels (decode's
    self-attention excepted, see ``attention``). ``causal=False`` is the
    encoder's bidirectional self-attention; ``enc_kv`` adds the
    cross-attention."""
    aux = {}
    use_kernel = mode != "train"
    if kind == "mamba":
        with tracing.span("mamba"):
            h = layers.norm_apply(p["ln1"], x, cfg.norm, impl=cfg.norm_impl)
            if mode == "decode":
                y, new_cache = mamba2.mamba_decode(p["mamba"], cfg, h, cache)
            else:
                y, new_cache = mamba2.mamba_train(p["mamba"], cfg, h,
                                                  use_kernel=use_kernel)
            return x + y, new_cache, aux
    with tracing.span("attention"):
        h = layers.norm_apply(p["ln1"], x, cfg.norm, impl=cfg.norm_impl)
        if mode == "decode":
            y, new_cache = attention.attn_decode(p["attn"], cfg, h, cache,
                                                 window=window,
                                                 positions=positions)
        elif causal:
            y, new_cache = attention.attn_train(p["attn"], cfg, h, positions,
                                                window=window,
                                                use_kernel=use_kernel)
        else:
            y = attention.attn_bidirectional(p["attn"], cfg, h, positions,
                                             use_kernel=use_kernel)
            new_cache = None
        x = x + y
        if enc_kv is not None:
            hc = layers.norm_apply(p["ln_cross"], x, cfg.norm,
                                   impl=cfg.norm_impl)
            x = x + attention.cross_attn_apply(p["cross"], cfg, hc, enc_kv,
                                               use_kernel=use_kernel)
    with tracing.span("moe" if kind == "moe" else "mlp"):
        h2 = layers.norm_apply(p["ln2"], x, cfg.norm, impl=cfg.norm_impl)
        if kind == "moe":
            y2, moe_aux = moe_lib.moe_apply(p["moe"], cfg, h2)
            aux.update(moe_aux)
        else:
            y2 = layers.mlp_apply(p["mlp"], h2, cfg.mlp_act)
        return x + y2, new_cache, aux


def _unstack(tree, rep: int):
    """The ``rep`` repeats of a stacked tree as views: one list entry a
    repeat (``unbind``, whose backward stacks the repeats' gradients
    once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, rep) for k, v in tree.items()}
        return [{k: parts[k][r] for k in parts} for r in range(rep)]
    return list(torch.unbind(tree, 0))


def _cross_kv(blk, kind: str, cfg: ModelConfig, enc_out):
    """The cross-attention k and v of a decoder block, or None."""
    if enc_out is None or not cfg.is_encoder_decoder or kind == "mamba":
        return None
    return attention.encode_cross_kv(blk["cross"], cfg, enc_out)


# ----------------------------------------------------------------- encoder

def encode(params, cfg: ModelConfig, audio_embeds, *, mode: str = "prefill"):
    """Whisper's encoder over the stub frame embeddings (B, Senc, D):
    sinusoidal positions, then bidirectional blocks (the kernel with
    ``causal=False``, or with ``mode="train"`` the plain route under
    autograd), then the final norm."""
    b, s, _ = audio_embeds.shape
    pos = text_positions(b, s, device=audio_embeds.device)
    x = audio_embeds + sinusoidal_pos(pos, cfg.d_model).to(audio_embeds.dtype)
    for blk in _unstack(params["enc_blocks"], cfg.n_encoder_layers):
        x, _, _ = _block_apply(blk, "attn", cfg, x, pos, mode=mode,
                               causal=False)
    return layers.norm_apply(params["enc_final_norm"], x, cfg.norm,
                             impl=cfg.norm_impl)


def _embed_inputs(params, cfg: ModelConfig, tokens, extra_embeds):
    """tokens (B, S_text), and a vision prefix (B, P, D) or None. Returns
    (x, positions): M-RoPE ids over the prefix and the text for the VLM,
    else positions 0..S-1 (with sinusoids added where the config has no
    RoPE)."""
    x = layers.embed_apply(params["embed"], tokens)
    b = tokens.shape[0]
    if cfg.family == "vlm" and extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        pos = mrope_positions(cfg, b, x.shape[1], device=x.device)
    else:
        pos = text_positions(b, x.shape[1], device=x.device)
        if cfg.rope_theta <= 0:   # whisper: sinusoidal absolute
            x = x + sinusoidal_pos(pos, cfg.d_model).to(x.dtype)
    return x, pos


# ------------------------------------------------------------------- train

def forward_train(params, cfg: ModelConfig, batch, *, remat: bool = True,
                  window=None):
    """The training forward (port of the reference's ``forward_train``):
    ``batch`` = {tokens (B, S), labels (B, S), and the VLM's
    ``vision_embeds`` or Whisper's ``audio_embeds``}; returns (loss,
    metrics) with metrics {loss, aux_loss}. With ``remat`` each repeat of
    the block pattern is checkpointed (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` of its scan body): the backward keeps
    one (B, S, D) carry a repeat. The reference also puts an XLA
    optimization barrier on that carry, a scheduling hint whose gradient
    is the identity, which eager PyTorch has no use for. No loss is taken
    on the vision prefix. The loss streams over sequence chunks when S x
    padded vocab exceeds 2^26, as the reference's does."""
    tokens = batch["tokens"]
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch["audio_embeds"], mode="train")
    x, pos = _embed_inputs(params, cfg, tokens, batch.get("vision_embeds"))
    rep = cfg.resolved_repeat()
    stacks = [_unstack(blk, rep) for blk in params["blocks"]]

    def body(x, r):
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.block_pattern):
            blk = stacks[i][r]
            x, _, aux = _block_apply(blk, kind, cfg, x, pos, mode="train",
                                     window=window,
                                     enc_kv=_cross_kv(blk, kind, cfg,
                                                      enc_out))
            if "load_balance_loss" in aux:
                aux_sum = aux_sum + aux["load_balance_loss"]
        return x, aux_sum

    auxes = []
    for r in range(rep):
        x, aux = layers.checkpointed(body, x, r) if remat else body(x, r)
        auxes.append(aux)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm,
                          impl=cfg.norm_impl)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    labels = batch["labels"]
    if cfg.family == "vlm":  # no loss on the vision prefix
        x = x[:, x.shape[1] - labels.shape[1]:]
    vpad = layers.pad_vocab(cfg.vocab_size)
    if x.shape[1] * vpad > 2 ** 26:
        loss = layers.chunked_cross_entropy(x, head, labels, cfg.vocab_size,
                                            tied=cfg.tie_embeddings)
    else:
        logits = layers.logits_apply(head, x, tied=cfg.tie_embeddings)
        loss = layers.cross_entropy(logits, labels, cfg.vocab_size)
    aux = torch.mean(torch.stack(auxes))
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


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
    rep = cfg.resolved_repeat()
    return tuple(_init_block_cache(cfg, kind, batch, cache_len, window,
                                   dtype, device, (rep,))
                 for kind in cfg.block_pattern)


def prefill(params, cfg: ModelConfig, batch, *, window=None,
            extra_slots: int = 0, aux=None):
    """The forward over the prompt: ``batch`` = {tokens (B, S_text), and
    the VLM's ``vision_embeds`` (B, P, D) or Whisper's ``audio_embeds``
    (B, Senc, D)}. Returns (last logits (B, 1, V), caches, enc_out (the
    encoder's output, or None)); the KV caches hold S + ``extra_slots``
    slots (S counting the vision prefix), room for the decode steps that
    follow. Each block's aux metrics (a MoE block's load-balance loss and
    drop fraction) are appended to the list ``aux`` where one is given."""
    with tracing.span("prefill"):
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = encode(params, cfg, batch["audio_embeds"])
        x, pos = _embed_inputs(params, cfg, batch["tokens"],
                               batch.get("vision_embeds"))
        b, s = x.shape[:2]
        rep = cfg.resolved_repeat()
        with tracing.span("caches"):
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
                x, c, a = _block_apply(blk, kind, cfg, x, pos, mode="prefill",
                                       window=window,
                                       enc_kv=_cross_kv(blk, kind, cfg,
                                                        enc_out))
                if aux is not None:
                    aux.append(a)
                dst = caches[i]
                if kind == "mamba":
                    dst["ssm"][r].copy_(c["ssm"])
                    dst["conv"][r].copy_(c["conv"])
                else:
                    dst["k"][r, :, :s].copy_(c["k"])
                    dst["v"][r, :, :s].copy_(c["v"])
        with tracing.span("head"):
            logits = _head(params, cfg, x[:, -1:])
        return logits, caches, enc_out


def decode_step(params, cfg: ModelConfig, token, caches, *, window=None,
                enc_out=None):
    """token: (B, 1) -> (logits (B, 1, V), caches). Unlike the reference,
    the caches are updated in place (and returned). Whisper adds the
    sinusoid of the position ``idx`` and attends to ``enc_out``; under
    M-RoPE a text token at absolute index i sits at rotary position
    start + i - prefix on all three streams."""
    x = layers.embed_apply(params["embed"], token)
    b = token.shape[0]
    if cfg.rope_theta <= 0 and "idx" in caches[0]:
        pos = caches[0]["idx"][0].reshape(1, 1).expand(b, 1)
        x = x + sinusoidal_pos(pos, cfg.d_model).to(x.dtype)
    dec_pos = None
    if cfg.mrope and cfg.vision_prefix:
        idx0 = next((c["idx"][0] for c in caches if "idx" in c), None)
        if idx0 is not None:
            _, start = _grid(cfg)
            p1 = (idx0 - cfg.vision_prefix + start).to(torch.int32)
            dec_pos = p1.reshape(1, 1, 1).expand(b, 1, 3)
    for r in range(cfg.resolved_repeat()):
        for i, kind in enumerate(cfg.block_pattern):
            blk = layer_view(params["blocks"][i], r)
            x, _, _ = _block_apply(blk, kind, cfg, x, dec_pos, mode="decode",
                                   cache=layer_view(caches[i], r),
                                   window=window,
                                   enc_kv=_cross_kv(blk, kind, cfg, enc_out))
    return _head(params, cfg, x), caches
