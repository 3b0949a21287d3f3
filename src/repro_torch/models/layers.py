"""Shared model layers of the LLM stack: norms, RoPE, MLPs, the embedding
and the head (port of ``repro/models/layers.py``).

Params are plain dicts of tensors. Matrices keep the reference's layout,
``(d_in, d_out)`` for ``x @ w``, so a JAX tree carries across without a
transpose (``repro_torch.convert.lm_params_from_jax``). Every init takes
``lead``, the leading repeat dims of a stacked block (``(rep,)``), an
explicit ``torch.Generator`` and a device; on the ``meta`` device it only
allocates (the shapes of a config, for checking a converted tree).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import prng


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------- initializers

def normal(gen: Optional[torch.Generator], shape: Sequence[int], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 and cast to ``dtype``, one leading
    slice at a time, so a stacked leaf never holds a whole f32 copy."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    rows = out.reshape(-1, *shape[-2:]) if len(shape) >= 3 else out[None]
    for i in range(rows.shape[0]):
        z = torch.randn(rows.shape[1:], generator=gen, dtype=torch.float32,
                        device=device)
        rows[i].copy_(z.mul_(scale))
    return out


def dense_init(key: torch.Tensor, d_in: int, d_out: int, *, bias: bool,
               dtype, device=None, logical=("fsdp", "tensor")):
    """A dense layer ``{"w": (d_in, d_out), "b": (d_out,)}`` and its
    logical axes, as the reference's ``dense_init`` returns them: the
    weight ``N(0, 1/d_in)`` from the first key of ``split(key)`` (the
    port's threefry, so the reference's weights bit for bit), drawn in f32
    and cast to ``dtype`` (a torch dtype or its name); the bias zeros. On
    ``device``, the key's by default."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    key = key.to(device) if device is not None else key
    kw, _ = prng.split(key)
    w = (1.0 / math.sqrt(d_in)) * prng.normal(kw, (d_in, d_out))
    p = {"w": w.to(dtype)}
    lg = {"w": logical}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=key.device)
        lg["b"] = (logical[1],)
    return p, lg


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(d: int, kind: str, dtype: torch.dtype, device, lead=()):
    p = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def norm_apply(p, x: torch.Tensor, kind: str, eps: float = 1e-6,
               impl: str = "f32") -> torch.Tensor:
    if impl == "stats_f32":
        # statistics in f32, scaling in the input dtype
        xf = x.float()
        if kind == "rmsnorm":
            ms = torch.mean(xf * xf, dim=-1, keepdim=True)
            r = torch.rsqrt(ms + eps).to(x.dtype)
            y = x * r * p["scale"].to(x.dtype)
        else:
            mu = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
            r = torch.rsqrt(var + eps).to(x.dtype)
            y = (x - mu.to(x.dtype)) * r * p["scale"].to(x.dtype)
        if "bias" in p:
            y = y + p["bias"].to(x.dtype)
        return y
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int. Standard 1-D RoPE on the
    two halves of Dh."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (dh/2,)
    ang = positions[..., None].float() * freqs                  # (B,S,dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float
                ) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): x (B, S, H, Dh); positions3 (B, S, 3), the (t,
    h, w) ids. The rotary spectrum splits into three sections, about 2/8,
    3/8 and 3/8 of it, each turned by its own position stream."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    s_t = half // 4
    s_h = (half - s_t) // 2
    sect = torch.tensor([0] * s_t + [1] * s_h + [2] * (half - s_t - s_h),
                        device=x.device)
    pos = positions3.float()[..., sect]                         # (B,S,half)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ MLPs

def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype, device,
             lead=()):
    p = {"wi": normal(gen, (*lead, d_model, d_ff), 1 / math.sqrt(d_model),
                      dtype, device)}
    if act == "swiglu":
        p["wg"] = normal(gen, (*lead, d_model, d_ff), 1 / math.sqrt(d_model),
                         dtype, device)
    p["wo"] = normal(gen, (*lead, d_ff, d_model), 1 / math.sqrt(d_ff), dtype,
                     device)
    return p


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"].to(x.dtype), approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ----------------------------------------------------------- embedding / head

def embed_init(gen, vocab_padded: int, d_model: int, dtype, device):
    return {"table": normal(gen, (vocab_padded, d_model), 1.0, dtype,
                            device)}


class _EmbedLookup(torch.autograd.Function):
    """The rows of ``table`` at ``tokens``, with the reference's custom
    VJP: the cotangent is scatter-added into f32 zeros and cast to the
    table's dtype once, so repeated tokens are summed in f32 (the
    autograd of a bf16 lookup would sum them in bf16)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, ct):
        (tokens,) = ctx.saved_tensors
        d = ctx.table_shape[1]
        g = torch.zeros(ctx.table_shape, dtype=torch.float32,
                        device=ct.device)
        g.index_add_(0, tokens.reshape(-1), ct.reshape(-1, d).float())
        return g.to(ctx.table_dtype), None


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return _EmbedLookup.apply(p["table"], tokens.long())


def logits_apply(p_head_or_embed, x: torch.Tensor, *, tied: bool
                 ) -> torch.Tensor:
    if tied:
        return x @ p_head_or_embed["table"].to(x.dtype).T
    return x @ p_head_or_embed["w"].to(x.dtype)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


# --------------------------------------------------------------- the losses

def checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    intermediates (``jax.checkpoint``) when a gradient is being taken
    through a tensor argument (serving takes none and runs ``fn``
    plainly)."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           preserve_rng_state=False)
    return fn(*args)


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """(sum of the token NLLs, count of valid labels) in f32. The padded
    vocab columns get -1e9; labels < 0 are ignored."""
    vpad = logits.shape[-1]
    logits = logits.float()
    if vpad > vocab:
        bias = torch.zeros((vpad,), dtype=torch.float32,
                           device=logits.device)
        bias[vocab:] = -1e9
        logits = logits + bias
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return torch.sum(nll), torch.sum(valid).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    """Mean token cross-entropy over the valid labels (labels < 0 are
    ignored, the padded vocab columns excluded)."""
    nll, n_valid = _ce_sums(logits, labels, vocab)
    return nll / torch.clamp_min(n_valid, 1.0)


def chunked_cross_entropy(x: torch.Tensor, head, labels: torch.Tensor,
                          vocab: int, *, tied: bool, chunk: int = 512
                          ) -> torch.Tensor:
    """The cross-entropy without the whole (B, S, V) logits: the logits
    and NLL of one sequence chunk at a time, each chunk checkpointed (the
    backward recomputes its logits), the sums carried in chunk order."""
    s = x.shape[1]
    if s % chunk != 0:
        chunk = s

    def body(x_c, l_c):
        return _ce_sums(logits_apply(head, x_c, tied=tied), l_c, vocab)

    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        nll, nv = checkpointed(body, x[:, c0:c0 + chunk],
                               labels[:, c0:c0 + chunk])
        nll_sum = nll_sum + nll
        n_valid = n_valid + nv
    return nll_sum / torch.clamp_min(n_valid, 1.0)
