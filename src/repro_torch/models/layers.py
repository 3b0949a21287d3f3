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


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def logits_apply(p_head_or_embed, x: torch.Tensor, *, tied: bool
                 ) -> torch.Tensor:
    if tied:
        return x @ p_head_or_embed["table"].to(x.dtype).T
    return x @ p_head_or_embed["w"].to(x.dtype)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
