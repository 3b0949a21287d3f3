"""Mamba2 / SSD block (port of ``repro/models/mamba2.py``).

Prefill runs the chunked SSD scan: on the card through the hand-written
kernel (``kernels/ssd_scan``), on the CPU through its plain version
``ssd_chunked``. Decode is the one-step recurrence in plain torch ops.

Per head: h_t = a_t h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t h_t, with
a_t = exp(dt_t A) (A < 0 a scalar per head), B_t, C_t in R^N, x_t in R^P.

Params keep the reference's layout: ``in_proj`` (D, 2 d_inner + 2 N + H)
and ``out_proj`` (d_inner, D) for ``x @ w``; ``conv_w`` is (W, C), the
depthwise causal conv ``out[t] = sum_i xp[t + i] w[i]`` over the input
left-padded with W - 1 zeros (no flip).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models import layers

__all__ = ["ssd_chunked", "mamba_init", "mamba_train", "mamba_decode",
           "make_mamba_cache", "ssd_decode_step"]


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nheads = ssm.num_heads or d_inner // ssm.head_dim
    return d_inner, nheads, ssm.head_dim, ssm.state_dim


def mamba_init(gen, cfg: ModelConfig, device, lead=()):
    d = cfg.d_model
    ssm = cfg.ssm
    d_inner, nh, _, n = _dims(cfg)
    dtype = layers.torch_dtype(cfg.param_dtype)
    conv_dim = d_inner + 2 * n          # conv over the x, B, C streams
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                     device=device))
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (n), C (n), dt (nh)]
        "in_proj": layers.normal(gen, (*lead, d, 2 * d_inner + 2 * n + nh),
                                 1 / math.sqrt(d), dtype, device),
        "conv_w": layers.normal(gen, (*lead, ssm.conv_width, conv_dim),
                                1 / math.sqrt(ssm.conv_width), dtype, device),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "A_log": a_log.expand(*lead, nh).clone(),
        "D": torch.ones((*lead, nh), dtype=f32, device=device),
        "dt_bias": torch.zeros((*lead, nh), dtype=f32, device=device),
        "norm_scale": torch.ones((*lead, d_inner), dtype=dtype,
                                 device=device),
        "out_proj": layers.normal(gen, (*lead, d_inner, d),
                                  1 / math.sqrt(d_inner), dtype, device),
    }


def _split_proj(cfg, proj):
    d_inner, nh, _, n = _dims(cfg)
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * n, nh], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv of width W. xbc: (B,S,C). With ``conv_state``
    (B,W-1,C) (decode) it is prepended instead of zeros. Returns (out, new
    state): the last W - 1 inputs before the conv."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
        xp = torch.cat([pad, xbc], dim=1)
    else:
        xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    s = xbc.shape[1]
    cw = conv_w.to(xbc.dtype)
    out = xp[:, 0:s] * cw[0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * cw[i]
    out = F.silu(out + conv_b.to(xbc.dtype))
    new_state = xp[:, -(w - 1):] if w > 1 else None
    return out, new_state


def ssd_decode_step(x, dt, A, B, C, state):
    """One step of the recurrence. x: (b,h,p); dt: (b,h); B, C: (b,n);
    state: (b,h,p,n) -> (y (b,h,p), new state)."""
    a = torch.exp(dt.float() * A[None, :])                    # (b,h)
    xdt = x.float() * dt[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xdt, B.float())
    new_state = state * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y, new_state


def _gated_out(params, cfg, y, z, x_resid_D):
    d_inner = _dims(cfg)[0]
    y = y + params["D"][None, None, :, None] * x_resid_D
    y = y.reshape(y.shape[0], y.shape[1], d_inner)
    y = y.to(z.dtype) * F.silu(z)
    y = layers.norm_apply({"scale": params["norm_scale"]}, y, "rmsnorm")
    return y @ params["out_proj"].to(y.dtype)


def _dt(cfg, params, dt_raw):
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    return torch.clamp_min(dt, cfg.ssm.dt_min)


def prefill_chunk(cfg: ModelConfig, s: int) -> int:
    """The reference's chunk: the config's, halved until it divides s."""
    chunk = min(cfg.ssm.chunk_size, s)
    while chunk > 1 and s % chunk != 0:
        chunk //= 2
    return chunk


def mamba_train(params, cfg: ModelConfig, x_in, use_kernel: bool = True):
    """x_in: (B,S,D) -> ((B,S,D), the final SSD and conv state). With
    ``use_kernel`` the scan goes through ``kernels/ssd_scan`` (the kernel
    on the card, its plain version on the CPU); without it, through the
    plain version on any device."""
    d_inner, nh, p_dim, n = _dims(cfg)
    proj = x_in @ params["in_proj"].to(x_in.dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    b, s = xs.shape[:2]
    xh = xs.reshape(b, s, nh, p_dim)
    dt = _dt(cfg, params, dt_raw)
    A = -torch.exp(params["A_log"])
    chunk = prefill_chunk(cfg, s)
    if use_kernel:
        y, state = ssd_kernel.ssd_scan(xh, dt, A, B, C, chunk=chunk)
    else:
        y, state = ssd_chunked(xh, dt, A, B, C, chunk)
    out = _gated_out(params, cfg, y.to(x_in.dtype), z, xh.float())
    return out, {"ssm": state.float(), "conv": conv_state.to(x_in.dtype)}


def make_mamba_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    d_inner, nh, p_dim, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    return {"ssm": torch.zeros((*lead, batch, nh, p_dim, n),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, cfg.ssm.conv_width - 1,
                                 conv_dim), dtype=dtype, device=device)}


def mamba_decode(params, cfg: ModelConfig, x_in, cache):
    """x_in: (B,1,D); cache = {ssm (B,H,P,N), conv (B,W-1,C)}. Unlike the
    reference, the cache is updated in place and returned."""
    d_inner, nh, p_dim, n = _dims(cfg)
    proj = x_in @ params["in_proj"].to(x_in.dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   conv_state=cache["conv"])
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    b = xs.shape[0]
    xh = xs.reshape(b, nh, p_dim)
    dt = _dt(cfg, params, dt_raw[:, 0])
    A = -torch.exp(params["A_log"])
    y, new_ssm = ssd_decode_step(xh, dt, A, B[:, 0], C[:, 0], cache["ssm"])
    out = _gated_out(params, cfg, y[:, None].to(x_in.dtype), z,
                     xh[:, None].float())
    cache["ssm"].copy_(new_ssm)
    cache["conv"].copy_(conv_state)
    return out, cache
