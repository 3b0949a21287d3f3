"""Mixture-of-Experts MLP: a top-k softmax router, a sort-based capacity
dispatch and the experts' products (port of ``repro/models/moe.py``).

The reference dispatches inside G groups, G the size of the mesh's
``data`` axis; with no mesh G = 1, and its layout changes around the
expert products (``_to_expert_layout``, ``_from_expert_layout``) are an
axis swap of a size-1 axis. The port has one group and drops that axis.

The (expert, slot) <-> (token, k-slot) map of a routing plan is a
permutation (a slot holds at most one token), so dispatch, combine and
both of their backwards are gathers, as the reference's custom VJPs make
them (``_DispatchGather``, ``_CombineGather``), never a scatter-add.

Experts may be padded (``MoEConfig.padded_experts``): the router's logits
of the pads are -1e9, so routing never picks them. Capacity is
``max(ceil(T k / E capacity_factor), 4)`` slots an expert; the tokens
past it are dropped (their k-slot adds nothing), in the order of a stable
sort by expert.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def moe_init(gen, cfg: ModelConfig, device, lead=(),
             experts_padded: int = None):
    moe = cfg.moe
    d, ff = cfg.d_model, moe.expert_ff
    e = experts_padded or moe.experts_padded(1)
    dtype = layers.torch_dtype(cfg.param_dtype)
    return {
        "router": layers.normal(gen, (*lead, d, e), 1 / math.sqrt(d),
                                torch.float32, device),
        "wi": layers.normal(gen, (*lead, e, d, ff), 1 / math.sqrt(d), dtype,
                            device),
        "wg": layers.normal(gen, (*lead, e, d, ff), 1 / math.sqrt(d), dtype,
                            device),
        "wo": layers.normal(gen, (*lead, e, ff, d), 1 / math.sqrt(ff), dtype,
                            device),
    }


def _routing_plan(top_e: torch.Tensor, e: int, cap: int):
    """The sort-based plan of one dispatch group. top_e: (T, k) expert ids.
    ``flat_e`` (T k,) the expert of each k-slot, ``pos_k`` its slot in
    that expert (clamped to cap - 1 where dropped), ``keep`` whether it
    fits; ``tok_idx`` (E, cap) the k-slot each expert slot holds and
    ``slot_valid`` whether it holds one."""
    flat_e = top_e.reshape(-1)
    tk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    ranks = torch.argsort(order)                           # inverse perm
    # the reference's bincount(length=e): a fixed length, which also
    # runs on the meta device (torch.bincount's length is the data's)
    counts = torch.zeros((e,), dtype=torch.int64,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int64))
    starts = torch.cumsum(counts, 0) - counts
    pos = ranks - starts[flat_e]                           # pos in expert
    keep = pos < cap
    pos_k = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    slots = torch.arange(cap, device=top_e.device)
    slot_rank = starts[:, None] + slots[None, :]           # (E, cap)
    slot_valid = slots[None, :] < torch.clamp_max(counts, cap)[:, None]
    tok_idx = order[torch.clamp(slot_rank, 0, tk - 1)]
    return {"flat_e": flat_e, "pos_k": pos_k, "keep": keep,
            "tok_idx": tok_idx, "slot_valid": slot_valid,
            "lin": flat_e * cap + pos_k}


class _DispatchGather(torch.autograd.Function):
    """(T k, D) -> (E, cap, D): the sorted k-slot rows gathered into their
    expert slots; the backward gathers the slots' cotangents back by the
    inverse permutation (the dropped k-slots get 0)."""

    @staticmethod
    def forward(ctx, xk, tok_idx, slot_valid, lin, keep):
        ctx.save_for_backward(lin, keep)
        ctx.shape = tok_idx.shape + xk.shape[-1:]
        buf = xk[tok_idx.reshape(-1)].reshape(ctx.shape)
        return buf * slot_valid[..., None].to(buf.dtype)

    @staticmethod
    def backward(ctx, ct):
        lin, keep = ctx.saved_tensors
        e, cap, d = ctx.shape
        ct_xk = ct.reshape(e * cap, d)[lin]
        return ct_xk * keep[:, None].to(ct_xk.dtype), None, None, None, None


class _CombineGather(torch.autograd.Function):
    """(E, cap, D) -> (T k, D): each k-slot's expert output gathered back
    and weighted by its router probability. The backward: the out-buffer's
    cotangent a gather of the weighted cotangents by ``tok_idx``, and the
    weight's an f32 dot of the gathered row with the cotangent."""

    @staticmethod
    def forward(ctx, out_buf, wflat, tok_idx, slot_valid, lin, keep):
        ctx.save_for_backward(out_buf, wflat, tok_idx, slot_valid, lin,
                              keep)
        e, cap, d = out_buf.shape
        g = out_buf.reshape(e * cap, d)[lin]
        g = g * keep[:, None].to(g.dtype)
        return g * wflat[:, None].to(g.dtype)

    @staticmethod
    def backward(ctx, ct):
        out_buf, wflat, tok_idx, slot_valid, lin, keep = ctx.saved_tensors
        e, cap, d = out_buf.shape
        ctw = ct * wflat[:, None].to(ct.dtype)
        ct_buf = ctw[tok_idx.reshape(-1)].reshape(e, cap, d) \
            * slot_valid[..., None].to(ct.dtype)
        g = out_buf.reshape(e * cap, d)[lin]
        g = g * keep[:, None].to(g.dtype)
        ct_w = torch.sum(g.float() * ct.float(), dim=-1)
        return ct_buf, ct_w.to(wflat.dtype), None, None, None, None


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, D) -> (B, S, D), and the aux metrics
    {load_balance_loss (Switch-style, over each token's first choice),
    drop_fraction (of the T k slots)}."""
    moe = cfg.moe
    b, s, d = x.shape
    e = p["router"].shape[-1]
    k = moe.top_k
    t = b * s
    xf = x.reshape(t, d)

    logits = xf.float() @ p["router"]                      # (T, E)
    if e > moe.num_experts:                                # mask the pads
        pad = torch.arange(e, device=x.device) >= moe.num_experts
        logits = torch.where(pad, torch.full_like(logits, -1e9), logits)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)                        # (T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    top_w = top_w.to(x.dtype)

    cap = max(int(math.ceil(t * k / moe.num_experts * moe.capacity_factor)),
              4)
    plan = _routing_plan(top_e, e, cap)
    xk = torch.repeat_interleave(xf, k, dim=0)             # (T k, D)
    buf = _DispatchGather.apply(xk, plan["tok_idx"], plan["slot_valid"],
                                plan["lin"], plan["keep"])  # (E, cap, D)

    wi, wg, wo = (p["wi"].to(x.dtype), p["wg"].to(x.dtype),
                  p["wo"].to(x.dtype))
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)    # (E, cap, F)
    out_buf = torch.bmm(h, wo)                             # (E, cap, D)

    yk = _CombineGather.apply(out_buf, top_w.reshape(-1), plan["tok_idx"],
                              plan["slot_valid"], plan["lin"], plan["keep"])
    y = yk.reshape(t, k, d).sum(dim=1).reshape(b, s, d)

    me = torch.mean(probs, dim=0)                          # (E,)
    ce = torch.mean(F.one_hot(top_e[:, 0], e).float(), dim=0)
    aux = {"load_balance_loss": e * torch.sum(me * ce),
           "drop_fraction": 1.0 - torch.mean(plan["keep"].float())}
    return y, aux
