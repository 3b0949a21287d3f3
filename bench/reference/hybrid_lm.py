"""Plain f32 reference of a hybrid Mamba2 / attention language model as
the configuration file describes it (``model``): embedding, repeats of
the block pattern, final RMSNorm, head.

- ``mamba``: RMSNorm; in-projection to z, (x, B, C) and dt; a depthwise
  causal convolution of width W over (x, B, C) with SiLU;
  dt = max(softplus(dt + dt_bias), dt_min); the SSD recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t + D x_t with
  A = -exp(A_log), one B/C group; y SiLU(z), RMSNorm, out-projection.
- ``attn``: RMSNorm; causal softmax attention with RoPE on the two
  halves of each head; residual; RMSNorm; SwiGLU MLP; residual.

Written from these equations (the Mamba2 paper's chunked SSD form,
arXiv:2405.21060), not from the program. Matrices are ``(d_in, d_out)``.
``precision="fp8"`` computes in float8 e4m3 where the configuration
states bf16 (``Numerics``): the control that a lower precision than the
configuration's must fail."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Spec = Tuple[Tuple, Tuple[int, ...], str, tuple]


# ----------------------------------------------------------------- layout

def _dims(m):
    s = m["ssm"]
    d_inner = s["expand"] * m["d_model"]
    nh = d_inner // s["head_dim"]
    return d_inner, nh, s["head_dim"], s["state_dim"]


def _block_spec(kind: str, m, rep: int):
    d, dt = m["d_model"], m["param_dtype"]
    # the projections back into the residual stream are scaled down by
    # sqrt(2 n_layers), as GPT-2 initialises them: without it the random
    # 54-layer model is chaotic (a bf16 rounding moves its logits by half
    # their norm) and no comparison could tell a precision from another
    res = 1 / math.sqrt(2 * m["n_layers"])
    ln = {"scale": ((rep, d), dt, ("ones",))}
    if kind == "mamba":
        di, nh, _, n = _dims(m)
        w = m["ssm"]["conv_width"]
        return {"ln1": ln, "mamba": {
            "in_proj": ((rep, d, 2 * di + 2 * n + nh), dt,
                        ("normal", 1 / math.sqrt(d))),
            "conv_w": ((rep, w, di + 2 * n), dt,
                       ("normal", 1 / math.sqrt(w))),
            "conv_b": ((rep, di + 2 * n), dt, ("zeros",)),
            "A_log": ((rep, nh), "float32", ("a_log",)),
            "D": ((rep, nh), "float32", ("ones",)),
            "dt_bias": ((rep, nh), "float32", ("zeros",)),
            "norm_scale": ((rep, di), dt, ("ones",)),
            "out_proj": ((rep, di, d), dt,
                         ("normal", res / math.sqrt(di))),
        }}
    h, hkv, hd, ff = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    return {"ln1": ln, "ln2": dict(ln), "attn": {
        "wq": ((rep, d, h * hd), dt, ("normal", 1 / math.sqrt(d))),
        "wk": ((rep, d, hkv * hd), dt, ("normal", 1 / math.sqrt(d))),
        "wv": ((rep, d, hkv * hd), dt, ("normal", 1 / math.sqrt(d))),
        "wo": ((rep, h * hd, d), dt, ("normal", res / math.sqrt(h * hd))),
    }, "mlp": {
        "wi": ((rep, d, ff), dt, ("normal", 1 / math.sqrt(d))),
        "wg": ((rep, d, ff), dt, ("normal", 1 / math.sqrt(d))),
        "wo": ((rep, ff, d), dt, ("normal", res / math.sqrt(ff))),
    }}


def _sort_key(k):
    return (0, int(k), "") if isinstance(k, int) else (1, 0, k)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=_sort_key):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield (path,) + tuple(tree)


def param_specs(m) -> List[Spec]:
    """(path, shape, dtype name, init) of every leaf, in the pytree order
    (dict keys sorted, the pattern's blocks in order) in which the PFELS
    step draws one mask key and one noise key a leaf. Blocks are stacked:
    a leading repeat dim on every leaf."""
    rep = m["n_layers"] // len(m["block_pattern"])
    d, v = m["d_model"], m["vocab_size"]
    tree = {
        "blocks": {i: _block_spec(kind, m, rep)
                   for i, kind in enumerate(m["block_pattern"])},
        "embed": {"table": ((v, d), m["param_dtype"], ("normal", 1.0))},
        "final_norm": {"scale": ((d,), m["param_dtype"], ("ones",))},
        "lm_head": {"w": ((d, v), m["param_dtype"],
                          ("normal", 1 / math.sqrt(d)))},
    }
    return list(_flatten(tree))


def param_count(m) -> int:
    return sum(math.prod(s[1]) for s in param_specs(m))


# ------------------------------------------------------------------ model

def _fp8(t):
    """t rounded to float8 e4m3 under a per-tensor scale, in f32."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _RoundFp8(torch.autograd.Function):
    """fp8 rounding of a tensor forward and of its cotangent backward."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Numerics:
    """The working precision: f32, or fp8 in the places where the
    configuration's dtype holds a tensor: every weight and activation
    (projection operands and outputs, norm outputs, the residual stream)
    and their cotangents rounded to float8 e4m3 with a per-tensor scale,
    products accumulated in f32."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def q(self, t):
        return _RoundFp8.apply(t) if self.fp8 else t

    def mm(self, x, w):
        return self.q(self.q(x) @ self.q(w))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """x (b, s, h, dh) at positions 0..s-1."""
    s, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                         device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def ssd(x, dt, A, B, C, chunk):
    """The SSD recurrence in chunks. x (b, s, h, p), dt (b, s, h), A (h,),
    B, C (b, s, n); returns y (b, s, h, p) and the final state
    (b, h, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    x = x.reshape(b, nc, chunk, h, p)
    dt = dt.reshape(b, nc, chunk, h)
    B = B.reshape(b, nc, chunk, n)
    C = C.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dt * A, dim=2)                       # (b,c,l,h)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,c,i,j,h)
    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(keep, diff, torch.full_like(diff,
                                                              -math.inf)))
    xdt = x * dt[..., None]
    cb = torch.einsum("bcin,bcjn->bcij", C, B)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)             # (b,c,l,h)
    chunk_states = torch.einsum("bcjn,bcjhp->bchpn", B,
                                xdt * to_end[..., None])
    whole = torch.exp(cum[:, :, -1, :])                     # (b,c,h)
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * whole[:, c, :, None, None] + chunk_states[:, c]
    before = torch.stack(before, dim=1)                     # (b,c,h,p,n)
    y = y + torch.einsum("bcin,bcih,bchpn->bcihp", C, torch.exp(cum),
                         before)
    return y.reshape(b, s, h, p), state


def mamba_block(p, m, x, num: Numerics):
    """Returns (x + block(x), (final SSD state, last W - 1 conv inputs))."""
    di, nh, hp, n = _dims(m)
    w = m["ssm"]["conv_width"]
    h = num.q(rmsnorm(x, p["ln1"]["scale"], m["norm_eps"]))
    q = p["mamba"]
    proj = num.mm(h, q["in_proj"])
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    b, s, _ = xbc.shape
    xp = torch.cat([xbc.new_zeros(b, w - 1, xbc.shape[-1]), xbc], dim=1)
    conv = sum(xp[:, i:i + s] * q["conv_w"][i] for i in range(w))
    conv = F.silu(conv + q["conv_b"])
    xs, Bm, Cm = torch.split(conv, [di, n, n], dim=-1)
    dt = torch.clamp_min(F.softplus(dt + q["dt_bias"]), m["ssm"]["dt_min"])
    A = -torch.exp(q["A_log"])
    xh = xs.reshape(b, s, nh, hp)
    chunk = min(m["ssm"]["chunk_size"], s)
    while s % chunk:
        chunk //= 2
    y, state = ssd(xh, dt, A, Bm, Cm, chunk)
    y = (y + q["D"][:, None] * xh).reshape(b, s, di) * F.silu(z)
    y = num.q(rmsnorm(num.q(y), q["norm_scale"], m["norm_eps"]))
    return num.q(x + num.mm(y, q["out_proj"])), (state, xp[:, -(w - 1):])


def _attend(q, k, v, start):
    """Causal softmax attention of the queries at positions start.. over
    every key."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    pos_q = torch.arange(start, start + q.shape[1], device=q.device)
    pos_k = torch.arange(k.shape[1], device=q.device)
    scores = scores.masked_fill(pos_k[None, :] > pos_q[:, None], -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def attn_block(p, m, x, num: Numerics):
    """Returns (x + block(x), (k after RoPE, v))."""
    b, s, _ = x.shape
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    a = p["attn"]
    y = num.q(rmsnorm(x, p["ln1"]["scale"], m["norm_eps"]))
    q = rope(num.mm(y, a["wq"]).reshape(b, s, h, hd), m["rope_theta"])
    k = rope(num.mm(y, a["wk"]).reshape(b, s, hkv, hd), m["rope_theta"])
    v = num.mm(y, a["wv"]).reshape(b, s, hkv, hd)
    g = h // hkv
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    o = torch.cat([_attend(q[:, i:i + 512], kk, vv, i)
                   for i in range(0, s, 512)], dim=1)
    x = num.q(x + num.mm(o.reshape(b, s, h * hd), a["wo"]))
    y = num.q(rmsnorm(x, p["ln2"]["scale"], m["norm_eps"]))
    ml = p["mlp"]
    y = num.q(F.silu(num.mm(y, ml["wg"])) * num.mm(y, ml["wi"]))
    return num.q(x + num.mm(y, ml["wo"])), (k, v)


def _layer(tree, r):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def nest(flat: Dict[Tuple, torch.Tensor]):
    """{path: tensor} -> the nested tree of dicts."""
    out: Dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _blocks(params, m, x, num, keep_caches: bool, remat: bool):
    rep = m["n_layers"] // len(m["block_pattern"])
    caches = []
    for r in range(rep):
        for i, kind in enumerate(m["block_pattern"]):
            p = _layer(params["blocks"][i], r)
            fn = mamba_block if kind == "mamba" else attn_block
            if remat:
                x, c = checkpoint(fn, p, m, x, num, use_reentrant=False)
            else:
                x, c = fn(p, m, x, num)
            caches.append((kind, c) if keep_caches else None)
    return x, caches


def loss(params, m, tokens, labels, precision: str = "f32"):
    """Mean next-token cross-entropy; every layer recomputed in the
    backward (checkpointed)."""
    num = Numerics(precision)
    x = num.q(params["embed"]["table"][tokens])
    x, _ = _blocks(params, m, x, num, False, True)
    x = num.q(rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"]))
    logits = num.mm(x, params["lm_head"]["w"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


@torch.no_grad()
def prefill(params, m, tokens, precision: str = "f32"):
    """The last position's logits (b, V) and every layer's cache:
    [(kind, (ssm state, conv inputs)) or (kind, (k, v))] in layer
    order."""
    num = Numerics(precision)
    x = num.q(params["embed"]["table"][tokens])
    x, caches = _blocks(params, m, x, num, True, False)
    x = num.q(rmsnorm(x[:, -1], params["final_norm"]["scale"],
                      m["norm_eps"]))
    return num.mm(x, params["lm_head"]["w"]), caches
