"""Driver of offline batch prompt processing: ``models/transformer.py``
``prefill`` on a fresh batch of prompts each call (the last position's
logits and the caches a decode would read). Set-up makes the weights and
runs one prefill at the window's shape. The window keeps every batch's
last logits, and the caches of its last batch; the check compares a
sample of rows, drawn from the seed, with the plain reference."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from bench import inputs
from bench.drivers import lm_common
from bench.reference import hybrid_lm
from bench.yardstick import compare

# the control: the reference in the precision below the configuration's
CONTROL = "fp8"
CALIBRATE_BATCHES = 2

SPANS = [
    ("repro_torch.models.transformer", "make_caches", "caches"),
    ("repro_torch.models.mamba2", "mamba_train", "mamba"),
    ("repro_torch.models.attention", "attn_train", "attention"),
    ("repro_torch.models.layers", "mlp_apply", "mlp"),
    ("repro_torch.models.transformer", "_head", "head"),
]


def _tokens(ctx, i):
    m, t = ctx.config["model"], ctx.traffic
    return inputs.token_batch(ctx.seed, i, t["batch"], t["prompt"],
                              m["vocab_size"], ctx.device)


def setup(ctx):
    from repro_torch.models import transformer as T
    m = ctx.config["model"]
    specs = hybrid_lm.param_specs(m)
    cfg = lm_common.model_config(m, ctx.config["name"])
    lm_common.check_layout(cfg, specs)
    params = lm_common.program_tree(
        inputs.make_weights(specs, ctx.seed, ctx.device))
    st = SimpleNamespace(T=T, cfg=cfg, params=params, ctx=ctx, logits=[],
                         caches=None)
    with torch.no_grad():
        T.prefill(params, cfg, {"tokens": _tokens(ctx, 0)})
    return st


def unit(st, i):
    st.caches = None
    with torch.no_grad():
        logits, st.caches, _ = st.T.prefill(
            st.params, st.cfg, {"tokens": _tokens(st.ctx, i + 1)})
    st.logits.append(logits[:, -1])


def failed(st) -> int:
    return sum(int((~torch.isfinite(x.float())).any(dim=-1).sum())
               for x in st.logits)


def finish(st, ctx):
    """The window's last logits, and the sampled rows of its last batch's
    caches, in the reference's layer order."""
    rows = _cache_rows(ctx, len(st.logits))
    m = ctx.config["model"]
    caches = []
    for r in range(m["n_layers"] // len(m["block_pattern"])):
        for i, kind in enumerate(m["block_pattern"]):
            c = st.caches[i]
            if kind == "mamba":
                caches.append((c["ssm"][r][rows].clone(),
                               c["conv"][r][rows].clone()))
            else:
                caches.append((c["k"][r][rows].clone(),
                               c["v"][r][rows].clone()))
    kept = {"logits": st.logits, "caches": caches}
    st.params = st.caches = None
    return kept


def _sample(ctx, n_batches):
    """(batch, row) pairs whose logits are compared: ``check_rows`` drawn
    from the seed over the window's batches, and the cache rows of the
    last batch."""
    t = ctx.traffic
    gen = inputs.generator(ctx.seed, 9, 0, "cpu")
    total = n_batches * t["batch"]
    picks = torch.randperm(total, generator=gen)[:t["check_rows"]].tolist()
    pairs = sorted({(p // t["batch"], p % t["batch"]) for p in picks})
    last = n_batches - 1
    return sorted(set(pairs) | {(last, r) for r in _cache_rows(ctx,
                                                              n_batches)})


def _cache_rows(ctx, n_batches):
    gen = inputs.generator(ctx.seed, 9, 1, "cpu")
    return sorted(torch.randperm(ctx.traffic["batch"], generator=gen)
                  [:ctx.traffic["cache_rows"]].tolist())


def reference_rows(ctx, pairs, cache_pairs, precision="f32"):
    """The reference's last logits for each (batch, row) of ``pairs``,
    and its caches for those of ``cache_pairs``, one row at a time."""
    m = ctx.config["model"]
    theta = hybrid_lm.nest({p: t.float() for p, t in inputs.make_weights(
        hybrid_lm.param_specs(m), ctx.seed, ctx.device).items()})
    logits, caches = {}, {}
    with compare.exact_f32():
        for b, r in pairs:
            tok = _tokens(ctx, b + 1)[r:r + 1]
            out, cs = hybrid_lm.prefill(theta, m, tok, precision)
            logits[(b, r)] = out[0]
            if (b, r) in cache_pairs:
                caches[(b, r)] = [(kind, tuple(x[0] for x in c))
                                  for kind, c in cs]
            del cs
    return logits, caches


def numbers(ctx, logits, caches, ref):
    """The numbers compared: ``logits`` {(batch, row): (V,)} and the last
    batch's cache rows ``caches`` {(batch, row): [per layer (a, b)]}
    against the reference's."""
    ref_logits, ref_caches = ref
    gap, err = 0.0, 0.0
    for pr, want in ref_logits.items():
        got = logits[pr].float()
        gap = max(gap, float(want.max() - want[int(torch.argmax(got))]))
        err = max(err, compare.rel_norm(got, want))
    cerr = 0.0
    for pr, layers in caches.items():
        for (kind, want), got in zip(ref_caches[pr], layers):
            for a, b in zip(got, want):
                cerr = max(cerr, compare.rel_norm(a.float(), b))
    return [("logit_gap", gap), ("logits_err", err), ("cache_err", cerr)]


def _program_outputs(ctx, kept):
    n = len(kept["logits"])
    pairs = _sample(ctx, n)
    rows = _cache_rows(ctx, n)
    logits = {(b, r): kept["logits"][b][r] for b, r in pairs}
    caches = {(n - 1, r): [tuple(x[k] for x in layer)
                           for layer in kept["caches"]]
              for k, r in enumerate(rows)}
    return pairs, logits, caches


def check(ctx, kept):
    pairs, logits, caches = _program_outputs(ctx, kept)
    return numbers(ctx, logits, caches,
                   reference_rows(ctx, pairs, set(caches)))


def calibrate(ctx, kinds):
    """The program's readings on this seed, a short window of
    ``CALIBRATE_BATCHES`` batches, and the fp8 control's: the token the
    control puts first read against the f32 reference."""
    st = setup(ctx)
    for i in range(CALIBRATE_BATCHES):
        unit(st, i)
    kept = finish(st, ctx)
    del st
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    pairs, logits, caches = _program_outputs(ctx, kept)
    ref = reference_rows(ctx, pairs, set(caches))
    out = {"program": numbers(ctx, logits, caches, ref)}
    for kind in kinds:
        if kind != "fp8":
            raise ValueError(f"unknown control {kind!r}")
        c_logits, c_caches = reference_rows(ctx, pairs, set(caches), "fp8")
        c_caches = {pr: [c for _, c in v] for pr, v in c_caches.items()}
        out[kind] = numbers(ctx, c_logits, c_caches, ref)
    return out


def end_to_end(ctx, units, window_s):
    t = ctx.traffic
    return {"prefill_tok_s": units * t["batch"] * t["prompt"] / window_s}


def work(ctx):
    m, t = ctx.config["model"], ctx.traffic
    di = m["ssm"]["expand"] * m["d_model"]
    pattern = m["block_pattern"]
    rep = m["n_layers"] // len(pattern)
    elem = 2 if m["dtype"] == "bfloat16" else 4
    return {"params": hybrid_lm.param_count(m),
            "tokens": t["batch"] * t["prompt"], "batch": t["batch"],
            "seq": t["prompt"], "elem": elem,
            "mamba_calls": rep * pattern.count("mamba"),
            "attn_calls": rep * pattern.count("attn"),
            "ssm_heads": di // m["ssm"]["head_dim"],
            "ssm_head_dim": m["ssm"]["head_dim"],
            "ssm_state": m["ssm"]["state_dim"],
            "ssm_chunk": min(m["ssm"]["chunk_size"], t["prompt"]),
            "heads": m["n_heads"], "kv_heads": m["n_kv_heads"],
            "head_dim": m["head_dim"]}
