"""Driver of the PFELS production step (``launch/steps.py``
``make_pfels_train_step``): PFELS as the optimizer of one language model
that is one client. Set-up makes the weights and the step, and runs the
first ``setup_steps`` steps through the window's own call and feed (each
a fresh batch and key); the reference follows those steps. The window
steps on, a fresh batch and key each step, params carried forward."""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch

from bench import inputs
from bench.drivers import lm_common
from bench.reference import hybrid_lm, pfels_step
from bench.yardstick import compare

# the control: the reference in the precision below the configuration's
CONTROL = "fp8"

SPANS = [
    ("repro_torch.launch.steps", "value_and_grad", "forward_backward"),
    ("repro_torch.launch.steps", "clip_tree_flat", "clip"),
    ("repro_torch.launch.steps", "_round_channel", "channel"),
    ("repro_torch.core.randk", "mask_tree", "masks"),
    ("repro_torch.core.aggregation", "pfels_production_aggregate",
     "aggregate"),
]


def _pfels(pf, d: int):
    from repro_torch.configs.base import ChannelConfig, PFELSConfig
    ch = pf["channel"]
    return PFELSConfig(
        num_clients=pf["num_clients"],
        clients_per_round=pf["clients_per_round"],
        compression_ratio=pf["compression_ratio"], epsilon=pf["epsilon"],
        delta=pf["delta"], local_lr=pf["local_lr"],
        local_steps=pf["local_steps"], clip=pf["clip"],
        unbiased_rescale=pf["unbiased_rescale"],
        channel=ChannelConfig(gain_mean=ch["gain_mean"],
                              gain_clip=tuple(ch["gain_clip"]),
                              noise_std=ch["noise_std"],
                              snr_db_range=tuple(ch["snr_db_range"])))


def _batch(ctx, i):
    m, t = ctx.config["model"], ctx.traffic
    tok = inputs.token_batch(ctx.seed, i, t["batch"], t["seq"] + 1,
                             m["vocab_size"], ctx.device)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _key(ctx, i):
    return torch.tensor(inputs.key_words(ctx.seed, i), dtype=torch.int64,
                        device=ctx.device)


def setup(ctx):
    from repro_torch.launch.steps import make_pfels_train_step
    from repro_torch.tree import tree_leaves
    m = ctx.config["model"]
    specs = hybrid_lm.param_specs(m)
    cfg = lm_common.model_config(m, ctx.config["name"])
    lm_common.check_layout(cfg, specs)
    d = hybrid_lm.param_count(m)
    params = lm_common.program_tree(
        inputs.make_weights(specs, ctx.seed, ctx.device))
    step = make_pfels_train_step(cfg, _pfels(ctx.config["pfels"], d), d)
    st = SimpleNamespace(step=step, ctx=ctx, losses=[], setup_metrics=[])
    for i in range(ctx.traffic["setup_steps"]):
        params, mt = step(params, _batch(ctx, i), _key(ctx, i))
        st.setup_metrics.append({k: float(v) for k, v in mt.items()})
    ctx.sync()
    t0 = time.perf_counter()
    # the params the reference's steps are compared with, off the card
    st.snapshot = [x.to("cpu") for x in tree_leaves(params)]
    ctx.check_s += time.perf_counter() - t0
    st.params = params
    return st


def unit(st, i):
    j = st.ctx.traffic["setup_steps"] + i
    st.params, mt = st.step(st.params, _batch(st.ctx, j), _key(st.ctx, j))
    st.losses.append(mt["loss"])


def failed(st) -> int:
    return sum(1 for x in st.losses if not math.isfinite(float(x)))


def finish(st, ctx):
    kept = {"setup_metrics": st.setup_metrics, "snapshot": st.snapshot}
    st.params = st.step = None
    return kept


def end_to_end(ctx, units, window_s):
    return {"step_s": window_s / units}


def work(ctx):
    m, t = ctx.config["model"], ctx.traffic
    d = hybrid_lm.param_count(m)
    return {"params": d, "tokens": t["batch"] * t["seq"],
            "clip_elems": -(-d // 128) * 128,
            "clip_calls": ctx.config["pfels"]["local_steps"]}


def reference(ctx, n_steps, precision="f32", half_batch=False):
    """The reference's first ``n_steps`` steps: (theta, steps, each leaf's
    gradient norm at step 1)."""
    with compare.exact_f32():
        return pfels_step.run(ctx.config["model"], ctx.config["pfels"],
                              ctx.seed, ctx.traffic, n_steps, ctx.device,
                              precision=precision, half_batch=half_batch)


def numbers(ctx, steps, theta, ref):
    """The numbers compared: ``steps`` (a metrics dict a step) and the
    params ``theta`` after them (leaves in pytree order, or {path:
    tensor}), against the reference's ``ref``."""
    ref_theta, ref_steps, leaf_gn = ref
    theta0 = inputs.make_weights(hybrid_lm.param_specs(ctx.config["model"]),
                                 ctx.seed, ctx.device)
    return compare.step_gaps(steps, ref_steps) + [
        ("change_gap", compare.change_gap(theta0, theta, ref_theta,
                                          leaf_gn))]


def check(ctx, kept):
    ref = reference(ctx, len(kept["setup_metrics"]))
    return numbers(ctx, kept["setup_metrics"], kept["snapshot"], ref)


def calibrate(ctx, kinds):
    """Readings for setting the limits, on this seed: the program's
    set-up steps against the reference, and each of ``kinds`` in the
    program's place: ``fp8`` (the reference with its projections in
    fp8, the control) and ``half_batch`` (the reference trained on half
    of each batch, a fault)."""
    n = ctx.traffic["setup_steps"]
    st = setup(ctx)
    kept = finish(st, ctx)
    del st
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ctx, n)
    out = {"program": numbers(ctx, kept["setup_metrics"], kept["snapshot"],
                              ref)}
    for name in ("loss", "grad_norm"):
        for i, gap in enumerate(compare.per_step(kept["setup_metrics"],
                                                 ref[1], name)):
            out["program"].append((f"{name}_gap.step{i + 1}", gap))
    del kept
    for kind in kinds:
        if kind not in ("fp8", "half_batch"):
            raise ValueError(f"unknown control or fault {kind!r}")
        theta, steps, _ = reference(
            ctx, n, precision="fp8" if kind == "fp8" else "f32",
            half_batch=kind == "half_batch")
        out[kind] = numbers(ctx, steps, theta, ref)
        del theta
    return out
