"""Driver of the paper's federated simulation: ``fl/api.py``
``Trainer.step``, one PFELS round after another from a state made in
set-up, on a population made from the seed. Set-up makes the weights,
the data, the trainer and its state, and runs the first
``setup_rounds`` rounds through the window's own call; the reference
follows those rounds."""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch

from bench import inputs
from bench.reference import fl_round
from bench.yardstick import compare, work as ywork

# the control: the reference in the precision below the configuration's
CONTROL = "tf32"

SPANS = [
    ("repro_torch.fl.rounds", "sample_cohort", "cohort"),
    ("repro_torch.fl.rounds", "local_train", "local_train"),
    ("repro_torch.core.channel", "sample_gains", "gains"),
    ("repro_torch.core.randk", "sample_indices", "support"),
    ("repro_torch.fl.rounds", "row_norms", "row_norms"),
    ("repro_torch.core.aggregation", "aircomp_aggregate_fused", "transmit"),
]


def _pfels(pf):
    from repro_torch.configs.base import ChannelConfig, PFELSConfig
    ch = pf["channel"]
    return PFELSConfig(
        num_clients=pf["num_clients"],
        clients_per_round=pf["clients_per_round"],
        local_steps=pf["local_steps"], local_lr=pf["local_lr"],
        momentum=pf["momentum"], clip=pf["clip"],
        compression_ratio=pf["compression_ratio"], epsilon=pf["epsilon"],
        delta=pf["delta"], transmit_clip=pf["transmit_clip"],
        use_fused_kernel=pf["use_fused_kernel"],
        bank_backend=pf["bank_backend"],
        channel=ChannelConfig(gain_mean=ch["gain_mean"],
                              gain_clip=tuple(ch["gain_clip"]),
                              noise_std=ch["noise_std"],
                              snr_db_range=tuple(ch["snr_db_range"])))


def _data(ctx):
    m, t, pf = ctx.config["model"], ctx.traffic, ctx.config["pfels"]
    size = m["image_size"]
    return inputs.classification_data(
        ctx.seed, pf["num_clients"], t["samples_per_client"],
        m["num_classes"], (m["in_channels"], size, size),
        t["dirichlet_alpha"], t["image_noise"], ctx.device)


def _key0(ctx):
    return torch.tensor(inputs.key_words(ctx.seed, 0), dtype=torch.int64,
                        device=ctx.device)


def _weights(ctx):
    return inputs.make_weights(fl_round.param_specs(ctx.config["model"]),
                               ctx.seed, ctx.device)


def setup(ctx):
    import inspect

    from repro_torch.configs.base import CNNConfig
    from repro_torch.fl import Trainer, client
    from repro_torch.models import cnn
    m = ctx.config["model"]
    batch = inspect.signature(client.local_train).parameters["batch_size"]
    if batch.default != ctx.config["pfels"]["batch_size"]:
        raise ValueError(f"the port's local training draws minibatches of "
                         f"{batch.default}, the configuration states "
                         f"{ctx.config['pfels']['batch_size']}")
    cfg_m = CNNConfig(name=ctx.config["name"], arch=m["arch"],
                      in_channels=m["in_channels"],
                      image_size=m["image_size"],
                      num_classes=m["num_classes"],
                      width_mult=m["width_mult"])
    params = {n: t.clone() for n, t in _weights(ctx).items()}
    x, y = _data(ctx)
    # the set-up rounds' minibatch losses, as the program's local training
    # computes them: the first of each client is the forward of the
    # round's params alone, untouched by the later steps' amplification
    recorder = {"out": None}

    def loss_fn(p, b):
        loss, aux = cnn.cnn_loss(p, cfg_m, b)
        if recorder["out"] is not None:
            recorder["out"].append(loss.detach())
        return loss, aux

    trainer = Trainer(_pfels(ctx.config["pfels"]), loss_fn, params,
                      device=ctx.device)
    if list(trainer.unravel.names) != list(params):
        raise ValueError("the port's flat order differs from the "
                         "reference's")
    state = trainer.init(_key0(ctx))
    st = SimpleNamespace(trainer=trainer, state=state, x=x, y=y, ctx=ctx,
                         losses=[], setup_metrics=[], step_losses=[])
    recorder["out"] = st.step_losses
    for _ in range(ctx.traffic["setup_rounds"]):
        st.state, mt = trainer.step(st.state, x, y)
        st.setup_metrics.append({k: float(mt[k]) for k in
                                 ("train_loss", "update_norm", "beta",
                                  "energy")})
    recorder["out"] = None
    ctx.sync()
    t0 = time.perf_counter()
    st.snapshot = {n: t.to("cpu") for n, t in st.state.params.items()}
    ctx.check_s += time.perf_counter() - t0
    return st


def unit(st, i):
    st.state, mt = st.trainer.step(st.state, st.x, st.y)
    st.losses.append(mt["train_loss"])


def failed(st) -> int:
    return sum(1 for v in st.losses if not math.isfinite(float(v)))


def finish(st, ctx):
    kept = {"setup_metrics": st.setup_metrics, "snapshot": st.snapshot,
            "step_losses": [float(v) for v in st.step_losses]}
    st.trainer = st.state = st.x = st.y = None
    return kept


def reference(ctx, n_rounds, numerics="f32", half_batch=False):
    """The reference's first ``n_rounds`` rounds: (theta, per-round
    metrics, each leaf's gradient norm in the first client's first
    step)."""
    x, y = _data(ctx)
    theta0 = _weights(ctx)
    with compare.exact_f32():
        theta, recs = fl_round.run(
            dict(theta0), ctx.config["model"], ctx.config["pfels"], x, y,
            inputs.key_words(ctx.seed, 0), n_rounds, numerics, half_batch)
        leaf_gn = fl_round.leaf_grad_norms(theta0, ctx.config["model"],
                                           x[0], y[0])
    return theta, recs, leaf_gn


NAMES = ("train_loss", "update_norm", "beta", "energy")


def numbers(ctx, rounds, theta, ref, step_losses):
    """The numbers compared: the per-round metrics ``rounds``, the params
    ``theta`` after them, and every minibatch loss of the local training
    in order, against the reference's."""
    ref_theta, ref_rounds, leaf_gn = ref
    pf = ctx.config["pfels"]
    tau = pf["local_steps"]
    want = [rec["step_losses"] for rec in ref_rounds]
    want = [v for w in want for v in w]
    first = [compare.rel(a, b) for a, b in
             zip(step_losses[:pf["clients_per_round"] * tau:tau],
                 want[:pf["clients_per_round"] * tau:tau])]
    out = [("first_loss_gap",
            max(first) if len(step_losses) == len(want) else math.inf)]
    for name, label in zip(NAMES, ("loss_gap", "update_norm_gap",
                                   "beta_gap", "energy_gap")):
        gaps = [compare.rel(float(a[name]), b[name])
                for a, b in zip(rounds, ref_rounds)]
        out.append((label, max(gaps) if len(rounds) == len(ref_rounds)
                    else math.inf))
    out.append(("change_gap", compare.change_gap(
        _weights(ctx), theta, ref_theta, leaf_gn)))
    return out


def check(ctx, kept):
    ref = reference(ctx, len(kept["setup_metrics"]))
    return numbers(ctx, kept["setup_metrics"], kept["snapshot"], ref,
                   kept["step_losses"])


def calibrate(ctx, kinds):
    """The program's readings on this seed, and each of ``kinds`` in its
    place: ``tf32`` (the reference with its convolutions and products in
    TF32, the control) and ``half_batch`` (each minibatch halved)."""
    n = ctx.traffic["setup_rounds"]
    st = setup(ctx)
    kept = finish(st, ctx)
    del st
    ref = reference(ctx, n)
    out = {"program": numbers(ctx, kept["setup_metrics"], kept["snapshot"],
                              ref, kept["step_losses"])}
    for kind in kinds:
        if kind not in ("tf32", "half_batch"):
            raise ValueError(f"unknown control or fault {kind!r}")
        theta, recs, _ = reference(
            ctx, n, "tf32" if kind == "tf32" else "f32",
            half_batch=kind == "half_batch")
        out[kind] = numbers(ctx, recs, theta, ref,
                            [v for r in recs for v in r["step_losses"]])
    return out


def end_to_end(ctx, units, window_s):
    return {"round_s": window_s / units}


def work(ctx):
    m, pf = ctx.config["model"], ctx.config["pfels"]
    size = m["image_size"]
    fwd = ywork.resnet18_forward_flops(size, size, m["in_channels"],
                                       fl_round.widths(m), m["num_classes"])
    d = sum(math.prod(s[1]) for s in fl_round.param_specs(m))
    return {"resnet_flops": 3.0 * fwd, "r": pf["clients_per_round"],
            "images": pf["clients_per_round"] * pf["local_steps"]
            * pf["batch_size"], "d": d}
