"""The port's production PFELS step (``repro_torch.launch.steps``) and what
it runs, against the JAX reference on the CPU: the cross-entropies and
the embedding's gradient against ``jax.grad``, the global-norm clip of a
tree through the flat ``clip_norm`` route, the mask-mode rand-k, the
production aggregate, whole steps of the reduced dense (phi3-mini-3.8b)
and hybrid (zamba2-2.7b) configs with their params carried across
(``repro_torch.convert``), tau > 1 and gradient accumulation on the
reduced mamba2-130m, one bf16 step, the synthetic LM data, the Gumbel
sampler, ``optim/`` and the schedules. The reference runs under
``jax.threefry_partitionable(False)``, the mode of the port's threefry.

Tolerances are stated at each check. The step's gaps come from f32 sums
in another order (XLA against ATen matmuls and reductions) and from the
``normal`` draws' few-ulp gap (``tests/test_torch_prng.py``); measured:
metrics at most 1.3e-6 relative, theta at most 3.1e-5 of the update's
scale (the ulp of an O(1) embedding entry).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")
import torch.distributed as dist

from repro.configs import PFELSConfig as JPFELS
from repro.configs import reduced_config as j_reduced
from repro.configs.base import ChannelConfig as JChannel
from repro.core import aggregation as jagg
from repro.core import clipping as jclip
from repro.core import randk as jrandk
from repro.core.channel import scaled_channel as j_scaled
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.launch.steps import make_pfels_train_step as j_make_step
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert, optim, prng
from repro_torch.configs import PFELSConfig, reduced_config
from repro_torch.configs.base import ChannelConfig
from repro_torch.core import aggregation, clipping, randk
from repro_torch.core.channel import scaled_channel
from repro_torch.data import make_lm_sequences
from repro_torch.kernels.clip_norm import kernel as clip_kernel
from repro_torch.launch import steps
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

GRAD_RTOL = 1e-6          # the losses and the embedding gradient, f32
METRIC_RTOL = 1e-5        # loss, grad_norm, beta, energy of a step
# theta: 1e-4 of the leaf's largest update, plus one f32 ulp of theta,
# the rounding of theta + update, which an update a few ulp off can move
THETA_OF_UPDATE = 1e-4


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread: these tests interleave torch
    and XLA work, and under parallel test workers torch's spinning pool
    threads made them 15x slower (measured with the CPU loaded)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------ the losses

def _ce_case(rng):
    logits = rng.standard_normal((2, 5, 300)).astype(np.float32) * 3
    labels = rng.integers(0, 280, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -100
    jf = lambda lg: JL.cross_entropy(lg, jnp.asarray(labels), 280)
    tf = lambda lg: TL.cross_entropy(lg, _t(labels).long(), 280)
    return (logits,), jf, tf


def _chunked_case(rng):
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 256)).astype(np.float32) * 0.5
    labels = rng.integers(0, 250, (2, 8)).astype(np.int32)
    labels[1, 2] = -1
    jf = lambda x, w: JL.chunked_cross_entropy(
        x, {"w": w}, jnp.asarray(labels), 250, tied=False, chunk=4)
    tf = lambda x, w: TL.chunked_cross_entropy(
        x, {"w": w}, _t(labels).long(), 250, tied=False, chunk=4)
    return (x, w), jf, tf


def _embed_case(rng):
    table = rng.standard_normal((50, 8)).astype(np.float32)
    tokens = rng.integers(0, 12, (3, 7)).astype(np.int32)  # repeats
    ct = rng.standard_normal((3, 7, 8)).astype(np.float32)
    jf = lambda tb: jnp.sum(JL.embed_apply({"table": tb},
                                           jnp.asarray(tokens)) * ct)
    tf = lambda tb: torch.sum(TL.embed_apply({"table": tb},
                                             _t(tokens)) * _t(ct))
    return (table,), jf, tf


@pytest.mark.parametrize("case", [_ce_case, _chunked_case, _embed_case],
                         ids=["cross_entropy", "chunked", "embedding"])
def test_losses_and_embedding_grad_match_jax_grad(case):
    args, jf, tf = case(np.random.default_rng(0))
    jval, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(args))))(
        *args)
    targs = [_t(a).requires_grad_(True) for a in args]
    tval = tf(*targs)
    tgrads = torch.autograd.grad(tval, targs)
    np.testing.assert_allclose(float(tval.detach()), float(jval),
                               rtol=GRAD_RTOL)
    for tg, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(jg).max())


def test_embedding_grad_sums_repeats_in_f32():
    """A bf16 table's gradient: the repeated tokens' cotangents are summed
    in f32 and rounded once, the reference's custom VJP bit for bit (a
    bf16 sum would round at every repeat)."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((16, 4)).astype(np.float32)
    tokens = np.zeros((1, 300), np.int32)          # one token, 300 times
    ct = (1 + rng.random((1, 300, 4))).astype(np.float32)
    jtab = jnp.asarray(table, jnp.bfloat16)
    jct = jnp.asarray(ct, jnp.bfloat16)
    _, vjp = jax.vjp(lambda tb: JL.embed_apply({"table": tb},
                                               jnp.asarray(tokens)), jtab)
    (jg,) = vjp(jct)
    ttab = _t(table, torch.bfloat16).requires_grad_(True)
    out = TL.embed_apply({"table": ttab}, _t(tokens))
    (tg,) = torch.autograd.grad(out, ttab, _t(ct, torch.bfloat16))
    np.testing.assert_array_equal(tg.view(torch.int16).numpy(),
                                  np.asarray(jg).view(np.int16))
    naive = torch.zeros(4, dtype=torch.bfloat16)      # summed in bf16
    for row in _t(ct, torch.bfloat16)[0]:
        naive = naive + row
    assert not torch.equal(tg[0], naive)


def test_forward_train_remat_and_unported_families():
    """``remat`` changes what the backward keeps, not the numbers: for the
    hybrid zamba2-2.7b, and for the MoE (its aux loss carried out of the
    checkpointed repeat), Whisper (the encoder's output used inside it)
    and VLM families, which the port now trains."""
    cfg = dataclasses.replace(reduced_config("zamba2-2.7b"),
                              dtype="float32", param_dtype="float32")
    params = TT.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    toks = prng.randint(prng.PRNGKey(1, "cpu"), (2, 17), 0, cfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    outs = [steps.make_train_loss_step(cfg, remat=r)(params, batch)
            for r in (True, False)]
    assert float(outs[0][0]) == float(outs[1][0])
    assert sorted(outs[0][1]) == ["aux_loss", "loss"]
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        assert torch.equal(a, b)
    for arch in ("granite-moe-3b-a800m", "whisper-tiny", "qwen2-vl-72b"):
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                                  param_dtype="float32")
        params = TT.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
        b = dict(batch)
        if cfg.family == "vlm":
            b["vision_embeds"] = prng.normal(
                prng.PRNGKey(2, "cpu"), (2, cfg.vision_prefix, cfg.d_model))
        if cfg.is_encoder_decoder:
            b["audio_embeds"] = prng.normal(
                prng.PRNGKey(3, "cpu"), (2, cfg.encoder_seq, cfg.d_model))
        outs = [steps.make_train_loss_step(cfg, remat=r)(params, b)
                for r in (True, False)]
        assert float(outs[0][0]) == float(outs[1][0]), arch
        assert float(outs[0][1]["aux_loss"]) == float(
            outs[1][1]["aux_loss"]), arch
        assert (float(outs[0][1]["aux_loss"]) > 0) == (cfg.moe is not None)
        for a, g in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
            assert torch.equal(a, g), arch


# ------------------------------------------- clip, masks and the aggregate

def _mixed_tree(rng):
    return {"a": rng.standard_normal((33, 70)).astype(np.float32) * 0.1,
            "b": (rng.standard_normal((5, 41)).astype(np.float32),
                  rng.standard_normal((1000,)).astype(np.float32) * 0.01),
            "c": {"w": rng.standard_normal((7, 9, 11)).astype(np.float32)}}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "mixed_bf16"])
def test_clip_tree_matches_reference(bf16):
    """The flat route of the clip (one ``clip_norm`` call over the tree's
    leaves in an f32 buffer; its plain version on the CPU) against the
    reference's ``clip_by_global_norm``: the norm within 1e-6, each leaf
    in its dtype within 1e-6 (f32) or one bf16 rounding (2^-8)."""
    tree = _mixed_tree(np.random.default_rng(2))
    jtree = jax.tree.map(jnp.asarray, tree)
    if bf16:   # zamba2's mix: bf16 matrices, f32 vectors
        jtree["a"] = jtree["a"].astype(jnp.bfloat16)
        jtree["c"]["w"] = jtree["c"]["w"].astype(jnp.bfloat16)
    ttree = jax.tree.map(lambda x: convert.tensor_from_numpy(
        np.asarray(x), "cpu"), jtree)
    ttree["b"] = tuple(ttree["b"])
    jout, jnrm = jclip.clip_by_global_norm(jtree, 1.0)
    clip_kernel.reset_launch_counts()
    flat, tnrm, layout = clipping.clip_tree_flat(ttree, 1.0)
    assert clip_kernel.LAUNCHES["clip_norm"] == 0   # the CPU route
    assert flat.numel() % 128 == 0 and not bool(flat[layout.d:].any())
    np.testing.assert_allclose(float(tnrm), float(jnrm), rtol=1e-6)
    tout = [v.to(dt) for v, dt in zip(layout.views(flat), layout.dtypes)]
    for view, t, j in zip(layout.views(flat), tout,
                          jax.tree.leaves(jout)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert torch.equal(view, t.float())   # each view already rounded
        tol = 2.0 ** -8 if j.dtype == jnp.bfloat16 else 1e-6
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=tol,
                                   atol=tol * float(np.abs(
                                       np.asarray(j, np.float32)).max()))


def test_masks_and_production_aggregate_match_reference(tmp_path):
    """The masks are bit-equal (they are the shared A^t), and so is the
    aggregate, with and without the unbiased rescale."""
    tree = _mixed_tree(np.random.default_rng(3))
    key = jax.random.PRNGKey(7)
    km, kn = jax.random.split(key)
    jmasks = jrandk.mask_tree(km, tree, 0.3)
    tkm, tkn = prng.split(prng.PRNGKey(7, "cpu"))
    ttree = {"a": _t(tree["a"]), "b": tuple(_t(x) for x in tree["b"]),
             "c": {"w": _t(tree["c"]["w"])}}
    tmasks = randk.mask_tree(tkm, ttree, 0.3)
    for t, j in zip(tree_leaves(tmasks), jax.tree.leaves(jmasks)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(tree_leaves(randk.apply_mask_tree(ttree, tmasks)),
                    jax.tree.leaves(jrandk.apply_mask_tree(tree, jmasks))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for unbiased in (False, True):
        jout = jax.jit(lambda t, m, b, k: jagg.pfels_production_aggregate(
            t, m, beta=b, r=1, sigma0=1.3, noise_key=k,
            unbiased_rescale=unbiased, compression_p=0.3))(
                tree, jmasks, jnp.float32(7.3), kn)
        tout = aggregation.pfels_production_aggregate(
            ttree, tmasks, beta=torch.tensor(7.3), r=1, sigma0=1.3,
            noise_key=tkn, unbiased_rescale=unbiased, compression_p=0.3)
        for t, j in zip(tree_leaves(tout), jax.tree.leaves(jout)):
            j = np.asarray(j)
            np.testing.assert_array_equal(t.numpy(), j)
    # the superposition over clients (the reference's psum over
    # ``axis_name``) is an all_reduce over a process group: over a world
    # of one rank it sums one client, and agrees with the single-client
    # route to rounding (that route fuses the beta product into the noise
    # add, as XLA does; the group route cannot, the sum lies between)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        grouped = aggregation.pfels_production_aggregate(
            ttree, tmasks, beta=torch.tensor(7.3), r=1, sigma0=1.3,
            noise_key=tkn, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    single = aggregation.pfels_production_aggregate(
        ttree, tmasks, beta=torch.tensor(7.3), r=1, sigma0=1.3,
        noise_key=tkn)
    for g, t in zip(tree_leaves(grouped), tree_leaves(single)):
        np.testing.assert_allclose(g.numpy(), t.numpy(), rtol=1e-6,
                                   atol=1e-6 * np.abs(t.numpy()).max())


# ------------------------------------------------------------- the steps

_MESH = {}


def _mesh():
    if "m" not in _MESH:
        _MESH["m"] = make_host_mesh((1, 1), ("data", "model"))
    return _MESH["m"]


def _setup(arch, dtype="float32", batch=4, seq=32, seed=0):
    jcfg = dataclasses.replace(j_reduced(arch), dtype=dtype,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(arch), dtype=dtype,
                               param_dtype=dtype)
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    tp = convert.lm_params_from_jax(jp, tcfg, "cpu")
    d = sum(x.size for x in jax.tree.leaves(jp))
    assert TT.param_count(tp) == d
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": _t(toks[:, :-1]).long(),
          "labels": _t(toks[:, 1:]).long()}
    return jcfg, tcfg, jp, tp, d, jb, tb


def _run_both(jcfg, tcfg, jp, tp, d, jb, tb, kw, chan, n_steps):
    """n_steps of the reference's jitted step and the port's from the
    same params, keys fold_in(PRNGKey(0), i)."""
    jpf = JPFELS(channel=chan[0], **kw)
    tpf = PFELSConfig(channel=chan[1], **kw)
    jstep = jax.jit(j_make_step(jcfg, jpf, d, _mesh()))
    tstep = steps.make_pfels_train_step(tcfg, tpf, d)
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    jps, tps, jms, tms = [jp], [tp], [], []
    with use_mesh(_mesh()):
        for i in range(n_steps):
            p, m = jstep(jps[-1], jb, jax.random.fold_in(jkey, i))
            jps.append(jax.device_get(p))
            jms.append(m)
            p, m = tstep(tps[-1], tb, prng.fold_in(tkey, i))
            tps.append(p)
            tms.append(m)
    return jps, tps, jms, tms


def _assert_steps_close(jps, tps, jms, tms):
    for jm, tm in zip(jms, tms):
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "grad_norm", "beta", "energy"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_RTOL, err_msg=k)
    for j0, j1, t1 in zip(jps, jps[1:], tps[1:]):
        ref0 = dict(convert._walk(j0))
        got = dict(convert._walk(t1))
        for name, want in convert._walk(j1):
            want = np.asarray(want, np.float32)
            scale = np.abs(want - np.asarray(ref0[name], np.float32)).max()
            gap = np.abs(got[name].float().numpy() - want)
            limit = THETA_OF_UPDATE * scale + np.spacing(np.abs(want))
            assert np.all(gap <= limit), (name, float(gap.max()), scale)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b"],
                         ids=["dense", "hybrid"])
def test_pfels_train_step_matches_reference(arch):
    """Two production steps of the example's settings (p = 0.5, eps = 4,
    eta = 0.1, ``scaled_channel(d)``) in f32: the masks of each step's key
    bit-equal, the metrics within 1e-5, each leaf's new theta within 1e-4
    of the leaf's largest update; no kernel launched on the CPU."""
    jcfg, tcfg, jp, tp, d, jb, tb = _setup(arch)
    kw = dict(num_clients=1000, clients_per_round=1, compression_ratio=0.5,
              epsilon=4.0, local_lr=0.1, local_steps=1)
    clip_kernel.reset_launch_counts()
    jps, tps, jms, tms = _run_both(jcfg, tcfg, jp, tp, d, jb, tb, kw,
                                   (j_scaled(d), scaled_channel(d)), 2)
    assert clip_kernel.LAUNCHES["clip_norm"] == 0
    _assert_steps_close(jps, tps, jms, tms)
    for i in range(2):
        _, jkm, _ = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), i), 3)
        _, tkm, _ = prng.split(prng.fold_in(prng.PRNGKey(0, "cpu"), i), 3)
        jm = jrandk.mask_tree(jkm, jp, 0.5)
        tm = randk.mask_tree(tkm, tp, 0.5)
        for t, j in zip(tree_leaves(tm), jax.tree.leaves(jm)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("override", [dict(local_steps=2),
                                      dict(grad_accum=2)],
                         ids=["tau2", "accum2"])
def test_local_steps_and_grad_accum_match_reference(override):
    """tau = 2 (two clipped SGD steps on half batches) and grad_accum = 2
    on the reduced mamba2-130m, as tests/test_system.py runs them (noise
    1e-9, p = 1, eps 1e9): one step against the reference at the step's
    tolerances; and in the port, accum 2 stays within the reference
    test's 5e-3 of accum 1 while tau 2 moves theta away from tau 1."""
    jcfg, tcfg, jp, tp, d, jb, tb = _setup("mamba2-130m")
    kw = dict(num_clients=100, clients_per_round=1, compression_ratio=1.0,
              epsilon=1e9, local_lr=0.05, **{"local_steps": 1, **override})
    chan = (JChannel(noise_std=1e-9), ChannelConfig(noise_std=1e-9))
    jps, tps, jms, tms = _run_both(jcfg, tcfg, jp, tp, d, jb, tb, kw, chan,
                                   1)
    _assert_steps_close(jps, tps, jms, tms)
    base = dict(kw, local_steps=1, grad_accum=1)
    one, _ = steps.make_pfels_train_step(
        tcfg, PFELSConfig(channel=chan[1], **base), d)(
            tp, tb, prng.fold_in(prng.PRNGKey(0, "cpu"), 0))
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(one), tree_leaves(tps[1])))
    if "grad_accum" in override:
        assert diff < 5e-3, diff
    else:
        assert diff > 1e-6, diff


def test_bf16_step_matches_reference():
    """One step of the reduced zamba2-2.7b in bf16, its dtype: the masks
    equal, the loss within 1e-2, every metric and leaf finite and in its
    dtype."""
    jcfg, tcfg, jp, tp, d, jb, tb = _setup("zamba2-2.7b", dtype="bfloat16")
    kw = dict(num_clients=1000, clients_per_round=1, compression_ratio=0.5,
              epsilon=4.0, local_lr=0.1, local_steps=1)
    jps, tps, jms, tms = _run_both(jcfg, tcfg, jp, tp, d, jb, tb, kw,
                                   (j_scaled(d), scaled_channel(d)), 1)
    np.testing.assert_allclose(float(tms[0]["loss"]), float(jms[0]["loss"]),
                               rtol=1e-2)
    assert all(bool(torch.isfinite(v)) for v in tms[0].values())
    for t, j in zip(tree_leaves(tps[1]), tree_leaves(tp)):
        assert t.dtype == j.dtype and bool(torch.isfinite(t.float()).all())
    _, jkm, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    _, tkm, _ = prng.split(prng.PRNGKey(0, "cpu"), 3)
    for t, j in zip(tree_leaves(randk.mask_tree(tkm, tp, 0.5)),
                    jax.tree.leaves(jrandk.mask_tree(jkm, jp, 0.5))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_prefill_and_serve_steps_wrap_the_model():
    cfg = dataclasses.replace(reduced_config("zamba2-2.7b"),
                              dtype="float32", param_dtype="float32")
    params = TT.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    toks = prng.randint(prng.PRNGKey(1, "cpu"), (2, 16), 0, cfg.vocab_size)
    logits, caches = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    want, _, _ = TT.prefill(params, cfg, {"tokens": toks})
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, dim=-1)
    caches = TT.make_caches(cfg, 2, 20, dtype=torch.float32, device="cpu")
    out, _ = steps.make_serve_step(cfg)(params, tok, caches)
    assert out.shape == (2, 1, TL.pad_vocab(cfg.vocab_size))


# ----------------------------------------------------- data, PRNG, optim

def test_make_lm_sequences_matches_reference():
    from repro.data import make_lm_sequences as j_make
    want = np.asarray(j_make(jax.random.PRNGKey(4), n_seqs=4, seq_len=33,
                             vocab=64))
    got = make_lm_sequences(prng.PRNGKey(4, "cpu"), n_seqs=4, seq_len=33,
                            vocab=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_and_categorical_match_reference():
    """The Gumbel draw within 1e-6 (the logs are XLA's, op for op) and
    the categorical indices equal, for one key and a batch of keys."""
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.gumbel(key, (5, 300)))
    got = prng.gumbel(prng.PRNGKey(9, "cpu"), (5, 300))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(5).standard_normal((6, 40)).astype(
        np.float32)
    keys = jax.random.split(key, 6)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = prng.categorical(prng.split(prng.PRNGKey(9, "cpu"), 6),
                           _t(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.categorical(key, logits))
    got = prng.categorical(prng.PRNGKey(9, "cpu"), _t(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_optim_and_schedules_match_reference():
    """Three steps of SGD with momentum and of Adam (with weight decay)
    on a bf16 and f32 tree, and the three schedules, within 1e-6."""
    from repro import optim as joptim
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jp = {"w": jnp.asarray(params["w"], jnp.bfloat16),
          "b": jnp.asarray(params["b"])}
    tp = {"w": _t(params["w"], torch.bfloat16), "b": _t(params["b"])}

    def check(t, j):
        for k in j:
            np.testing.assert_allclose(t[k].float().numpy(),
                                       np.asarray(j[k], np.float32),
                                       rtol=1e-6, atol=1e-6)
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype)

    for name in ("sgd", "adam"):
        js, ts = (joptim.sgd_init(jp), optim.sgd_init(tp)) if name == "sgd" \
            else (joptim.adam_init(jp), optim.adam_init(tp))
        jq, tq = jp, tp
        for g in grads:
            jg = jax.tree.map(jnp.asarray, g)
            tg = {k: _t(v) for k, v in g.items()}
            if name == "sgd":
                jq, js = joptim.sgd_update(jq, jg, js, lr=0.1, momentum=0.9)
                tq, ts = optim.sgd_update(tq, tg, ts, lr=0.1, momentum=0.9)
            else:
                jq, js = joptim.adam_update(jq, jg, js, lr=0.01,
                                            weight_decay=0.1)
                tq, ts = optim.adam_update(tq, tg, ts, lr=0.01,
                                           weight_decay=0.1)
            check(tq, jq)
    for jf, tf in ((joptim.constant(0.3), optim.constant(0.3)),
                   (joptim.cosine(0.3, 50), optim.cosine(0.3, 50)),
                   (joptim.warmup_cosine(0.3, 10, 50),
                    optim.warmup_cosine(0.3, 10, 50))):
        for step in (0, 3, 10, 27, 50, 80):
            np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                       rtol=1e-6, atol=1e-7)
