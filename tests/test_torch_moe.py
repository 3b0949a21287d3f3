"""The port's MoE (``repro_torch.models.moe``) and the MoE family against
the JAX reference on the CPU: ``moe_apply``'s output, load-balance loss
and drop fraction with padded experts, with drops, with tied router
columns and at a decode-sized T, and its gradients against ``jax.grad``
(through both gather-only backwards); the reduced granite-moe-3b-a800m
(padded experts, with and without drops) and qwen3-moe-30b-a3b:
``prefill`` logits and caches, then greedy ``decode_step``s with equal
tokens; ``forward_train``'s loss, aux loss and gradients; one production
PFELS step. The reference runs under ``jax.threefry_partitionable(False)``
and its params are carried across (``repro_torch.convert``).

Tolerances (f32): outputs and logits RTOL = ATOL = 5e-5, as
``tests/test_torch_serve.py`` measured across frameworks (measured here
at most 5e-6 on O(1) logits); ``moe_apply``'s gradients 1e-6 relative
with 1e-6 of the largest entry, as ``tests/test_torch_llm_train.py``
holds the losses' gradients; a model's gradients 1e-5 of each leaf's
largest entry (f32 sums in another order through two blocks; measured
at most 1.5e-6); the step at ``tests/test_torch_llm_train.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import PFELSConfig as JPFELS
from repro.configs import reduced_config as j_reduced
from repro.core.channel import scaled_channel as j_scaled
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.launch.steps import make_pfels_train_step as j_make_step
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import convert, prng
from repro_torch.configs import PFELSConfig
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.channel import scaled_channel
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.launch import steps
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

RTOL, ATOL = 5e-5, 5e-5
GRAD_RTOL = 1e-6
MODEL_GRAD_OF_MAX = 1e-5
METRIC_RTOL = 1e-5
THETA_OF_UPDATE = 1e-4


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread, as the other files that
    interleave torch and XLA work pin it (parallel test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, padded=None, capacity_factor=None):
    """The reduced config of both packages in f32, with the MoE's padded
    experts and capacity factor set in both (``reduced_config`` drops the
    padding)."""
    out = []
    for cfg in (j_reduced(arch), t_reduced(arch)):
        moe = cfg.moe
        if padded is not None:
            moe = dataclasses.replace(moe, padded_experts=padded)
        if capacity_factor is not None:
            moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, dtype="float32",
                                       param_dtype="float32", moe=moe))
    return out


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return {k: np.array(v) for k, v in tree.items()}


# ------------------------------------------------------------- moe_apply

# (padded experts, capacity factor, tied router columns, B, S)
MOE_CASES = {"padded": (6, None, False, 2, 24),
             "drops": (6, 0.5, False, 2, 24),
             "ties": (None, None, True, 2, 24),
             "decode": (6, 0.5, False, 8, 1)}


def _moe_case(name):
    padded, cf, ties, b, s = MOE_CASES[name]
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", padded, cf)
    jp, _ = JM.moe_init(jax.random.PRNGKey(1), jcfg,
                        experts_padded=jcfg.moe.experts_padded(1))
    jp = _tree_np(jax.device_get(jp))
    if ties:  # expert 1's column equals expert 0's: every token ties
        jp["router"][:, 1] = jp["router"][:, 0]
    x = np.random.default_rng(2).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    tp = {k: convert.tensor_from_numpy(v, "cpu") for k, v in jp.items()}
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    """The output, the load-balance loss (1e-6 relative) and the drop
    fraction (to f32's ulp of 1: XLA's mean multiplies by 1/n); the
    routing plan of the reference's own top-k choices slot for slot,
    which holds the dropped k-slots to the reference's."""
    jcfg, tcfg, jp, tp, x = _moe_case(case)
    jy, jaux = jax.jit(lambda p, x: JM.moe_apply(p, jcfg, x))(jp, x)
    ty, taux = TM.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(taux["drop_fraction"]),
                               float(jaux["drop_fraction"]), rtol=0,
                               atol=2.0 ** -23)
    dropped = float(taux["drop_fraction"]) > 0
    assert dropped == (MOE_CASES[case][1] is not None), case

    e, k = jp["router"].shape[-1], jcfg.moe.top_k
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ jp["router"]
    logits[:, jcfg.moe.num_experts:] = -1e9
    _, top_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    cap = max(int(np.ceil(t * k / jcfg.moe.num_experts
                          * jcfg.moe.capacity_factor)), 4)
    want = JM._routing_plan(top_e, e, cap)
    got = TM._routing_plan(torch.from_numpy(np.asarray(top_e)).long(), e,
                           cap)
    for key in ("flat_e", "pos_k", "keep", "tok_idx", "slot_valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_top_k_takes_the_lower_index_first_among_ties():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    got_v, got_i = TM._top_k(probs, 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("case", ["padded", "drops"])
def test_moe_apply_gradients_match_jax_grad(case):
    """The gradients of a scalar of the output and the aux loss, for x,
    the router and the three expert matrices: through the dispatch's and
    the combine's gather-only backwards, the combine's weight cotangent
    an f32 dot."""
    jcfg, tcfg, jp, tp, x = _moe_case(case)
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)

    def jf(p, x):
        y, aux = JM.moe_apply(p, jcfg, x)
        return jnp.sum(y * ct) + 0.3 * aux["load_balance_loss"]

    jval, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(jp, x)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_apply(tp, tcfg, tx)
    tval = torch.sum(y * torch.from_numpy(ct)) \
        + 0.3 * aux["load_balance_loss"]
    tval.backward()
    # the scalar sums 12,288 signed products in another order
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for name, tg, jg in [("x", tx.grad, jgx)] + [
            (k, tp[k].grad, jgp[k]) for k in sorted(jgp)]:
        jg = np.asarray(jg)
        np.testing.assert_allclose(_np(tg), jg, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(jg).max(),
                                   err_msg=name)


# ----------------------------------------------------------- the family

FAMILY_CASES = {"granite-padded": ("granite-moe-3b-a800m", 6, None),
                "granite-drops": ("granite-moe-3b-a800m", 6, 0.5),
                "qwen3-moe": ("qwen3-moe-30b-a3b", None, None)}


def _params(jcfg, tcfg, seed=0):
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    return jp, convert.lm_params_from_jax(jp, tcfg, "cpu")


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_prefill_then_greedy_decode_matches_reference(case):
    arch, padded, cf = FAMILY_CASES[case]
    jcfg, tcfg = _cfgs(arch, padded, cf)
    jp, tp = _params(jcfg, tcfg)
    steps_, b, s = 6, 2, 24
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, s))
    jl, jc, _ = jax.jit(lambda p, b: JT.prefill(p, jcfg, b,
                                                extra_slots=steps_))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    flash_kernel.reset_launch_counts()
    tl, tc, enc = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                             extra_slots=steps_)
    assert enc is None and flash_kernel.LAUNCHES["flash_attention_fwd"] == 0
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for tcache, jcache in zip(tc, jc):
        assert sorted(tcache) == sorted(jcache)
        for key in tcache:
            np.testing.assert_allclose(_np(tcache[key]),
                                       np.asarray(jcache[key]), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1)
    for step in range(steps_):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"token {step}")
        jl, jc = decode(jp, jtok, jc)
        tl, tc = TT.decode_step(tp, tcfg, ttok, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def _batch(jcfg, b=2, s=16, seed=4):
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    return jb, tb


@pytest.mark.parametrize("case", ["granite-drops", "qwen3-moe"])
def test_forward_train_loss_aux_and_gradients_match_reference(case):
    arch, padded, cf = FAMILY_CASES[case]
    jcfg, tcfg = _cfgs(arch, padded, cf)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: JT.forward_train(p, jcfg, jb), has_aux=True)(jp)
    leaves = dict(convert._walk(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    total, m = TT.forward_train(tp, tcfg, tb)
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    assert float(jm["aux_loss"]) > 0
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-6)
    for name, want in convert._walk(jax.device_get(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            _np(leaves[name].grad), want, rtol=0,
            atol=MODEL_GRAD_OF_MAX * np.abs(want).max(), err_msg=name)


def test_pfels_step_of_reduced_granite_moe_matches_reference():
    """One production step (the example's settings: p = 0.5, eps = 4,
    eta = 0.1, ``scaled_channel(d)``) of the reduced granite-moe with 6
    padded experts, its aux loss in the loss: the metrics within 1e-5,
    each leaf's new theta within 1e-4 of the leaf's largest update, as
    ``tests/test_torch_llm_train.py`` holds the dense and hybrid steps."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", 6, None)
    jp, tp = _params(jcfg, tcfg)
    d = sum(x.size for x in jax.tree.leaves(jp))
    jb, tb = _batch(jcfg, b=4, s=32, seed=0)
    kw = dict(num_clients=1000, clients_per_round=1, compression_ratio=0.5,
              epsilon=4.0, local_lr=0.1, local_steps=1)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    jstep = jax.jit(j_make_step(jcfg, JPFELS(channel=j_scaled(d), **kw), d,
                                mesh))
    tstep = steps.make_pfels_train_step(
        tcfg, PFELSConfig(channel=scaled_channel(d), **kw), d)
    with use_mesh(mesh):
        jp1, jm = jstep(jp, jb, jax.random.PRNGKey(0))
    jp1 = jax.device_get(jp1)
    tp1, tm = tstep(tp, tb, prng.PRNGKey(0, "cpu"))
    assert sorted(tm) == sorted(jm)
    assert float(jm["aux_loss"]) > 0
    for k in ("loss", "aux_loss", "grad_norm", "beta", "energy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    ref0 = dict(convert._walk(jp))
    got = dict(convert._walk(tp1))
    for name, want in convert._walk(jp1):
        want = np.asarray(want, np.float32)
        scale = np.abs(want - np.asarray(ref0[name], np.float32)).max()
        gap = np.abs(_np(got[name]) - want)
        limit = THETA_OF_UPDATE * scale + np.spacing(np.abs(want))
        assert np.all(gap <= limit), (name, float(gap.max()), scale)
