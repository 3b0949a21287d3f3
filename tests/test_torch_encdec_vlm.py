"""The port's encoder-decoder (Whisper) and VLM (Qwen2-VL) families
against the JAX reference on the CPU: ``sinusoidal_pos``,
``mrope_positions`` and ``apply_mrope``; the reduced whisper-tiny's
``encode``, and for it and the reduced qwen2-vl-72b the ``prefill``
logits, caches and ``enc_out``, then greedy ``decode_step``s with equal
tokens (Whisper's sinusoid at the cache's index and cross-attention over
the encoder's frames; the VLM's M-RoPE decode positions);
``forward_train``'s loss and gradients; one bf16 prefill of each new
family. The reference runs under ``jax.threefry_partitionable(False)``
and its params are carried across (``repro_torch.convert``). On the CPU
the attention runs the flash kernel's plain version.

Tolerances: f32 RTOL = ATOL = 5e-5, as ``tests/test_torch_serve.py``
measured across frameworks (measured here at most 5e-6 on O(1) values);
the sinusoids 2^-22 (1 + position) (XLA's f32 exp and ATen's part by an
ulp on some frequencies, which moves the angle by the position times
it); a model's gradients 1e-5 of each leaf's largest entry (measured at
most 2e-6); bf16 logits 3% of max|logit|, as ``tests/test_torch_serve.py``
allows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

RTOL, ATOL = 5e-5, 5e-5
POS_ULPS = 2.0 ** -22
MODEL_GRAD_OF_MAX = 1e-5
BF16_LOGIT_ATOL = 0.03


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


def _np(t):
    return t.detach().float().numpy()


def _cfgs(arch, dtype="float32"):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(j_reduced(arch), **kw),
            dataclasses.replace(t_reduced(arch), **kw))


def _params(jcfg, tcfg, seed=0):
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    return jp, convert.lm_params_from_jax(jp, tcfg, "cpu")


def _batch(jcfg, b, s, seed=0, dtype=np.float32, labels=False):
    """Tokens (and labels) and the family's stub prefix, 0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks[:, :-1])}
    if labels:
        jb["labels"] = jnp.asarray(toks[:, 1:], jnp.int32)
        tb["labels"] = torch.as_tensor(toks[:, 1:])
    if jcfg.family == "vlm":
        name, n = "vision_embeds", jcfg.vision_prefix
    else:
        name, n = "audio_embeds", jcfg.encoder_seq
    e = (0.02 * rng.standard_normal((b, n, jcfg.d_model))).astype(np.float32)
    jb[name] = jnp.asarray(e, jnp.dtype(dtype))
    tb[name] = convert.tensor_from_numpy(np.asarray(jb[name]), "cpu")
    return jb, tb


# --------------------------------------------------------------- positions

def test_sinusoidal_and_mrope_positions_match_reference():
    jcfg, tcfg = _cfgs("qwen2-vl-72b")
    pos = np.arange(1500, dtype=np.int32)[None].repeat(2, 0)
    got = _np(TT.sinusoidal_pos(torch.from_numpy(pos), 384))
    want = np.asarray(JT.sinusoidal_pos(jnp.asarray(pos), 384))
    assert np.all(np.abs(got - want) <= POS_ULPS * (1 + pos[..., None]))
    for vp, seq in ((16, 40), (1024, 1100), (10, 10), (0, 7)):
        jc = dataclasses.replace(jcfg, vision_prefix=vp)
        tc = dataclasses.replace(tcfg, vision_prefix=vp)
        np.testing.assert_array_equal(
            TT.mrope_positions(tc, 2, seq, device="cpu").numpy(),
            np.asarray(JT.mrope_positions(jc, 2, seq)))


@pytest.mark.parametrize("dh", [64, 128])
def test_apply_mrope_matches_reference(dh):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 40, 3, dh)).astype(np.float32)
    pos = np.asarray(JT.mrope_positions(
        dataclasses.replace(j_reduced("qwen2-vl-72b"), vision_prefix=16), 2,
        40))
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------ prefill and decode

def _assert_caches_close(tcaches, jcaches):
    for tc, jc in zip(tcaches, jcaches):
        assert sorted(tc) == sorted(jc)
        for key in tc:
            want = np.asarray(jc[key])
            assert tuple(tc[key].shape) == want.shape, key
            np.testing.assert_allclose(_np(tc[key]), want, rtol=RTOL,
                                       atol=ATOL, err_msg=key)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_prefill_then_greedy_decode_matches_reference(arch):
    """Whisper: ``encode`` and ``enc_out``, the cross-attention in every
    block, the decode's sinusoid at the cache's index. Qwen2-VL: the
    vision prefix (16 rows, attending to itself both ways under the
    reference's mask over M-RoPE ids), the caches over prefix and text,
    and M-RoPE decode positions."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    steps, b, s = 6, 2, 24
    jb, tb = _batch(jcfg, b, s)
    jl, jc, je = jax.jit(lambda p, b: JT.prefill(p, jcfg, b,
                                                 extra_slots=steps))(jp, jb)
    flash_kernel.reset_launch_counts()
    tl, tc, te = TT.prefill(tp, tcfg, tb, extra_slots=steps)
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == 0
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_caches_close(tc, jc)
    if jcfg.is_encoder_decoder:
        want = JT.encode(jp, jcfg, jb["audio_embeds"])
        np.testing.assert_allclose(
            _np(TT.encode(tp, tcfg, tb["audio_embeds"])), np.asarray(want),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(te), np.asarray(je), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert te is None and je is None
        assert tc[0]["k"].shape[2] == jcfg.vision_prefix + s + steps

    decode = jax.jit(lambda p, t, c, e: JT.decode_step(p, jcfg, t, c,
                                                       enc_out=e))
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1)
    for step in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"token {step}")
        jl, jc = decode(jp, jtok, jc, je)
        tl, tc = TT.decode_step(tp, tcfg, ttok, tc, enc_out=te)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_forward_train_loss_and_gradients_match_reference(arch):
    """The loss (no loss on the vision prefix) and every leaf's gradient,
    the encoder's and the cross-attention's included."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg, 2, 16, seed=3, labels=True)
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
    assert float(m["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    for name, want in convert._walk(jax.device_get(jg)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(
            _np(leaves[name].grad), want, rtol=0,
            atol=MODEL_GRAD_OF_MAX * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-tiny",
                                  "qwen2-vl-72b"])
def test_bf16_prefill_within_bf16_rounding(arch):
    """bf16, the families' serving dtype, with a bf16 prefix: the prefill's
    logits within 3% of max|logit|."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp, tp = _params(jcfg, tcfg, seed=1)
    jb, tb = _batch(jcfg, 2, 24, seed=1, dtype=jnp.bfloat16)
    jl, _, _ = jax.jit(lambda p, b: JT.prefill(p, jcfg, b))(jp, jb)
    tl, _, _ = TT.prefill(tp, tcfg, tb)
    assert tl.dtype == torch.bfloat16
    want = np.asarray(jl, np.float32)
    np.testing.assert_allclose(_np(tl), want, rtol=0,
                               atol=BF16_LOGIT_ATOL * np.abs(want).max())
