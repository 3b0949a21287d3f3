"""The port's serving path against the JAX reference on the CPU, with the
reference's params carried across (``repro_torch.convert``): ``prefill``
logits and every cache leaf, then greedy ``decode_step``s with equal
tokens, for the reduced hybrid (zamba2-2.7b), SSM (mamba2-130m) and dense
(phi3-mini-3.8b) configs in f32; one bf16 run; ``serve``'s prompt,
vision and audio draws bit for bit, and its sampled tokens equal to the
reference ``serve``'s for one reduced config of each family in f32; and
bf16 params carried across bit for bit. The MoE, Whisper and VLM
families' prefill and decode are in ``tests/test_torch_moe.py`` and
``tests/test_torch_encdec_vlm.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced
from repro.models import transformer as JT
from repro_torch import convert, prng
from repro_torch.configs import get_config
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch import serve as t_serve
from repro_torch.models import transformer as TT

# f32 forward through a few blocks in another summation order (XLA vs
# ATen matmuls and einsums, one softmax vs blockwise): measured at most
# 1.5e-5 on the caches and 8e-6 on O(1) logits
RTOL, ATOL = 5e-5, 5e-5
# bf16: the reference rounds q * scale and the probabilities to bf16
# where the port's flash kernel keeps f32, and the frameworks round other
# intermediates at other places; measured 0.6% of max|logit|
BF16_LOGIT_ATOL = 0.03


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _cfgs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (dataclasses.replace(j_reduced(arch), **kw),
            dataclasses.replace(t_reduced(arch), **kw))


def _params(jcfg, tcfg, seed=0):
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    return jp, convert.lm_params_from_jax(jp, tcfg, "cpu")


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _assert_caches_close(tcaches, jcaches):
    assert len(tcaches) == len(jcaches)
    for tc, jc in zip(tcaches, jcaches):
        assert sorted(tc) == sorted(jc)
        for key in tc:
            want = np.asarray(jc[key])
            assert tuple(tc[key].shape) == want.shape, key
            if np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(_np(tc[key]), want)
            else:
                np.testing.assert_allclose(_np(tc[key]), want, rtol=RTOL,
                                           atol=ATOL, err_msg=key)


# zamba2 (mamba, attn) x 1 repeat; the same pattern x 2 repeats, where a
# pattern-major order would swap layers; mamba2 x 2 repeats; dense attn
CASES = {"zamba2": ("zamba2-2.7b", {}),
         "zamba2-2rep": ("zamba2-2.7b", {"n_repeat": 2, "n_layers": 4}),
         "mamba2": ("mamba2-130m", {}),
         "phi3": ("phi3-mini-3.8b", {})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_then_greedy_decode_matches_reference(case):
    arch, kw = CASES[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, tcfg)
    steps, b, s = 8, 2, 48      # s = 48: the SSD chunk halves to 16
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, s))
    jl, jc, _ = jax.jit(lambda p, b: JT.prefill(p, jcfg, b,
                                                extra_slots=steps))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc, _ = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                           extra_slots=steps)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _assert_caches_close(tc, jc)

    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1)
    for step in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"token {step}")
        jl, jc = decode(jp, jtok, jc)
        tl, tc = TT.decode_step(tp, tcfg, ttok, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches_close(tc, jc)


def test_bf16_prefill_and_decode_within_bf16_rounding():
    jcfg, tcfg = _cfgs("zamba2-2.7b", dtype="bfloat16")
    jp, tp = _params(jcfg, tcfg, seed=1)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 32))
    jl, jc, _ = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, extra_slots=2))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc, _ = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                           extra_slots=2)
    assert tl.dtype == torch.bfloat16
    want = np.asarray(jl, np.float32)
    atol = BF16_LOGIT_ATOL * np.abs(want).max()
    np.testing.assert_allclose(_np(tl), want, rtol=0, atol=atol)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1), np.int32)
    jl, _ = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc)
    tl, _ = TT.decode_step(tp, tcfg, torch.as_tensor(tok.copy()).long(), tc)
    np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32), rtol=0,
                               atol=atol)


def test_serve_draws_the_reference_prompt():
    """``serve`` splits its seed's key and draws the prompt as the
    reference's ``serve`` does: the tokens are bit-equal."""
    batch, prompt_len, seed = 3, 40, 5
    ssd_kernel.reset_launch_counts()
    flash_kernel.reset_launch_counts()
    r = t_serve.serve("zamba2-2.7b", reduced=True, batch=batch,
                      prompt_len=prompt_len, new_tokens=3, seed=seed,
                      device="cpu")
    _, tok_key, _, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    want = jax.random.randint(tok_key, (batch, prompt_len), 0,
                              j_reduced("zamba2-2.7b").vocab_size)
    np.testing.assert_array_equal(r["prompt"].numpy(), np.asarray(want))
    assert r["tokens"].shape == (batch, 3)
    assert r["logits"].shape == (batch, 1, 512)
    assert bool(torch.isfinite(r["logits"].float()).all())
    assert r["prefill_s"] > 0 and r["decode_s"] > 0 and r["tok_per_s"] > 0
    # the CPU route runs the plain versions: no kernel is launched
    assert ssd_kernel.LAUNCHES["ssd_scan"] == 0
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == 0


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-tiny"])
def test_serve_draws_the_reference_prefix(arch):
    """The VLM's vision prefix and Whisper's audio frames, ``0.02 *
    normal(key, shape, bf16)`` from the third and fourth keys of the
    seed's split, bit for bit; the VLM's prompt holds prompt_len less the
    prefix."""
    batch, prompt_len, seed = 2, 40, 7
    r = t_serve.serve(arch, reduced=True, batch=batch, prompt_len=prompt_len,
                      new_tokens=1, seed=seed, device="cpu")
    cfg = j_reduced(arch)
    _, tok_key, vis_key, aud_key = jax.random.split(
        jax.random.PRNGKey(seed), 4)
    if cfg.family == "vlm":
        name, key, n = "vision_embeds", vis_key, cfg.vision_prefix
    else:
        name, key, n = "audio_embeds", aud_key, cfg.encoder_seq
    want = 0.02 * jax.random.normal(key, (batch, n, cfg.d_model),
                                    jnp.bfloat16)
    assert r[name].dtype == torch.bfloat16
    np.testing.assert_array_equal(r[name].view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    s_text = prompt_len - (n if cfg.family == "vlm" else 0)
    want = jax.random.randint(tok_key, (batch, s_text), 0, cfg.vocab_size)
    np.testing.assert_array_equal(r["prompt"].numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-tiny",
                                  "qwen2-vl-72b", "zamba2-2.7b"])
def test_sampled_serve_gives_the_reference_tokens(arch, monkeypatch):
    """``serve(greedy=False)`` in f32 with the reference's params: each
    token a categorical draw over the padded vocabulary from the root key
    split once more a step, as the reference ``serve`` draws it; the
    tokens equal. (The prefixes are bf16 in both, so Whisper's encoder
    runs in bf16 there too.)"""
    from repro.launch import serve as j_serve
    f32 = dict(dtype="float32", param_dtype="float32")
    monkeypatch.setattr(j_serve, "reduced_config",
                        lambda a: dataclasses.replace(j_reduced(a), **f32))
    monkeypatch.setattr(t_serve, "reduced_config",
                        lambda a: dataclasses.replace(t_reduced(a), **f32))
    seed, kw = 3, dict(reduced=True, batch=2, prompt_len=24, new_tokens=8)
    want = j_serve.serve(arch, seed=seed, greedy=False, **kw)["tokens"]
    init_key = jax.random.split(jax.random.PRNGKey(seed), 4)[0]
    jcfg = j_serve.reduced_config(arch)
    jp = jax.device_get(JT.init_params(init_key, jcfg)[0])
    tp = convert.lm_params_from_jax(jp, t_serve.reduced_config(arch), "cpu")
    got = t_serve.serve(arch, seed=seed, greedy=False, device="cpu",
                        params=tp, **kw)["tokens"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_params_cross_bit_for_bit():
    jcfg, tcfg = _cfgs("zamba2-2.7b", dtype="bfloat16")
    jp, tp = _params(jcfg, tcfg, seed=2)
    got = dict(convert._walk(tp))
    n_bf16 = 0
    for name, leaf in convert._walk(jp):
        t = got[name]
        if leaf.dtype == ml_dtypes.bfloat16:
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), leaf.view(np.int16))
        np.testing.assert_array_equal(
            convert.numpy_from_tensor(t).view(np.uint8),
            np.ascontiguousarray(leaf).view(np.uint8))
        assert convert.numpy_from_tensor(t).dtype == leaf.dtype
    assert n_bf16 > 10
    # a bf16 array with values a plain cast would not keep (NaN payloads,
    # subnormals, -0)
    words = np.array([0x7FC1, 0x0001, 0x8000, 0xFF80, 0x3F80],
                     np.uint16).view(ml_dtypes.bfloat16)
    back = convert.numpy_from_tensor(convert.tensor_from_numpy(words, "cpu"))
    np.testing.assert_array_equal(back.view(np.uint16),
                                  words.view(np.uint16))


def test_converted_tree_is_checked_against_the_config():
    jcfg, tcfg = _cfgs("zamba2-2.7b")
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.device_get(jp)
    bad = dict(jp, lm_head={"w": jp["lm_head"]["w"].T})
    with pytest.raises(ValueError, match="lm_head.w"):
        convert.lm_params_from_jax(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="paths"):
        convert.lm_params_from_jax({"embed": jp["embed"]}, tcfg, "cpu")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m"])
def test_init_matches_reference_shapes_dtypes_and_scales(arch):
    """Full width on the meta device (shapes and dtypes, as the reference's
    ``eval_shape``), and the reduced config drawn on the CPU (scales)."""
    from repro.configs import get_config as j_get
    want = jax.eval_shape(lambda k: JT.init_params(k, j_get(arch))[0],
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    got = dict(convert._walk(TT.init_params(None, get_config(arch),
                                            device="meta")))
    for name, leaf in convert._walk(want):
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert TT.param_count(got) == sum(x.size for x in
                                      jax.tree.leaves(want))
    jcfg, tcfg = _cfgs(arch)
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TT.init_params(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    for name, leaf in convert._walk(jax.device_get(jp)):
        t = dict(convert._walk(tp))[name]
        np.testing.assert_allclose(float(t.float().std()),
                                   float(np.std(leaf)), rtol=0.15,
                                   atol=1e-6, err_msg=name)
