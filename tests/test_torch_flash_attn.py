"""The port's attention against the JAX reference on the CPU: the flash
kernel's CPU route (the plain version ``attention_ref``) against the
reference's Pallas ``flash_attention_fwd`` in interpret mode and its
``attention_ref``; the blockwise ``flash_attention`` (positions, a validity
mask) against ``repro.models.attention.flash_attention``; ``attn_train``
/ ``attn_decode`` with weights carried across, the decode over a ring
buffer of slots; and the rounding of the kernel's bf16 (tensor-core) route,
emulated blockwise, within the tolerance the card is held to."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced
from repro.kernels.flash_attn.kernel import flash_attention_fwd as j_pallas
from repro.kernels.flash_attn.ref import attention_ref as j_ref
from repro.models import attention as ja
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.flash_attn import kernel as t_kernel
from repro_torch.kernels.flash_attn import ops as t_ops
from repro_torch.kernels.flash_attn import ref as t_ref
from repro_torch.models import attention as ta

# f32 softmax attention in another summation order (one softmax against
# the online softmax over KV blocks): a few ulp of O(1) outputs
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _qkv(b, sq, skv, h, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32))


def _t(a):
    return convert.tensor_from_numpy(a, "cpu")


# (b, sq, skv, h, hkv, dh, causal, window, block): MHA, GQA 8/2, Dh 64
# and 80, a window, Sq < Skv (suffix-aligned rows), and blocks that do not
# divide the sequence (the Pallas kernel falls back to one block)
CASES = [
    (1, 128, 128, 4, 4, 64, True, None, 64),
    (2, 64, 64, 8, 2, 80, True, None, 32),
    (1, 96, 96, 8, 2, 64, True, 24, 64),
    (1, 32, 80, 4, 2, 80, True, None, 64),
    (2, 48, 48, 4, 1, 64, False, None, 32),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_attention_matches_pallas_and_reference(case):
    b, sq, skv, h, hkv, dh, causal, window, block = case
    q, k, v = _qkv(b, sq, skv, h, hkv, dh, seed=sq + h + dh)
    out = t_kernel.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                       window=window)
    assert out.dtype == torch.float32 and out.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = j_ref(jq, jk, jv, causal=causal, window=window)
    want_pallas = j_pallas(jq, jk, jv, causal=causal, window=window,
                           block_q=block, block_kv=block, interpret=True)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_plain_attention_bf16_matches_pallas():
    """bf16 inputs: both compute in f32 and round the output to bf16, so
    they differ by at most one bf16 ulp, 2^-7 of the value."""
    q, k, v = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16))
               for t in _qkv(1, 64, 64, 4, 2, 80, seed=5))
    out = t_kernel.flash_attention_fwd(_t(q), _t(k), _t(v))
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_pallas(*map(jnp.asarray, (q, k, v)), block_q=32,
                               block_kv=32, interpret=True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("window", [None, 300])
def test_tensor_core_rounding_within_the_stated_bound(window):
    """At zamba2-2.7b's row length (S 2048, Dh 80, causal; and a window of
    300, whose rows past it start on wholly masked tiles) the bf16 route's
    rounding of P stays within 2^-7 |plain| + 2^-8 max|v| of the f32
    plain version, the bound chip_smoke.py and the card's tests hold the
    kernel to, and it does move the output."""
    rng = np.random.default_rng(2048 + (window or 0))
    q, k, v = (convert.tensor_from_numpy(
        rng.standard_normal((1, 2048, 2, 80)).astype(np.float32),
        "cpu").bfloat16() for _ in range(3))
    got = t_ref.tensor_core_route(q, k, v, causal=True,
                                  window=window)[0].float()
    want = t_kernel.flash_attention_fwd(q.float(), k.float(), v.float(),
                                        causal=True, window=window)
    want_jax = np.asarray(j_ref(*(jnp.asarray(t.float().numpy())
                                  for t in (q, k, v)),
                                causal=True, window=window))
    np.testing.assert_allclose(want.numpy(), want_jax, rtol=RTOL, atol=ATOL)
    err = (got - want).abs()
    limit = 2 ** -7 * want.abs() + 2 ** -8 * v.float().abs().max()
    assert bool((err <= limit).all()), float((err / limit).max())
    assert float(err.max()) > 0


@pytest.mark.parametrize("case", [(1, 300, 300, 4, 2, 80, None),
                                  (1, 257, 257, 2, 1, 160, 100)])
def test_tensor_core_emulation_limit_covers_another_summation_order(case):
    """The limit that holds the card to the emulated rounding covers what
    another summation order of S (the card's tensor cores) does: the same
    emulation with the head dimension of q and k permuted sums S in
    another order, rounds some p the other way, and stays within it."""
    b, sq, skv, h, hkv, dh, window = case
    q, k, v = (_t(a).bfloat16() for a in _qkv(b, sq, skv, h, hkv, dh,
                                              seed=dh))
    out, limit = t_ref.tensor_core_route(q, k, v, causal=True, window=window)
    perm = torch.from_numpy(np.random.default_rng(dh).permutation(dh))
    other, _ = t_ref.tensor_core_route(q[..., perm].contiguous(),
                                       k[..., perm].contiguous(), v,
                                       causal=True, window=window)
    err = (other.float() - out.float()).abs()
    assert float(err.max()) > 0
    assert bool((err <= limit).all()), float((err / limit).max())
    # the limit is a few ulps, far inside the bound against the plain
    # version
    bound = 2 ** -8 * v.float().abs().max()
    assert float(limit.median()) < float(bound) / 8


def test_wrappers_refuse_rows_with_no_key():
    q, k, v = map(_t, _qkv(1, 16, 8, 2, 2, 64, seed=0))
    with pytest.raises(ValueError, match="no key"):
        t_kernel.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="window"):
        t_ops.attention(k, k, v, window=0, use_kernel=False)
    with pytest.raises(ValueError, match="group"):
        t_kernel.flash_attention_fwd(q[:, :, :1].expand(1, 16, 3, 64)
                                     .contiguous(), k, v[:, :, :2],
                                     causal=False)


@pytest.mark.parametrize("block_kv", [32, 48])
@pytest.mark.parametrize("window", [None, 20])
def test_blockwise_attention_with_valid_mask(block_kv, window):
    """Positions and a kv_valid mask, blocks that divide (32) and do not
    (48, one block)."""
    b, sq, skv, h, hkv, dh = 2, 8, 64, 8, 2, 80
    q, k, v = _qkv(b, sq, skv, h, hkv, dh, seed=block_kv)
    rng = np.random.default_rng(1)
    pos_q = np.broadcast_to(np.arange(40, 48, dtype=np.int32), (b, sq))
    pos_kv = np.broadcast_to(rng.permutation(64).astype(np.int32), (b, skv))
    valid = rng.random((b, skv)) < 0.8
    valid[:, pos_kv[0] == 40] = True          # every row keeps one key
    out = ta.flash_attention(*map(_t, (q, k, v)), _t(pos_q.copy()),
                             _t(pos_kv.copy()), causal=True, window=window,
                             kv_valid=torch.as_tensor(valid),
                             block_kv=block_kv)
    want = ja.flash_attention(*map(jnp.asarray, (q, k, v, pos_q, pos_kv)),
                              causal=True, window=window,
                              kv_valid=jnp.asarray(valid),
                              block_kv=block_kv, remat=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _attn_cfgs(**kw):
    kw = dict(dtype="float32", param_dtype="float32", n_heads=8,
              n_kv_heads=2, head_dim=80, **kw)
    return (dataclasses.replace(j_reduced("zamba2-2.7b"), **kw),
            dataclasses.replace(t_reduced("zamba2-2.7b"), **kw))


def test_attn_train_matches_reference():
    jcfg, tcfg = _attn_cfgs(qkv_bias=True)
    jp, _ = ja.attn_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.device_get(jp)
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    yj, cj = jax.jit(lambda p, x, pos: ja.attn_train(
        p, jcfg, x, pos, block_kv=16))(jp, jnp.asarray(x), jnp.asarray(pos))
    y, c = ta.attn_train(tp, tcfg, _t(x), torch.as_tensor(pos.copy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(cj[key]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [None, 6])
def test_attn_decode_over_ring_slots_matches_reference(window):
    """Ten decode steps from an empty cache: with a window of 6 the cache
    is a ring of 6 slots that wraps; without, 16 slots fill in order."""
    jcfg, tcfg = _attn_cfgs()
    jp, _ = ja.attn_init(jax.random.PRNGKey(1), jcfg)
    jp = jax.device_get(jp)
    tp = {k: _t(v) for k, v in jp.items()}
    jc = ja.make_decode_cache(jcfg, 2, 16, window=window, dtype=jnp.float32)
    tc = ta.make_decode_cache(tcfg, 2, 16, window=window,
                              dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, x, c: ja.attn_decode(p, jcfg, x, c,
                                                  window=window))
    rng = np.random.default_rng(2)
    for i in range(10):
        x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        yj, jc = step(jp, jnp.asarray(x), jc)
        y, tc = ta.attn_decode(tp, tcfg, _t(x), tc, window=window)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=RTOL, atol=ATOL)
    for key in ("idx", "slot_pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
