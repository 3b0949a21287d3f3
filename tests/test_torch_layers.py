"""The port's shared LLM layers against ``repro.models.layers`` on the CPU:
both norm kinds in both implementations, RoPE, both MLP activations, the
embedding and the (tied and untied) head, with the same inputs made from a
seed with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.models import layers as jl
from repro_torch.models import layers as tl

# f32 elementwise math and short reductions in another order: a few ulp
RTOL, ATOL = 1e-5, 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("impl", ["f32", "stats_f32"])
def test_norm_matches_reference(kind, impl):
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    got = tl.norm_apply({k: torch.as_tensor(v) for k, v in p.items()},
                        torch.as_tensor(x), kind, impl=impl)
    want = jl.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    init = tl.norm_init(64, kind, torch.float32, "cpu", lead=(3,))
    assert sorted(init) == sorted(p)
    assert init["scale"].shape == (3, 64)


@pytest.mark.parametrize("dh,theta", [(64, 10000.0), (80, 1e6)])
def test_rope_matches_reference(dh, theta):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    got = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = _rng(2)
    d, ff = 32, 48
    p = {"wi": rng.standard_normal((d, ff)).astype(np.float32) / 6,
         "wo": rng.standard_normal((ff, d)).astype(np.float32) / 7}
    if act == "swiglu":
        p["wg"] = rng.standard_normal((d, ff)).astype(np.float32) / 6
    x = rng.standard_normal((2, 4, d)).astype(np.float32)
    got = tl.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x), act)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    init = tl.mlp_init(torch.Generator().manual_seed(0), d, ff, act,
                       torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("tied", [False, True])
def test_embed_and_head_match_reference(tied):
    rng = _rng(3)
    vpad = tl.pad_vocab(300)
    assert vpad == jl.pad_vocab(300) == 512
    table = rng.standard_normal((vpad, 16)).astype(np.float32)
    w = rng.standard_normal((16, vpad)).astype(np.float32)
    toks = rng.integers(0, 300, (2, 5))
    x = tl.embed_apply({"table": torch.as_tensor(table)},
                       torch.as_tensor(toks))
    np.testing.assert_array_equal(x.numpy(), table[toks])
    head = {"table": table} if tied else {"w": w}
    got = tl.logits_apply({k: torch.as_tensor(v) for k, v in head.items()},
                          x, tied=tied)
    want = jl.logits_apply({k: jnp.asarray(v) for k, v in head.items()},
                           jnp.asarray(table[toks]), tied=tied)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
