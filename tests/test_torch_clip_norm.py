"""The port's global l2-norm clip against the reference.

``clip_flat`` (pad d to 128-lane rows, clip, cut the pad) is held against
the reference's ``clip_flat`` through its two Pallas kernels (interpret
mode, as ``tests/test_kernels.py`` runs them), at that file's shapes and
clips, in f32 and bf16. On the CPU the kernel wrapper takes the plain
route and never launches.

Tolerances: the norm within rtol 1e-6 (f32 sums of squares in another
order); the f32 output within rtol 1e-6 (the scale is formed from that
norm). In bf16 the output is the f32 product rounded to bf16, so a scale
one f32 ulp apart can move an element by one bf16 ulp (2^-8 relative)
where the product sits on a rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels.clip_norm.ops import clip_flat as jclip_flat
from repro_torch.kernels.clip_norm import kernel as tkernel
from repro_torch.kernels.clip_norm import ref as tref
from repro_torch.kernels.clip_norm.ops import clip_flat

RTOL = 1e-6
BF16_ULP = 2.0 ** -8


def _x(n, dtype, seed):
    x = np.asarray(3.0 * np.random.default_rng(seed).standard_normal(n),
                   np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.as_tensor(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.as_tensor(x)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("n", [100, 128 * 7, 5000])
@pytest.mark.parametrize("clip", [0.5, 10.0, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_flat_matches_reference_kernels(n, clip, dtype):
    jx, tx = _x(n, dtype, seed=n)
    jout, jnrm = jclip_flat(jx, clip)
    before = dict(tkernel.LAUNCHES)
    out, nrm = clip_flat(tx, clip)
    assert tkernel.LAUNCHES == before
    assert out.shape == (n,) and out.dtype == tx.dtype
    assert nrm.dtype == torch.float32 and nrm.ndim == 0
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=RTOL)
    got, want = _np(out), _np(jout)
    if dtype == "float32" or clip == 1e6:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
        assert np.mean(got == want) >= 0.99


def test_clip_flat_unbinding_clip_is_the_identity():
    _, tx = _x(300, "float32", seed=1)
    out, nrm = clip_flat(tx, 1e6)
    assert torch.equal(out, tx)
    assert float(nrm) == pytest.approx(float(torch.linalg.vector_norm(tx)),
                                       rel=RTOL)


def test_zero_vector_keeps_a_unit_scale():
    """max(||x||, 1e-12) keeps the scale finite: a zero vector stays
    zero, with norm 0."""
    out, nrm = tkernel.clip_norm(torch.zeros((3, 128)), 0.5)
    assert float(nrm) == 0.0 and torch.equal(out, torch.zeros((3, 128)))


def test_nan_norm_propagates_like_the_reference():
    x = torch.ones((2, 128))
    x[1, 5] = float("nan")
    out, nrm = tref.clip_norm_ref(x, 0.5)
    jout, jnrm = jclip_flat(jnp.asarray(x.numpy().reshape(-1)), 0.5)
    assert np.isnan(float(nrm)) and np.isnan(float(jnrm))
    assert torch.isnan(out).all() and np.isnan(np.asarray(jout)).all()


def test_plain_entry_point_and_kernel_route_agree():
    _, tx = _x(1000, "float32", seed=3)
    a, na = clip_flat(tx, 0.7)
    b, nb = clip_flat(tx, 0.7, use_kernel=False)
    assert torch.equal(a, b) and torch.equal(na, nb)


def test_wrapper_refuses_rows_that_are_not_128_lanes():
    with pytest.raises(ValueError, match="128"):
        tkernel.clip_norm(torch.zeros((4, 64)), 1.0)
