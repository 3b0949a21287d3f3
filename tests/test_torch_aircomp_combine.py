"""The port's AirComp server combine against the reference.

``combine`` is held against the reference's ``combine``, both through
its oracle (``use_kernel=False``) and through its Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it), at that file's
shapes and more, in f32 and bf16, with the same rows and payload (from
numpy). On the CPU the kernel wrapper takes the plain route and never
launches.

Tolerances. Unique rows (what ``row_indices_from_coords`` draws): none
against the oracle: each element is theta + (y * inv) with the product
rounded to theta's dtype first, as written, on both sides. Against the
interpret-mode kernel the same holds in bf16, but in f32 XLA's CPU
backend contracts the kernel body's ``theta + y * inv`` into one fused
multiply-add, so about 6% of the elements differ by the product's
rounding: at most 2^-23 (|y inv| + |result|). Duplicate rows: the plain
versions add in the order of idx, so they agree; the CUDA kernel adds
with atomics in a varying order, so its stated tolerance (also applied
here) is one rounding of the element per extra add: 2^-23 of max|theta|
in f32, 2^-8 in bf16, times the largest multiplicity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels.aircomp_combine.ops import combine as jcombine
from repro_torch.kernels.aircomp_combine import kernel as tkernel
from repro_torch.kernels.aircomp_combine import ref as tref
from repro_torch.kernels.aircomp_combine.ops import combine

ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -8}


def _pair(a, dtype):
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.as_tensor(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.as_tensor(a)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _problem(rows, k_rows, dtype, seed, duplicates=False):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal(rows * 128)
    y = rng.standard_normal(k_rows * 128)
    if duplicates:
        idx = rng.integers(0, rows, k_rows)
    else:
        idx = rng.permutation(rows)[:k_rows]
    jt, tt = _pair(theta, dtype)
    jy, ty = _pair(y, dtype)
    idx = idx.astype(np.int32)
    return jt, tt, jy, ty, jnp.asarray(idx), torch.as_tensor(idx)


@pytest.mark.parametrize("rows,k_rows,r,beta", [(32, 8, 2, 0.5),
                                                (128, 128, 8, 3.0),
                                                (37, 1, 3, 0.7),
                                                (300, 90, 32, 12.5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_unique_rows_matches_reference_kernel(rows, k_rows, r, beta,
                                                      dtype):
    jt, tt, jy, ty, jidx, tidx = _problem(rows, k_rows, dtype, seed=rows)
    want = jcombine(jt, jy, jidx, r=r, beta=beta, use_kernel=False)
    want_kernel = _np(jcombine(jt, jy, jidx, r=r, beta=beta))
    theta_before = tt.clone()
    before = dict(tkernel.LAUNCHES)
    got = combine(tt, ty, tidx, r=r, beta=beta)
    assert tkernel.LAUNCHES == before
    assert torch.equal(tt, theta_before), "combine changed the caller's theta"
    assert got.shape == tt.shape and got.dtype == tt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), want_kernel)
    else:
        prod = np.zeros_like(want_kernel).reshape(rows, 128)
        prod[np.asarray(jidx)] = np.abs(_np(ty).reshape(k_rows, 128)
                                        / np.float32(r * beta))
        bound = 2.0 ** -23 * (prod.reshape(-1) + np.abs(want_kernel))
        assert np.all(np.abs(_np(got) - want_kernel) <= bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_duplicate_rows_accumulate_like_reference(dtype):
    rows, k_rows = 16, 64
    jt, tt, jy, ty, jidx, tidx = _problem(rows, k_rows, dtype, seed=9,
                                          duplicates=True)
    mult = int(np.bincount(np.asarray(jidx), minlength=rows).max())
    assert mult >= 3
    want = _np(jcombine(jt, jy, jidx, r=4, beta=0.25, use_kernel=False))
    got = _np(combine(tt, ty, tidx, r=4, beta=0.25))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=mult * ULP[dtype] * np.abs(want).max())
    # every duplicate's add landed: the row sums moved by the payload
    upd = np.zeros((rows, 128), np.float32)
    np.add.at(upd, np.asarray(jidx), _np(ty).reshape(k_rows, 128) / 1.0)
    moved = got.reshape(rows, 128) - _np(tt).reshape(rows, 128)
    np.testing.assert_allclose(moved, upd, rtol=0,
                               atol=4 * mult * ULP[dtype]
                               * np.abs(want).max())


def test_tensor_beta_matches_reference():
    jt, tt, jy, ty, jidx, tidx = _problem(64, 20, "float32", seed=2)
    beta = np.float32(0.3141592)
    want = jcombine(jt, jy, jidx, r=32, beta=jnp.asarray(beta),
                    use_kernel=False)
    got = combine(tt, ty, tidx, r=32, beta=torch.tensor(beta))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_kernel_wrapper_updates_in_place_and_ref_clones():
    _, tt, _, ty, _, tidx = _problem(20, 5, "float32", seed=4)
    rows = tt.reshape(20, 128)
    plain = tref.aircomp_combine_ref(rows, ty.reshape(5, 128), tidx, 0.5)
    assert not torch.equal(plain, rows)
    out = tkernel.aircomp_combine(rows, ty.reshape(5, 128), tidx, 0.5)
    assert out is rows and torch.equal(rows, plain)


def test_plain_entry_point_and_kernel_route_agree():
    _, tt, _, ty, _, tidx = _problem(50, 17, "float32", seed=6)
    assert torch.equal(combine(tt, ty, tidx, 4, 2.0),
                       combine(tt, ty, tidx, 4, 2.0, use_kernel=False))


def test_refusals():
    with pytest.raises(ValueError, match="multiple of 128"):
        combine(torch.zeros(200), torch.zeros(128),
                torch.zeros(1, dtype=torch.int32), 1, 1.0)
    with pytest.raises(ValueError, match="k_rows"):
        tkernel.aircomp_combine(torch.zeros((4, 128)), torch.zeros((2, 128)),
                                torch.zeros(1, dtype=torch.int32), 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_rounding_of_inv_equals_scalar_like(dtype):
    """The CUDA route takes 1/(r beta) by value, rounded to y's dtype on
    the host; that rounding must be ``scalar_like``'s (the plain route's):
    over 400 numbers from a seed (normals over 70 decades, f32 values from
    random bit patterns, halfway cases of bf16) every value and sign
    agree."""
    from repro_torch.kernels._route import host_scalar, scalar_like
    tdtype = getattr(torch, dtype)
    rng = np.random.default_rng(16)
    values = list(rng.standard_normal(150)
                  * 10.0 ** rng.integers(-40, 30, 150))
    bits = rng.integers(0, 2 ** 32, 250, dtype=np.uint64).astype(np.uint32)
    f32 = bits.view(np.float32)
    values += [float(v) for v in f32[np.isfinite(f32)]]
    # halfway between two bf16 values, below and above
    values += [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
               1.0 / (32 * 0.05), 0.0, -0.0, float("inf")]
    assert len(values) >= 350
    for v in values:
        got = host_scalar(v, tdtype)
        want = float(scalar_like(v, torch.empty(1, dtype=tdtype)))
        assert got == want and np.signbit(got) == np.signbit(want), v
