"""The port's rand-k row gather against the reference.

``gather_rows`` is held against the reference's ``gather_rows`` through
its Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs it),
at that file's shapes, in f32 and bf16, with the same row indices (from
numpy); ``row_indices_from_coords`` against the reference's draw. On the
CPU the kernel wrapper takes the plain route and never launches.

Tolerance: none (bit-identical). The scale is cast to delta's dtype
first on both sides and each element is one product, rounded once (in
bf16 the product of two bf16 values is exact in f32, so its one rounding
to bf16 is the same on both sides). The card's by-value route for a
number scale (``_route.host_scalar`` through ``_route.scalar_arg``) and
its offset-view route are held here
through their plain equivalents on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels.randk_gather.ops import gather_rows as jgather_rows
from repro.kernels.randk_gather.ops import \
    row_indices_from_coords as jrow_indices
from repro_torch import prng
from repro_torch.kernels.randk_gather import kernel as tkernel
from repro_torch.kernels.randk_gather.ops import (gather_rows,
                                                  row_indices_from_coords)


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _delta(rows, dtype, seed):
    x = np.asarray(np.random.default_rng(seed).standard_normal(rows * 128),
                   np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.as_tensor(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.as_tensor(x)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("rows,k_rows", [(64, 16), (256, 256), (512, 96),
                                         (37, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_reference_kernel(rows, k_rows, dtype):
    jd, td = _delta(rows, dtype, seed=rows + k_rows)
    idx = np.random.default_rng(k_rows).permutation(rows)[:k_rows]
    idx = idx.astype(np.int32)
    want = jgather_rows(jd, jnp.asarray(idx), 1.7)
    before = dict(tkernel.LAUNCHES)
    got = gather_rows(td, torch.as_tensor(idx), 1.7)
    assert tkernel.LAUNCHES == before
    assert got.shape == (k_rows * 128,) and got.dtype == td.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_scale_is_cast_to_the_data_dtype(dtype):
    """A traced scale (beta / |h_i| as an f32 array) is cast to delta's
    dtype before the product, as the reference's kernel casts it."""
    jd, td = _delta(64, dtype, seed=5)
    idx = np.arange(0, 64, 3, dtype=np.int32)
    scale = np.float32(0.123456789)
    want = jgather_rows(jd, jnp.asarray(idx), jnp.asarray(scale))
    got = gather_rows(td, torch.as_tensor(idx), torch.tensor(scale))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("seed,d,k", [(0, 64 * 128, 16 * 128),
                                      (3, 512 * 128, 96 * 128 + 77),
                                      (7, 100 * 128, 50),
                                      (11, 9_222_912 // 128 * 128 // 64,
                                       2_766_857 // 64)])
def test_row_indices_from_coords_matches_reference(seed, d, k):
    want = np.asarray(jrow_indices(jax.random.PRNGKey(seed), d, k))
    got = row_indices_from_coords(prng.PRNGKey(seed, "cpu"), d, k)
    assert got.dtype == torch.int32
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (max(k // 128, 1),)
    assert torch.unique(got).numel() == got.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_of_an_offset_view_matches_reference_kernel(dtype):
    """A flat delta that starts one element into its buffer (off 16-byte
    alignment, the card's scalar-load path) gathers the same bits as the
    reference's Pallas kernel on the same values."""
    rows, k_rows = 96, 37
    jd, td = _delta(rows, dtype, seed=21)
    buf = torch.empty((rows * 128 + 1,), dtype=td.dtype)
    view = buf[1:]
    view.copy_(td)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    idx = np.random.default_rng(21).permutation(rows)[:k_rows]
    idx = idx.astype(np.int32)
    want = jgather_rows(jd, jnp.asarray(idx), 0.05 / 0.015)
    got = gather_rows(view, torch.as_tensor(idx), 0.05 / 0.015)
    np.testing.assert_array_equal(_np(got), _np(want))


# scales that round apart in f32 and bf16: bf16 ties (to even, down and
# up), a value inexact in f32, beta/|h| of the kernel API, a negative tie;
# and past f32's range (beta/|h_i| of a gain near 0): inf of its sign
@pytest.mark.parametrize("value", [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                                   0.05 / 0.015, 0.05 / 0.02,
                                   -(1.0 + 2.0 ** -8), 1e39, -1e39])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_number_and_tensor_scales_give_equal_bits(dtype, value):
    """The card takes a number scale by value, rounded on the host by
    ``host_scalar``, and a tensor scale cast on the card, as
    ``scalar_like`` casts it: the product in f32 of delta and the rounded
    scale, rounded once, is the reference's for both."""
    from repro_torch.kernels._route import host_scalar
    jd, td = _delta(64, dtype, seed=22)
    idx = np.arange(1, 64, 5, dtype=np.int32)
    tidx = torch.as_tensor(idx)
    want = _np(jgather_rows(jd, jnp.asarray(idx), value))
    by_number = gather_rows(td, tidx, value)
    by_tensor = gather_rows(td, tidx, torch.tensor(value))
    rows = td.reshape(-1, 128)
    by_value = (torch.index_select(rows, 0, tidx).float()
                * host_scalar(value, td.dtype)).to(td.dtype).reshape(-1)
    for got in (by_number, by_tensor, by_value):
        np.testing.assert_array_equal(_np(got), want)


# past f32's range (the scale is beta/|h_i|, so a gain near 0 gives one),
# just below the halfway point to 2^128 (rounds to f32's largest value)
# and just above it (rounds to inf)
@pytest.mark.parametrize("value", [1e39, -1e39, 3.40282356e38,
                                   3.4028236e38, -3.4028236e38])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_rounding_saturates_as_scalar_like(dtype, value):
    """A number past f32's range is inf of its sign on the card's
    by-value route and on the plain route, as the reference's cast gives
    it; one that rounds to f32's largest value keeps it in f32."""
    from repro_torch.kernels._route import host_scalar, scalar_like
    tdtype = getattr(torch, dtype)
    got = host_scalar(value, tdtype)
    want = float(scalar_like(value, torch.empty(1, dtype=tdtype)))
    assert got == want and np.signbit(got) == np.signbit(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scalar_arg_passes_by_value_or_pointer(dtype):
    """A number goes by value, rounded to the data's dtype; a tensor of
    the data's dtype by its own pointer; an f32 tensor by its own pointer
    where the kernel rounds f32 itself (flagged when the data is bf16),
    else converted; any other dtype converted; two values refused."""
    from repro_torch.kernels._route import host_scalar, scalar_arg
    tdtype = getattr(torch, dtype)
    t = torch.zeros((2, 128), dtype=tdtype)
    value = 0.05 / 0.015
    assert scalar_arg(value, t, "s") == (None, 0, host_scalar(value, tdtype))
    same = torch.tensor([value], dtype=tdtype)
    assert scalar_arg(same, t, "s") == (same, 0, 0.0)
    f32 = torch.tensor(value)
    assert scalar_arg(f32, t, "s", f32_ok=True) == (
        f32, int(tdtype != torch.float32), 0.0)
    s, is_f32, _ = scalar_arg(f32, t, "s")
    assert is_f32 == 0 and s.dtype == tdtype
    assert (s is f32) == (tdtype == torch.float32)
    s, is_f32, _ = scalar_arg(f32.double(), t, "s", f32_ok=True)
    assert is_f32 == 0 and s.dtype == tdtype
    assert float(s) == host_scalar(value, tdtype)
    with pytest.raises(ValueError, match="s must hold one value"):
        scalar_arg(torch.ones(2), t, "s")


def test_plain_entry_point_and_kernel_route_agree():
    _, td = _delta(40, "float32", seed=1)
    idx = torch.tensor([3, 0, 39, 7], dtype=torch.int32)
    assert torch.equal(gather_rows(td, idx, 2.5),
                       gather_rows(td, idx, 2.5, use_kernel=False))


def test_refusals():
    with pytest.raises(ValueError, match="multiple of 128"):
        gather_rows(torch.zeros(200), torch.zeros(1, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="128"):
        tkernel.randk_gather(torch.zeros((4, 64)),
                             torch.zeros(1, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="k_rows"):
        tkernel.randk_gather(torch.zeros((4, 128)),
                             torch.zeros((1, 1), dtype=torch.int32), 1.0)
