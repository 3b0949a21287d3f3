"""The port's rand-k row gather against the reference.

``gather_rows`` is held against the reference's ``gather_rows`` through
its Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs it),
at that file's shapes, in f32 and bf16, with the same row indices (from
numpy); ``row_indices_from_coords`` against the reference's draw. On the
CPU the kernel wrapper takes the plain route and never launches.

Tolerance: none. The scale is cast to delta's dtype first on both sides
and each element is one product, rounded once (in bf16 the product of two
bf16 values is exact in f32, so its one rounding to bf16 is the same on
both sides).
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
