"""The port's CUDA kernels on the card: each against its plain torch
version, bit-identical run to run, counted, and refusing what it does not
take. Every test needs a CUDA device and skips without one; this file
imports neither JAX nor the reference, so it runs on a GPU machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch import prng
from repro_torch.core import aggregation
from repro_torch.kernels.pfels_transmit import kernel, ops, ref

# (r, d, M): ragged d, r in {1, 3, 32}, M in {1, 4}
SHAPES = [(1, 4100, 1), (3, 4100, 4), (4, 37, 1), (32, 100_003, 1),
          (5, 8192 * 3 + 1, 4)]
# f32 sums in another order than the plain version's: ~100 ulp
RTOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(r, d, m, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    u = 0.1 * torch.randn((r, d), generator=g, device=device)
    mask = (torch.rand((d,), generator=g, device=device) < 0.3).float()
    z = torch.randn((d,), generator=g, device=device) * mask
    gains = 1e-3 + 0.1 * torch.rand((r, m), generator=g, device=device)
    tx = 1.0 + 100.0 * torch.rand((r,), generator=g, device=device)
    txm = torch.ones((r,), device=device)
    if r > 1:
        txm[r // 2] = 0.0            # a dropped client
    return u, mask, z, gains, tx, txm


def _assert_y_close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("r,d,m", SHAPES)
def test_kernels_match_plain_and_are_deterministic(cuda, r, d, m):
    args = _inputs(r, d, m, cuda)
    before = dict(kernel.LAUNCHES)
    s1, s2 = kernel.client_sumsq(args[0]), kernel.client_sumsq(args[0])
    (y1, e1), (y2, e2) = kernel.fused_combine(*args), \
        kernel.fused_combine(*args)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["client_sumsq"] == before["client_sumsq"] + 2
    assert kernel.LAUNCHES["fused_combine"] == before["fused_combine"] + 2
    torch.testing.assert_close(s1, ref.client_sumsq_ref(args[0]),
                               rtol=RTOL, atol=0.0)
    y_p, e_p = ref.fused_combine_ref(*args)
    _assert_y_close(y1, y_p)
    torch.testing.assert_close(e1, e_p, rtol=RTOL, atol=0.0)
    assert torch.equal(s1, s2) and torch.equal(y1, y2) and torch.equal(e1, e2)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_fused_transmit_on_card_matches_unfused(cuda, clip):
    r, d, k = 8, 50_001, 15_000
    u = _inputs(r, d, 1, cuda, seed=3)[0]
    key = prng.PRNGKey(5, cuda)
    idx = prng.permutation(prng.fold_in(key, 1), d)[:k]
    gains = 1e-3 + 0.1 * prng.uniform(prng.fold_in(key, 2), (r,))
    beta = torch.tensor(3.0, device=cuda)
    nk = prng.fold_in(key, 3)
    kw = dict(d=d, sigma0=0.5, r=r, clip=clip)
    dh_f, e_f, y_f = ops.fused_transmit(u, idx, gains, beta, nk, **kw)
    dh_u, e_u, y_u = aggregation.aircomp_aggregate(u, idx, gains, beta, nk,
                                                   **kw)
    torch.testing.assert_close(dh_f, dh_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(e_f, e_u, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(y_f, y_u, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    u, mask, z, gains, tx, txm = _inputs(3, 1000, 1, cuda)
    with pytest.raises(TypeError, match="float32"):
        kernel.client_sumsq(u.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.client_sumsq(u.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        kernel.fused_combine(u, mask[:-1], z, gains, tx, txm)
    with pytest.raises(ValueError, match="several devices"):
        kernel.fused_combine(u, mask.cpu(), z, gains, tx, txm)
