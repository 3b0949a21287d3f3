"""The fused PFELS transmit in the port against the reference.

The plain versions of the two kernels (``client_sumsq_ref``,
``fused_combine_ref``) are held against the reference's Pallas kernels
(interpret mode, as the reference's own tests run them off-TPU) and its
ref; then ``fused_pipeline`` / ``fused_transmit`` against the
reference's; then the port's fused path against its own unfused path.
On the CPU the kernel wrappers take the plain route and never launch."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.core import randk as jrandk
from repro.kernels.pfels_transmit import kernel as jkernel
from repro.kernels.pfels_transmit import ops as jops
from repro.kernels.pfels_transmit import ref as jref
from repro_torch import prng
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.pfels_transmit import kernel as tkernel
from repro_torch.kernels.pfels_transmit import ops as tops
from repro_torch.kernels.pfels_transmit import ref as tref

# (r, d, M): ragged d (not a multiple of 128), r in {1, 3, 4}, M in {1, 4}
SHAPES = [(1, 4100, 1), (3, 4100, 4), (4, 37, 1), (4, 301, 4), (3, 128, 1)]
# f32 sums over r clients and d columns in another order than the
# reference's: 1e-5 relative is ~100 ulp
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _inputs(r, d, m, seed=0, drop=True):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    u = f(0.1 * rng.standard_normal((r, d)))
    mask = f(rng.random(d) < 0.3)
    z = f(rng.standard_normal(d)) * mask
    gains = f(1e-3 + 0.1 * rng.random((r, m)))
    tx = f(1.0 + 100.0 * rng.random(r))
    txm = np.ones(r, np.float32)
    if drop and r > 1:
        txm[r // 2] = 0.0          # a dropped client
    return u, mask, z, gains, tx, txm


def _t(a):
    return torch.as_tensor(np.array(a))


def _pad(a, d_pad):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, d_pad - a.shape[-1])])


def _assert_y_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("r,d,m", SHAPES)
def test_client_sumsq_plain_matches_reference_kernel(r, d, m):
    u = _inputs(r, d, m)[0]
    d_pad = -(-d // 128) * 128
    want_kernel = np.asarray(jkernel.client_sumsq(
        jnp.asarray(_pad(u, d_pad)), block=128, interpret=True))[:, 0]
    want_ref = np.asarray(jref.client_sumsq_ref(jnp.asarray(u)))
    got = tref.client_sumsq_ref(_t(u)).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL)
    assert np.array_equal(tkernel.client_sumsq(_t(u)).numpy(), got)


@pytest.mark.parametrize("r,d,m", SHAPES)
def test_fused_combine_plain_matches_reference_kernel(r, d, m):
    u, mask, z, gains, tx, txm = _inputs(r, d, m)
    d_pad = -(-d // 128) * 128
    y_j, e_j = jkernel.fused_combine(
        jnp.asarray(_pad(u, d_pad)), jnp.asarray(_pad(mask[None], d_pad)),
        jnp.asarray(_pad(z[None], d_pad)), jnp.asarray(gains),
        jnp.asarray(tx[:, None]), jnp.asarray(txm[:, None]), block=128,
        interpret=True)
    y_t, e_t = tref.fused_combine_ref(*map(_t, (u, mask, z, gains, tx,
                                                txm)))
    _assert_y_close(y_t.numpy(), np.asarray(y_j)[0, :d])
    np.testing.assert_allclose(float(e_t), float(e_j[0, 0]), rtol=RTOL)
    # the dense reference formulation agrees too
    rx_eff, tx_sq = jref.masked_coeffs(
        jnp.asarray(tx), jnp.asarray(gains.sum(1) * tx), jnp.asarray(txm))
    y_r, e_r = jref.pfels_transmit_ref(jnp.asarray(u), jnp.asarray(mask),
                                       jnp.asarray(z), rx_eff, tx_sq)
    _assert_y_close(y_t.numpy(), np.asarray(y_r))
    np.testing.assert_allclose(float(e_t), float(e_r), rtol=RTOL)
    y_w, e_w = tkernel.fused_combine(*map(_t, (u, mask, z, gains, tx, txm)))
    assert torch.equal(y_w, y_t) and torch.equal(e_w, e_t)


def _transmit_problem(r, d, k, m, seed):
    u = _inputs(r, d, m, seed)[0]
    rng = np.random.default_rng(seed + 100)
    gains = np.asarray(1e-3 + 0.1 * rng.random((r, m)), np.float32)
    if m == 1:
        gains = gains[:, 0]
    jkey = jax.random.PRNGKey(seed)
    idx = np.asarray(jrandk.sample_indices(jax.random.fold_in(jkey, 2), d, k))
    noise_key = jax.random.fold_in(jkey, 3)
    return u, gains, idx, noise_key


@pytest.mark.parametrize("r,d,m", SHAPES)
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_transmit_matches_reference(r, d, m, clip, masked):
    k = max(1, (3 * d) // 10)
    u, gains, idx, nk = _transmit_problem(r, d, k, m, seed=r + d)
    tx_mask = None
    if masked:
        tx_mask = np.ones(r, np.float32)
        tx_mask[0] = 0.0
    beta, sigma0 = 0.7, 0.3
    kw = dict(d=d, sigma0=sigma0, r=r, clip=clip)
    dh_j, e_j, y_j = jops.fused_transmit(
        jnp.asarray(u), jnp.asarray(idx), jnp.asarray(gains), beta, nk,
        tx_mask=None if tx_mask is None else jnp.asarray(tx_mask), **kw)
    t_mask = None if tx_mask is None else _t(tx_mask)
    beta_t = torch.tensor(beta, dtype=torch.float32)
    dh_t, e_t, y_t = tops.fused_transmit(
        _t(u), _t(idx).long(), _t(gains), beta_t,
        prng.key_from_words(np.asarray(nk), "cpu"), tx_mask=t_mask, **kw)
    # the noise matches to the normal gap (<= 3 ulp), the rest to RTOL
    _assert_y_close(dh_t.numpy(), np.asarray(dh_j))
    _assert_y_close(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)

    # the plain dense formulation of the same pipeline (use_kernel=False)
    dh_p, e_p, y_p = tops.fused_transmit(
        _t(u), _t(idx).long(), _t(gains), beta_t,
        prng.key_from_words(np.asarray(nk), "cpu"), tx_mask=t_mask,
        use_kernel=False, **kw)
    np.testing.assert_allclose(dh_p.numpy(), dh_t.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(e_p), float(e_t), rtol=1e-5)

    if m == 1:
        # the port's fused path against its own unfused path, with the
        # tolerance the reference holds itself to
        dh_u, e_u, y_u = tagg.aircomp_aggregate(
            _t(u), _t(idx).long(), _t(gains), beta_t,
            prng.key_from_words(np.asarray(nk), "cpu"), tx_mask=t_mask,
            **kw)
        np.testing.assert_allclose(dh_t.numpy(), dh_u.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(e_t), float(e_u), rtol=1e-5)
        np.testing.assert_allclose(y_t.numpy(), y_u.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_pipeline_matches_reference(clip):
    r, d, m = 4, 4100, 4
    u, mask, z, _, _, txm = _inputs(r, d, m, seed=11)
    gains = _inputs(r, d, m, seed=12)[3]
    beta = 2.5
    y_j, e_j = jops.fused_pipeline(
        jnp.asarray(u), jnp.asarray(mask), jnp.asarray(z), jnp.asarray(gains),
        beta, clip=clip, tx_mask=jnp.asarray(txm))
    y_t, e_t = tops.fused_pipeline(
        _t(u), _t(mask), _t(z), _t(gains), torch.tensor(beta), clip=clip,
        tx_mask=_t(txm))
    _assert_y_close(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=RTOL)


def test_noise_draw_and_mask_match_reference():
    d, k = 500, 37
    jkey = jax.random.PRNGKey(4)
    idx = jrandk.sample_indices(jkey, d, k)
    nk = jax.random.fold_in(jkey, 9)
    m_j, z_j = jref.dense_noise_and_mask(idx, nk, 0.9, d)
    m_t, z_t = tref.dense_noise_and_mask(
        _t(np.asarray(idx)).long(), prng.key_from_words(np.asarray(nk),
                                                        "cpu"), 0.9, d)
    assert np.array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=5e-7)


def test_launch_counters_stay_zero_on_cpu():
    tkernel.reset_launch_counts()
    u, mask, z, gains, tx, txm = map(_t, _inputs(3, 300, 1))
    tkernel.client_sumsq(u)
    tkernel.fused_combine(u, mask, z, gains, tx, txm)
    tops.fused_pipeline(u, mask, z, gains[:, 0], torch.tensor(1.0),
                        clip=0.1)
    assert tkernel.LAUNCHES == {"client_sumsq": 0, "fused_combine": 0}


def test_wrappers_refuse_other_devices():
    # meta is a route of its own (shapes only; tests/test_torch_dryrun.py)
    u = types.SimpleNamespace(ndim=2, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        tkernel.client_sumsq(u)
    with pytest.raises(ValueError, match="several devices"):
        tkernel.fused_combine(torch.zeros(2, 8), torch.zeros(8, device="meta"),
                              torch.zeros(8), torch.zeros(2, 1),
                              torch.zeros(2), torch.zeros(2))
