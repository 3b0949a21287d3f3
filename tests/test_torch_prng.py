"""The port's threefry (``repro_torch.prng``) against ``jax.random`` in
non-partitionable mode: the integer streams and ``uniform`` are
bit-equal; ``normal`` and ``exponential`` are within a pinned gap (the
port's ``torch.log1p`` differs from XLA's in the last bit for some
inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(seed):
    return prng.PRNGKey(seed, device="cpu")


def _np(t):
    return t.cpu().numpy()


def _words(jkey):
    return np.asarray(jkey).astype(np.int64)


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_equal(seed):
    jk, tk = _jkey(seed), _tkey(seed)
    assert np.array_equal(_words(jk), _np(tk))
    for n in (1, 2, 3, 7, 64):
        assert np.array_equal(_words(jax.random.split(jk, n)),
                              _np(prng.split(tk, n)))
    for data in (0, 1, 0x5047, 0x4348, 123456789):
        assert np.array_equal(_words(jax.random.fold_in(jk, data)),
                              _np(prng.fold_in(tk, data)))
    # the vmapped fold of the bank's cohort lanes
    sel = np.array([3, 0, 17, 999, 5], np.int32)
    want = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(sel))
    assert np.array_equal(_words(want),
                          _np(prng.fold_in(tk, torch.as_tensor(sel))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 5, 1001])
def test_bits_uniform_randint_bit_equal(seed, n):
    jk, tk = _jkey(seed), _tkey(seed)
    assert np.array_equal(_words(jax.random.bits(jk, (n,))),
                          _np(prng.bits(tk, n)))
    assert np.array_equal(np.asarray(jax.random.uniform(jk, (n,))),
                          _np(prng.uniform(tk, n)))
    # a range other than [0, 1): XLA fuses the affine map into an FMA
    assert np.array_equal(
        np.asarray(jax.random.uniform(jk, (n,), minval=2.0, maxval=15.0)),
        _np(prng.uniform(tk, n, 2.0, 15.0)))
    for lo, hi in ((0, 10), (0, 20), (3, 2 ** 31 - 1), (-5, 70000)):
        assert np.array_equal(np.asarray(jax.random.randint(jk, (n,), lo, hi)),
                              _np(prng.randint(tk, n, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("n", [1, 20, 1000, 26_122])
def test_permutation_and_choice_bit_equal(seed, n):
    jk, tk = _jkey(seed), _tkey(seed)
    assert np.array_equal(np.asarray(jax.random.permutation(jk, n)),
                          _np(prng.permutation(tk, n)))
    r = min(n, 32)
    assert np.array_equal(
        np.asarray(jax.random.choice(jk, n, (r,), replace=False)),
        _np(prng.choice(tk, n, (r,), replace=False)))


def test_chunked_generator_keeps_the_counter_pairing(monkeypatch):
    """A large draw is hashed in chunks; each chunk must keep JAX's pairing
    of counter i with counter i + ceil(n/2), the odd tail included."""
    tk, jk = _tkey(9), _jkey(9)
    for n in (999, 1000):
        whole = _np(prng.bits(tk, n))
        monkeypatch.setattr(prng, "CHUNK", 7)
        assert np.array_equal(_np(prng.bits(tk, n)), whole)
        assert np.array_equal(_np(prng.normal(tk, n)),
                              np.asarray(prng.normal(tk, n)))
        monkeypatch.undo()
        assert np.array_equal(whole, _words(jax.random.bits(jk, (n,))))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_and_exponential_within_pinned_gap(seed):
    """Pinned gap: ``normal`` is at least 98% bit-equal and all but a
    1e-4 fraction within 3 ulp; the rare value whose
    ``w = -log1p(-u^2)`` lands on the other side of the erfinv
    polynomial's branch at w = 5 may differ by up to 1e-3.
    ``exponential`` is at least 90% bit-equal and within 1 ulp."""
    jk, tk = _jkey(seed), _tkey(seed)
    n = 100_001
    want = np.asarray(jax.random.normal(jk, (n,)))
    got = _np(prng.normal(tk, n))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert np.mean(got == want) >= 0.98
    assert np.mean(ulps <= 3) >= 1 - 1e-4
    assert np.abs(got - want).max() <= 1e-3

    want = np.asarray(jax.random.exponential(jk, (n,)))
    got = _np(prng.exponential(tk, n))
    assert np.mean(got == want) >= 0.90
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


def test_erfinv_matches_xla_within_pinned_gap():
    x = np.linspace(-0.999999, 0.999999, 20_001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = _np(prng.erfinv_f32(torch.as_tensor(x)))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert np.all(ulps <= 3), ulps.max()
    assert _np(prng.erfinv_f32(torch.tensor([1.0, -1.0]))).tolist() == [
        np.inf, -np.inf]


def test_seed_outside_int32_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31, device="cpu")
