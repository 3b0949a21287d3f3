"""The port's threefry (``repro_torch.prng``) against ``jax.random`` in
non-partitionable mode, bit for bit: the integer streams, ``uniform``,
``normal``, ``exponential``, ``gamma``, ``loggamma``, ``dirichlet`` and
the labels ``choice`` draws from them, in f32 and bf16; and the XLA CPU
f32 functions the draws go through (``log``, ``log1p``, ``exp``,
``erf``, ``erfc``, ``ndtr``, ``rsqrt``, ``erf_inv``, glibc's ``powf``)
against ``jax.jit`` of the reference op on stratified samples: every
binade of the range, both sides of every branch point, and zeros,
subnormals, +-1, infinities and NaN. ``tests/sweep_torch_xla_math.py``
sweeps every f32 of the draws' ranges instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import prng, xla_samples

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread: these tests interleave torch
    and XLA work (see tests/test_torch_checkpoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """No gap is left: ``normal`` and ``exponential`` are bit-equal, the
    values whose ``w = -log1p(-u^2)`` lies past the erfinv polynomial's
    branch at w = 5 included."""
    jk, tk = _jkey(seed), _tkey(seed)
    n = 100_001
    assert np.array_equal(np.asarray(jax.random.normal(jk, (n,))),
                          _np(prng.normal(tk, n)))
    assert np.array_equal(np.asarray(jax.random.exponential(jk, (n,))),
                          _np(prng.exponential(tk, n)))


def test_erfinv_matches_xla_within_pinned_gap():
    """``erfinv_f32`` is XLA's ``erf_inv`` bit for bit on (-1, 1)."""
    x = np.linspace(-0.999999, 0.999999, 20_001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.array_equal(_np(prng.erfinv_f32(torch.as_tensor(x))), want)
    assert _np(prng.erfinv_f32(torch.tensor([1.0, -1.0]))).tolist() == [
        np.inf, -np.inf]


def test_seed_outside_int32_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31, device="cpu")


# ------------------------------------------------ gamma, dirichlet, choice
#
# JAX's Marsaglia-Tsang sampler, ported step for step: XLA's log, log1p
# and rsqrt (c = 1/3 * rsqrt(d)), glibc's powf for the boost below alpha
# 1, and the flush of a subnormal sample to zero (alpha 0.1).
GAMMA_ALPHAS = (0.1, 0.5, 1.0, 3.0)


@pytest.mark.parametrize("alpha", GAMMA_ALPHAS)
@pytest.mark.parametrize("seed,shape", [(0, (200, 62)), (7, (3, 5, 41))])
def test_gamma_and_loggamma_within_measured_gap(alpha, seed, shape):
    """No gap is left: both bit-equal at every alpha."""
    jk, tk = _jkey(seed), _tkey(seed)
    want_lg = np.asarray(jax.random.loggamma(jk, alpha, shape))
    got_lg = _np(prng.loggamma(tk, alpha, shape))
    want_g = np.asarray(jax.random.gamma(jk, alpha, shape))
    got_g = _np(prng.gamma(tk, alpha, shape))
    assert got_lg.shape == want_lg.shape == shape
    assert np.array_equal(got_lg, want_lg)
    assert np.array_equal(got_g, want_g)


def test_gamma_takes_a_tensor_of_alphas():
    """One alpha an element, broadcast to ``shape`` as JAX does."""
    alphas = np.array([0.2, 0.5, 1.0, 2.5, 7.0], np.float32)
    jk, tk = _jkey(3), _tkey(3)
    want = np.asarray(jax.random.gamma(jk, alphas, (40, 5)))
    got = _np(prng.gamma(tk, torch.as_tensor(alphas), (40, 5)))
    assert np.array_equal(got, want)
    assert np.all(got > 0)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0, 3.0])
def test_dirichlet_and_choice_with_p(alpha):
    """``dirichlet`` is bit-equal (XLA's exp, its sum over the classes in
    XLA's order: windows of 32 above 32 classes, and the flush of a
    subnormal probability), and so are the labels ``choice`` draws from
    it, one key a client as the Dirichlet branch draws them."""
    jk, tk = _jkey(3), _tkey(3)
    n, c, per = 300, 62, 50
    want = np.asarray(jax.random.dirichlet(jk, alpha * jnp.ones((c,)),
                                           (n,)))
    got = _np(prng.dirichlet(tk, torch.full((c,), alpha), (n,)))
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    want_y = np.asarray(jax.vmap(
        lambda k, p: jax.random.choice(k, c, (per,), p=p))(
            jax.random.split(jk, n), jnp.asarray(want)))
    got_y = _np(prng.choice(prng.split(tk, n), c, (per,),
                            p=torch.as_tensor(got)))
    assert got_y.shape == (n, per)
    assert np.array_equal(got_y, want_y)


@pytest.mark.parametrize("c", [2, 10, 17, 32, 33, 100, 300])
def test_dirichlet_sums_in_xla_order(c):
    """Class counts on both sides of 32, where XLA splits the sum into
    windows; alpha 0.1 puts subnormal probabilities in the rows."""
    want = np.asarray(jax.random.dirichlet(_jkey(5), 0.1 * jnp.ones((c,)),
                                           (64,)))
    got = _np(prng.dirichlet(_tkey(5), torch.full((c,), 0.1), (64,)))
    assert np.array_equal(got, want)
    x = np.random.default_rng(c).standard_normal((5, c)).astype(np.float32)
    assert np.array_equal(_np(prng.sum_last(torch.from_numpy(x))),
                          np.asarray(jax.jit(lambda v: jnp.sum(v, -1))(x)))


def test_choice_with_p_one_key_is_bit_equal():
    """On the same probabilities the inverse CDF is exact."""
    p = np.linspace(1.0, 10.0, 10).astype(np.float32)
    for seed in (0, 1):
        want = np.asarray(jax.random.choice(_jkey(seed), 10, (1000,),
                                            p=jnp.asarray(p)))
        got = _np(prng.choice(_tkey(seed), 10, (1000,),
                              p=torch.as_tensor(p)))
        assert np.array_equal(got, want)
    with pytest.raises(NotImplementedError):
        prng.choice(_tkey(0), 10, (3,), replace=False, p=torch.as_tensor(p))


def test_log_matches_xla_bit_for_bit():
    """``log_f32`` is XLA's CPU log op for op; ``torch.log`` is not."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(1e-6, 10, 100_000),
                        rng.uniform(1e-30, 1e30, 1000),
                        [0.0, -1.0, np.inf, np.nan, 1.0, 2.0 ** -126]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = _np(prng.log_f32(torch.as_tensor(x)))
    assert np.array_equal(got, want, equal_nan=True)
    assert np.mean(_np(torch.log(torch.as_tensor(x))) == want) < 0.97


# ------------------------------------------- XLA's CPU f32 functions
#
# Each case: about 2^20 f32 values, half uniform in bit pattern over the
# draws' range (so every binade alike) and half over the whole line, the
# 64 floats on each side of every branch point, and the specials; held
# bit for bit (signed zeros told apart, NaNs of any payload equal).

def _assert_bit_equal(got: np.ndarray, want: np.ndarray, x: np.ndarray):
    nan = np.isnan(got) & np.isnan(want)
    bad = (got.view(np.uint32) != want.view(np.uint32)) & ~nan
    assert not bad.any(), (int(bad.sum()), x[bad][:5], got[bad][:5],
                           want[bad][:5])


# the reference op of each function of ``xla_samples.FUNCTIONS``
XLA_FUNCTIONS = {"log1p": jnp.log1p, "exp": jnp.exp, "erf": jax.lax.erf,
                 "erfc": jax.lax.erfc, "ndtr": jax.scipy.special.ndtr,
                 "rsqrt": jax.lax.rsqrt, "erf_inv": jax.lax.erf_inv}


@pytest.mark.parametrize("name", sorted(xla_samples.FUNCTIONS))
def test_xla_f32_function_bit_equal(name):
    x = xla_samples.sample(name)
    want = np.asarray(jax.jit(XLA_FUNCTIONS[name])(x))
    port = getattr(prng, xla_samples.FUNCTIONS[name][0])
    _assert_bit_equal(_np(port(torch.from_numpy(x))), want, x)


@pytest.mark.parametrize("exponent", [None, 2.0, 10.0, 1.0 / 0.3])
def test_powf_bit_equal(exponent):
    """glibc's ``powf`` (the ``pow`` XLA's CPU code calls) on the gamma
    boost's domain: x in (0, 1], its ``1 / alpha`` exponent."""
    rng = np.random.default_rng(3)
    x = np.concatenate([xla_samples.bits_between(1e-30, 1.0, 1 << 19, rng),
                        1.0 - rng.random(1 << 19).astype(np.float32)])
    y = (np.full_like(x, exponent) if exponent is not None
         else (1.0 / rng.uniform(0.01, 1.0, x.size)).astype(np.float32))
    want = np.asarray(jax.jit(jnp.power)(x, y))
    got = _np(prng._powf(torch.from_numpy(x), torch.from_numpy(y)))
    _assert_bit_equal(got, want, x)


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c rounded once to f32 (to nearest, ties to even)."""
    from fractions import Fraction
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda q: (abs(Fraction(float(q)) - v),
                                    int(np.float32(q).view(np.uint32)) & 1))


def test_fma_f32_rounds_once_where_f64_lands_on_a_midpoint():
    """The last step of erf's denominator at x = 3.461441e-4: q x^2 + 1
    lies 1.3e-18 above 1 + 2^-24, so the f64 sum is the midpoint itself
    and rounds to 1 (ties to even) where the FMA gives 1 + 2^-23. XLA's
    erf there is the FMA's (and ``_fma_f64``, the draws' form, is not)."""
    q = np.uint32(1056879690).view(np.float32)
    x2 = np.uint32(872457907).view(np.float32)
    got = prng.fma_f32(torch.tensor([q]), float(x2), 1.0)
    assert got.item() == float(_fma_exact(q, x2, 1.0)) == 1.0 + 2.0 ** -23
    assert prng._fma_f64(torch.tensor([q]), float(x2), 1.0).item() == 1.0
    x = np.uint32(968194733).view(np.float32)
    assert np.array_equal(_np(prng.erf_f32(torch.tensor([x, -x]))),
                          np.asarray(jax.jit(jax.lax.erf)(
                              np.array([x, -x], np.float32))))
    rng = np.random.default_rng(8)
    a = rng.standard_normal(400).astype(np.float32)
    b = (rng.standard_normal(400) * 2.0 ** rng.integers(-30, 30, 400)
         ).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    got = _np(prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)))
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)


def test_markov_latent_step_is_the_jitted_reference_s():
    """``rho z + sqrt(1 - rho^2) xi`` as the reference's jitted round
    computes it: the constant folded into the draw (``normal_scaled``),
    rho z contracted into an FMA."""
    from repro.configs import ChannelConfig as JChannel
    from repro.core.channels import markov as jmarkov
    from repro_torch.configs import ChannelConfig
    from repro_torch.core.channels import markov
    n, key = 20_000, _jkey(7)
    carry = np.asarray(jax.random.normal(_jkey(5), (n,)))
    sel = np.arange(8)
    want = jax.jit(lambda c, k: jmarkov._step(
        c, JChannel(model="markov_fading", markov_rho=0.9), 8,
        jnp.asarray(sel), k, k)[0])(jnp.asarray(carry), key)
    got, _ = markov._step(torch.from_numpy(carry.copy()),
                          ChannelConfig(model="markov_fading",
                                        markov_rho=0.9), 8,
                          torch.from_numpy(sel), _tkey(7), _tkey(7))
    assert np.array_equal(_np(got), np.asarray(want))


def test_batched_keys_draw_as_vmap():
    """A batch of keys draws one row a key, as ``jax.vmap`` does."""
    jk, tk = _jkey(11), _tkey(11)
    jks = jax.random.split(jk, 6)
    tks = prng.split(tk, 6)
    assert np.array_equal(_words(jax.vmap(jax.random.split)(jks)),
                          _np(prng.split(tks)))
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (7,), 0, 62))(
            jks)), _np(prng.randint(tks, (7,), 0, 62)))
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 2)))(jks)),
        _np(prng.uniform(tks, (3, 2))))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (9,)))(jks))
    got = _np(prng.normal(tks, (9,)))
    assert got.shape == (6, 9)
    assert np.array_equal(got, want)


BF16_SAMPLERS = ("uniform", "normal", "gumbel")


def _bf16_words(x):
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("name", BF16_SAMPLERS)
@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (4099,)])
def test_bf16_draws_bit_equal(name, seed, shape):
    """bf16 ``uniform``, ``normal`` and ``gumbel``: one byte of the stream
    a value, every op rounded to bf16 as XLA's CPU backend rounds it; the
    words equal JAX's, odd sizes (a part-used last word) included."""
    want = getattr(jax.random, name)(_jkey(seed), shape, jnp.bfloat16)
    got = getattr(prng, name)(_tkey(seed), shape, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _bf16_words(want))


@pytest.mark.parametrize("name", BF16_SAMPLERS)
def test_bf16_draws_take_all_128_values_bit_equal(name):
    """A bf16 draw has 7 random mantissa bits: 128 values. A draw that
    holds every one of them is bit-equal to JAX's, so each value's
    erfinv and logs are; and a batch of keys draws as ``jax.vmap``."""
    want = _bf16_words(getattr(jax.random, name)(_jkey(3), (8192,),
                                                 jnp.bfloat16))
    got = getattr(prng, name)(_tkey(3), (8192,), dtype=torch.bfloat16)
    assert len(np.unique(want)) == 128
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)
    keys = jax.random.split(_jkey(4), 5)
    want = jax.vmap(lambda k: getattr(jax.random, name)(
        k, (3, 7), jnp.bfloat16))(keys)
    got = getattr(prng, name)(prng.split(_tkey(4), 5), (3, 7),
                              dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _bf16_words(want))


def test_bf16_uniform_in_a_range_bit_equal():
    want = jax.random.uniform(_jkey(5), (1001,), jnp.bfloat16, -3.0, 2.5)
    got = prng.uniform(_tkey(5), (1001,), -3.0, 2.5, dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _bf16_words(want))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_on_bf16_logits_draws_jax_indices(seed):
    """``jax.random.categorical`` draws its Gumbel in the logits' dtype and
    adds in it: on bf16 logits the indices equal JAX's (an f32 Gumbel
    added to the upcast logits picks other indices), for one key and a
    batch of keys; on f32 logits the f32 route."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((16, 512))).astype(np.float32)
    lb = jnp.asarray(logits, jnp.bfloat16)
    tb = torch.from_numpy(logits).to(torch.bfloat16)
    want = np.asarray(jax.random.categorical(_jkey(seed), lb))
    np.testing.assert_array_equal(prng.categorical(_tkey(seed), tb).numpy(),
                                  want)
    keys = jax.random.split(_jkey(seed), 16)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, lb))
    got = prng.categorical(prng.split(_tkey(seed), 16), tb)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.categorical(_jkey(seed), logits))
    got = prng.categorical(_tkey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
