"""The port's SSD chunk scan and Mamba2 block against the JAX reference on
the CPU: ``kernels/ssd_scan`` (whose CPU route is the plain version
``ssd_chunked``) against the reference's ``ssd_chunked`` and its Pallas
``ssd_scan`` in interpret mode; the emulation of the card's bf16 route
(``ref.split_bf16_route``) against both and against the plain version,
within the bound derived from its split operands; then ``mamba_train`` /
``mamba_decode`` with the weights carried across by
``repro_torch.convert``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced
from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_pallas
from repro.models import mamba2 as jm
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.ssd_scan import kernel as t_kernel
from repro_torch.kernels.ssd_scan import ops as t_ops
from repro_torch.kernels.ssd_scan import ref as t_ref
from repro_torch.models import mamba2 as tm

# f32 sums in another order (XLA vs ATen einsums, a sequential vs a
# blocked inter-chunk recurrence): a few ulp of the largest value
RTOL, ATOL = 2e-5, 2e-5


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _inputs(b, s, h, p, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)
                  ).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) / 4).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) / 4).astype(np.float32)
    if dtype != np.float32:     # bf16 x, B, C, rounded by JAX
        x, bm, cm = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16))
                     for t in (x, bm, cm))
    return x, dt, a, bm, cm


def _t(a):
    return convert.tensor_from_numpy(a, "cpu")


# (b, s, h, p, n, chunk): N in {32, 64, 128}, P in {32, 64}, one and
# several chunks
SHAPES = [(1, 64, 2, 32, 32, 32), (2, 96, 3, 64, 64, 32),
          (1, 128, 2, 64, 128, 64), (2, 48, 2, 32, 64, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_scan_matches_reference_and_pallas(shape, dtype):
    b, s, h, p, n, chunk = shape
    args = _inputs(b, s, h, p, n, seed=sum(shape),
                   dtype=np.float32 if dtype == "f32" else "bf16")
    y, st = t_kernel.ssd_scan(*map(_t, args), chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    yj, sj = jm.ssd_chunked(*jargs[:3], jargs[3], jargs[4], chunk)
    yp, sp = j_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    for want_y, want_s in ((yj, sj), (yp, sp)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s),
                                   rtol=RTOL, atol=ATOL)


# The bf16 route of csrc/ssd_scan.cu splits each f32 operand of its
# products (G, the carried state H, W) into bf16 halves v = hi + lo,
# hi = bf16(v), lo = bf16(v - hi): |v - hi - lo| <= 2^-9 |v - hi| <=
# 2^-18 |v|. x, B and C are bf16 inputs and enter exact, and bf16
# products are exact in f32. So the split moves y by at most 2^-18 of
# y_abs = (|C| |B|^T o L o dt) |x| + 2 exp(cum) |C| Habs^T (G's residual,
# |G| <= |C| |B|^T o L o dt; H's residual and the residuals of W carried
# in H, Habs >= |H|) and the state by 2^-18 Habs. The bound is twice
# that, plus 1e-5 of the largest value for the f32 sums' order (the
# cumsum above all), as the f32 route is held on the card.
SPLIT = 2.0 ** -17
ORDER = 1e-5


def _split_limit(scale, want):
    return SPLIT * scale + ORDER * np.abs(np.asarray(want)).max()


def _split_ratio(got, want, scale):
    """The largest |got - want| over its derived limit."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((err / _split_limit(scale.numpy(), want)).max())


def _lane_cumsum(v):
    """The kernels' one-warp scan, one f32 operation at a time."""
    f = np.float32
    q = len(v)
    per = -(-q // 32)
    out = [f(0)] * q
    runs = []
    for lane in range(32):
        run = f(0)
        for i in range(lane * per, min(q, lane * per + per)):
            run = f(run + f(v[i]))
            out[i] = run
        runs.append(run)
    incl = list(runs)
    for off in (1, 2, 4, 8, 16):
        incl = [f(incl[k] + incl[k - off]) if k >= off else incl[k]
                for k in range(32)]
    for lane in range(1, 32):
        for i in range(lane * per, min(q, lane * per + per)):
            out[i] = f(out[i] + incl[lane - 1])
    return np.array(out, np.float32)


@pytest.mark.parametrize("q", [1, 4, 8, 33, 40, 100, 128])
def test_warp_cumsum_is_the_kernels_order(q):
    la = -np.random.default_rng(q).random(q).astype(np.float32)
    got = t_ref.warp_cumsum(torch.from_numpy(la)[None])[0].numpy()
    np.testing.assert_array_equal(got, _lane_cumsum(la))
    np.testing.assert_allclose(got, np.cumsum(la, dtype=np.float64),
                               rtol=2e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES + [(1, 100, 2, 32, 64, 4),
                                            (1, 120, 2, 64, 32, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_route_matches_reference_and_pallas(shape):
    b, s, h, p, n, chunk = shape
    args = _inputs(b, s, h, p, n, seed=sum(shape), dtype="bf16")
    y, st, y_abs, s_abs = t_ref.split_bf16_route(*map(_t, args), chunk)
    jargs = [jnp.asarray(a) for a in args]
    yj, sj = jm.ssd_chunked(*jargs, chunk)
    yp, sp = j_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    for want_y, want_s in ((yj, sj), (yp, sp)):
        assert _split_ratio(y, want_y, y_abs) <= 1.0
        assert _split_ratio(st, want_s, s_abs) <= 1.0


@pytest.mark.parametrize("p,n", [(p, n) for p in (32, 64, 128)
                                 for n in (32, 64, 128)])
@pytest.mark.parametrize("chunk", [4, 8, 32, 128])
def test_split_route_matches_plain_scan(chunk, p, n):
    s = max(64, 2 * chunk)
    args = [_t(a) for a in _inputs(1, s, 2, p, n, seed=chunk + p + n,
                                   dtype="bf16")]
    y, st, y_abs, s_abs = t_ref.split_bf16_route(*args, chunk)
    y_p, s_p = t_kernel.ssd_scan(*args, chunk=chunk)
    assert _split_ratio(y, y_p, y_abs) <= 1.0
    assert _split_ratio(st, s_p, s_abs) <= 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_bound_is_not_vacuous(shape):
    """One bf16 rounding of G, H and W (2^-9 of each) breaks the bound
    that the split meets."""
    b, s, h, p, n, chunk = shape
    args = [_t(a) for a in _inputs(b, s, h, p, n, seed=sum(shape),
                                   dtype="bf16")]
    y_p, s_p = t_kernel.ssd_scan(*args, chunk=chunk)
    y, st, y_abs, s_abs = t_ref.split_bf16_route(*args, chunk)
    y1, s1, _, _ = t_ref.split_bf16_route(*args, chunk, split=False)
    assert _split_ratio(y, y_p, y_abs) <= 1.0
    assert _split_ratio(y1, y_p, y_abs) > 4.0
    assert _split_ratio(s1, s_p, s_abs) > 4.0


def test_plain_scan_carries_an_initial_state():
    b, s, h, p, n = 1, 64, 2, 32, 32
    args = _inputs(b, s, h, p, n, seed=3)
    s0 = np.random.default_rng(4).standard_normal((b, h, p, n)).astype(
        np.float32)
    y, st = tm.ssd_chunked(*map(_t, args), 16, initial_state=_t(s0))
    jargs = [jnp.asarray(a) for a in args]
    yj, sj = jm.ssd_chunked(*jargs, 16, initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=RTOL,
                               atol=ATOL)


def test_scan_refuses_a_chunk_that_does_not_divide():
    args = list(map(_t, _inputs(1, 48, 2, 32, 32, seed=0)))
    with pytest.raises(ValueError, match="does not divide"):
        t_kernel.ssd_scan(*args, chunk=32)
    with pytest.raises(ValueError, match="does not divide"):
        t_ops.ssd_scan(*args, chunk=32, use_kernel=False)
    with pytest.raises(ValueError, match="shape"):
        t_kernel.ssd_scan(args[0], args[1][:, :-1], *args[2:], chunk=16)


def _mamba_cfgs(arch):
    kw = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(j_reduced(arch), **kw),
            dataclasses.replace(t_reduced(arch), **kw))


def _mamba_params(jcfg, seed=0):
    jp, _ = jm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    jp = jax.device_get(jp)
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("arch,seq", [("mamba2-130m", 64),
                                      ("zamba2-2.7b", 48),
                                      ("mamba2-130m", 8)])
def test_mamba_train_matches_reference(arch, seq):
    """seq 64: two chunks of 32; 48: the chunk halves to 16; 8: one chunk
    shorter than the config's."""
    jcfg, tcfg = _mamba_cfgs(arch)
    jp, tp = _mamba_params(jcfg)
    x = 0.5 * np.random.default_rng(seq).standard_normal(
        (2, seq, jcfg.d_model)).astype(np.float32)
    yj, cj = jax.jit(lambda p, x: jm.mamba_train(p, jcfg, x))(
        jp, jnp.asarray(x))
    for use_kernel in (True, False):
        y, c = tm.mamba_train(tp, tcfg, _t(x), use_kernel=use_kernel)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(c["ssm"].numpy(), np.asarray(cj["ssm"]),
                                   rtol=RTOL, atol=ATOL)
        # the conv cache: the last W - 1 inputs before the conv
        np.testing.assert_allclose(c["conv"].numpy(), np.asarray(cj["conv"]),
                                   rtol=RTOL, atol=ATOL)


def test_mamba_decode_matches_reference_step_by_step():
    jcfg, tcfg = _mamba_cfgs("zamba2-2.7b")
    jp, tp = _mamba_params(jcfg, seed=1)
    rng = np.random.default_rng(7)
    x = 0.5 * rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    _, cj = jax.jit(lambda p, x: jm.mamba_train(p, jcfg, x))(
        jp, jnp.asarray(x))
    _, ct = tm.mamba_train(tp, tcfg, _t(x))
    decode = jax.jit(lambda p, x, c: jm.mamba_decode(p, jcfg, x, c))
    for step in range(3):
        xs = 0.5 * rng.standard_normal((2, 1, jcfg.d_model)).astype(
            np.float32)
        yj, cj = decode(jp, jnp.asarray(xs), cj)
        y, ct = tm.mamba_decode(tp, tcfg, _t(xs), ct)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                       rtol=RTOL, atol=ATOL)


def test_decode_continues_the_prefill_scan():
    """Prefill over S tokens then one decode step equals the prefill over
    S + 1 (the recurrence and the chunked scan are one function)."""
    _, tcfg = _mamba_cfgs("mamba2-130m")
    _, tp = _mamba_params(_mamba_cfgs("mamba2-130m")[0], seed=2)
    x = 0.5 * torch.randn((1, 33, tcfg.d_model),
                          generator=torch.Generator().manual_seed(0))
    y_all, c_all = tm.mamba_train(tp, tcfg, x)
    _, c = tm.mamba_train(tp, tcfg, x[:, :32])
    y_last, c = tm.mamba_decode(tp, tcfg, x[:, 32:], c)
    torch.testing.assert_close(y_last, y_all[:, 32:], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(c["ssm"], c_all["ssm"], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(c["conv"], c_all["conv"], rtol=RTOL,
                               atol=ATOL)
