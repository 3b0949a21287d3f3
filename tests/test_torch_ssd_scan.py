"""The port's SSD chunk scan and Mamba2 block against the JAX reference on
the CPU: ``kernels/ssd_scan`` (whose CPU route is the plain version
``ssd_chunked``) against the reference's ``ssd_chunked`` and its Pallas
``ssd_scan`` in interpret mode, then ``mamba_train`` / ``mamba_decode``
with the weights carried across by ``repro_torch.convert``."""
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
