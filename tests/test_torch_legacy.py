"""The port's legacy FL surface against the reference and against its own
``Trainer``: ``setup``/``FLState``, the deprecated ``make_round_fn`` and
``make_training_fn`` shims with their warnings and refusals,
``round_epsilon_spent``, ``register_algorithm(overwrite=)`` and
``unregister_algorithm``, ``ClientBank`` with ``bank.to_host`` and
``bank.to_device``, the ``LedgerState`` export and ``__all__``.

The golden problem of ``tests/test_torch_round.py`` (BENCH_MLP, N = 20,
r = 4, tau = 2; init key 1, run key 2). The shims are held bit-equal to
``Trainer.step``/``run`` under the same keys, and to the reference's
shims at the digests' rtol 2e-6.
"""
import dataclasses
import os
import sys
import warnings

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import repro.fl as jfl  # noqa: E402
import update_goldens as ug  # noqa: E402
from repro.configs import ChannelConfig as JChannel  # noqa: E402
from repro.configs import CompressionSchedule as JSchedule  # noqa: E402
from repro.configs import PFELSConfig as JConfig  # noqa: E402
from repro_torch import fl, prng  # noqa: E402
from repro_torch.configs import (ChannelConfig,  # noqa: E402
                                 CompressionSchedule, PFELSConfig)
from repro_torch.core import privacy  # noqa: E402
from repro_torch.fl import algorithms, bank, replace  # noqa: E402
from repro_torch.tree import Unravel, ravel  # noqa: E402
from test_torch_round import (RTOL, _jax_problem,  # noqa: E402
                              _port_problem, ravel_jax)


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_llm_train.py: torch's
    spinning pool beside XLA under parallel workers costs 15-30x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_shim(t_rounds=None, **cfg_kw):
    """The port's ``setup`` and shim on the golden problem -> (output,
    FLState)."""
    params, x, y, _, _, loss_fn = _port_problem()
    unravel = Unravel(params)
    cfg = PFELSConfig(**ug.BASE, **cfg_kw)
    with pytest.warns(DeprecationWarning, match="setup is deprecated"):
        st = fl.setup(prng.PRNGKey(1, "cpu"), params, cfg, unravel.d)
    if t_rounds is None:
        with pytest.warns(DeprecationWarning, match="make_round_fn"):
            fn = fl.make_round_fn(cfg, loss_fn, unravel.d, unravel,
                                  device="cpu")
    else:
        with pytest.warns(DeprecationWarning, match="make_training_fn"):
            fn = fl.make_training_fn(cfg, loss_fn, unravel.d, unravel,
                                     rounds=t_rounds, device="cpu")
    return fn(params, st.power_limits, x, y, prng.PRNGKey(2, "cpu"),
              residuals=st.residuals), st


def _jax_shim(t_rounds=None, **cfg_kw):
    params, x, y, loss_fn, ravel_pytree, _, _, _ = _jax_problem()
    d = int(ravel_pytree(params)[0].shape[0])
    unravel = ravel_pytree(params)[1]
    cfg = JConfig(**ug.BASE, **cfg_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        st = jfl.setup(jax.random.PRNGKey(1), params, cfg, d)
        fn = (jfl.make_round_fn(cfg, loss_fn, d, unravel) if t_rounds is None
              else jfl.make_training_fn(cfg, loss_fn, d, unravel,
                                        rounds=t_rounds))
    return fn(params, st.power_limits, x, y, jax.random.PRNGKey(2),
              residuals=st.residuals), st


def _trainer(**cfg_kw):
    params, x, y, _, _, loss_fn = _port_problem()
    trainer = fl.Trainer(PFELSConfig(**ug.BASE, **cfg_kw), loss_fn, params,
                         device="cpu")
    state = replace(trainer.init(prng.PRNGKey(1, "cpu")),
                    key=prng.PRNGKey(2, "cpu"))
    return trainer, state, x, y


def test_setup_draws_reference_power_limits():
    """``setup`` draws ``Trainer.init``'s power limits, bit for bit, and
    the reference's; the residual memory is (N, d) zeros only with error
    feedback."""
    (_, _), st = _port_shim()
    (_, _), jst = _jax_shim()
    trainer, state, _, _ = _trainer()
    assert isinstance(st, fl.FLState) and st.round == 0
    assert st.residuals is None
    assert torch.equal(st.power_limits, state.power_limits)
    np.testing.assert_allclose(st.power_limits.numpy(),
                               np.asarray(jst.power_limits), rtol=RTOL)
    (_, _, res), st_ef = _port_shim(error_feedback=True)
    assert st_ef.residuals.shape == (ug.BASE["num_clients"], trainer.d)
    assert not torch.any(st_ef.residuals)


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_round_fn_is_trainer_step(ef):
    """``make_round_fn`` is ``Trainer.step`` under the same key: params,
    metrics and (with error feedback) residuals bit-equal."""
    kw = dict(error_feedback=True, transmit_clip=0.5) if ef else {}
    out, _ = _port_shim(**kw)
    trainer, state, x, y = _trainer(**kw)
    end, metrics = trainer.step(state, x, y)
    assert len(out) == (3 if ef else 2)
    assert torch.equal(ravel(out[0]), ravel(end.params))
    assert sorted(out[1]) == sorted(k for k in metrics if k != "eps_round")
    for k, v in out[1].items():
        assert torch.equal(v, metrics[k]), k
    if ef:
        assert torch.equal(out[2], end.residuals)


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_training_fn_is_trainer_run(ef):
    kw = dict(error_feedback=True) if ef else {}
    (params, metrics, residuals, delta), _ = _port_shim(t_rounds=2, **kw)
    trainer, state, x, y = _trainer(**kw)
    end, tmetrics = trainer.run(state, x, y, rounds=2)
    assert torch.equal(ravel(params), ravel(end.params))
    assert torch.equal(delta, end.prev_delta)
    for k, v in metrics.items():
        assert v.shape[0] == 2 and torch.equal(v, tmetrics[k]), k
    assert (residuals is None) == (not ef)
    if ef:
        assert torch.equal(residuals, end.residuals)


@pytest.mark.parametrize("t_rounds,kw", [
    (None, {}), (None, dict(error_feedback=True, transmit_clip=0.5)),
    (2, dict(error_feedback=True))], ids=["round", "round_ef", "run_ef"])
def test_shims_match_reference_shims(t_rounds, kw):
    out, _ = _port_shim(t_rounds, **kw)
    jout, _ = _jax_shim(t_rounds, **kw)
    got = [ravel(out[0]).numpy()] + [out[1][k].numpy()
                                     for k in sorted(out[1])]
    want = [ravel_jax(jout[0])] + [np.asarray(jout[1][k])
                                   for k in sorted(jout[1])]
    assert sorted(out[1]) == sorted(jout[1])
    rest = out[2:] if t_rounds is not None or kw else ()
    jrest = jout[2:] if t_rounds is not None or kw else ()
    got += [t.numpy() for t in rest if t is not None]
    want += [np.asarray(j) for j in jrest if j is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for dg, dw in zip(ug._digest_arr(g), ug._digest_arr(w)):
            assert dg == pytest.approx(dw, rel=RTOL, abs=1e-12)


def test_shims_warn_and_refuse_as_the_reference():
    params, _, _, _, _, loss_fn = _port_problem()
    jparams, _, _, jloss_fn, ravel_pytree, _, _, _ = _jax_problem()
    unravel, junravel = Unravel(params), ravel_pytree(jparams)[1]
    refused = [
        (dict(channel=ChannelConfig(model="markov_fading")),
         dict(channel=JChannel(model="markov_fading")), "stateful"),
        (dict(schedule=CompressionSchedule(mode="linear")),
         dict(schedule=JSchedule(mode="linear")), "schedule"),
        (dict(compressor="top_k_ef"), dict(compressor="top_k_ef"),
         "error-feedback"),
    ]
    for shim, jshim in ((fl.make_round_fn, jfl.make_round_fn),
                        (fl.make_training_fn, jfl.make_training_fn)):
        for kw, jkw, match in refused:
            cfg = PFELSConfig(**ug.BASE, **kw)
            with pytest.warns(DeprecationWarning), \
                    pytest.raises(ValueError, match=match):
                shim(cfg, loss_fn, unravel.d, unravel, device="cpu")
            with pytest.warns(DeprecationWarning), \
                    pytest.raises(ValueError, match=match):
                jshim(JConfig(**ug.BASE, **jkw), jloss_fn, unravel.d,
                      junravel)
    # server_topk hands the reconstructed update out under "delta_hat"
    cfg = PFELSConfig(**ug.BASE, randk_mode="server_topk")
    with pytest.warns(DeprecationWarning, match="delta_hat"):
        fn = fl.make_round_fn(cfg, loss_fn, unravel.d, unravel,
                              device="cpu")
    _, x, y, _, _, _ = _port_problem()
    p_lim = fl.Trainer(cfg, loss_fn, params, device="cpu").init(
        prng.PRNGKey(1, "cpu")).power_limits
    _, metrics = fn(params, p_lim, x, y, prng.PRNGKey(2, "cpu"))
    assert metrics["delta_hat"].shape == (unravel.d,)


@pytest.mark.parametrize("kw,jkw", [
    ({}, {}),
    (dict(compressor="stoch_quant", quant_bits=6),
     dict(compressor="stoch_quant", quant_bits=6)),
    (dict(channel=ChannelConfig(model="mimo_mrc", num_antennas=4)),
     dict(channel=JChannel(model="mimo_mrc", num_antennas=4))),
], ids=["pfels", "stoch_quant", "mimo_mrc"])
def test_round_epsilon_spent_matches_reference(kw, jkw):
    d = 7837 * 3
    for beta in (0.5, 6.117160320281982, 27.868776321411133):
        got = fl.round_epsilon_spent(PFELSConfig(**ug.BASE, **kw), beta, d)
        want = jfl.round_epsilon_spent(JConfig(**ug.BASE, **jkw), beta, d)
        assert isinstance(got, float)
        assert got == pytest.approx(float(want), rel=1e-6)


def test_register_and_unregister_algorithm():
    alg = dataclasses.replace(algorithms.get_algorithm("fedavg"),
                              name="fedavg_copy")
    jalg = dataclasses.replace(jfl.get_algorithm("fedavg"),
                               name="fedavg_copy")
    try:
        for reg, a in ((fl.register_algorithm, alg),
                       (jfl.register_algorithm, jalg)):
            assert reg("fedavg_copy", a) is a
            with pytest.raises(ValueError, match="already registered"):
                reg("fedavg_copy", a)
        swapped = dataclasses.replace(alg, sparsifies_transmit=True)
        fl.register_algorithm("fedavg_copy", swapped, overwrite=True)
        assert fl.get_algorithm("fedavg_copy") is swapped
        assert "fedavg_copy" in fl.list_algorithms()
    finally:
        fl.unregister_algorithm("fedavg_copy")
        jfl.unregister_algorithm("fedavg_copy")
    assert "fedavg_copy" not in fl.list_algorithms()
    with pytest.raises(KeyError):
        fl.get_algorithm("fedavg_copy")
    fl.unregister_algorithm("fedavg_copy")      # absent: no error


def test_bank_moves_between_backends_and_exports():
    """``to_host`` of a resident state continues under the streamed bank
    as the resident state continues, and ``to_device`` of a streamed
    state under the resident bank; the package exports the reference's
    names."""
    kw = dict(error_feedback=True)
    res_tr, state, x, y = _trainer(**kw)
    str_tr = fl.Trainer(dataclasses.replace(res_tr.cfg,
                                            bank_backend="streamed"),
                        res_tr.loss_fn, _port_problem()[0], device="cpu")
    assert isinstance(res_tr.bank, fl.ClientBank)
    assert isinstance(str_tr.bank, fl.ClientBank)
    s1, _ = res_tr.step(state, x, y)
    host = bank.to_host(s1.bank)
    assert host.residuals.device.type == "cpu"
    assert host.residuals.data_ptr() != s1.bank.residuals.data_ptr()
    a, am = str_tr.run(replace(s1, bank=host), x, y, rounds=1)
    b, bm = res_tr.run(replace(s1, bank=bank.to_device(host, "cpu")), x, y,
                       rounds=1)
    assert torch.equal(ravel(a.params), ravel(b.params))
    assert all(torch.equal(am[k], bm[k]) for k in am)
    assert torch.equal(a.bank.residuals, b.bank.residuals)
    assert fl.LedgerState is privacy.LedgerState
    assert sorted(fl.__all__) == sorted(jfl.__all__)
    for name in fl.__all__:
        assert hasattr(fl, name), name
