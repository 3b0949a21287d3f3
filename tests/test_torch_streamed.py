"""The streamed client bank and the paper's second experiment on the CPU.

- The five reachable ``*-streamed`` golden rows (``tools/update_goldens.py``
  's problem) within the rtol 2e-6 of ``tests/test_torch_round.py``.
- Streamed against resident in the port, bit for bit: params,
  ``prev_delta``, metrics and the bank (lanes, counts, residuals), with
  and without error feedback, with tensors and with a ``ClientFnSource``
  passed as ``run(source)`` (``data_y`` None).
- The source-size check.
- Two rounds of PFELS on BENCH_CNN_FEMNIST (the reduced ResNet, Dirichlet
  label skew) through ``Trainer.run`` against the live reference on the
  same carried params and data.
"""
import json

import jax
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from test_torch_round import (GOLDEN_RTOL, RTOL, _assert_close,
                              _jax_digest,
                              _port_digest, _port_problem, _port_trainer)

import update_goldens as ug
from repro_torch import convert, prng
from repro_torch.configs import PFELSConfig
from repro_torch.configs import paper_models as tpm
from repro_torch.data import loader, make_population_source
from repro_torch.fl import StreamedBank, Trainer, replace
from repro_torch.models import cnn
from repro_torch.tree import ravel

STREAMED_ROWS = ["pfels-streamed", "wfl_p-streamed", "wfl_pdp-streamed",
                 "dp_fedavg-streamed", "fedavg-streamed"]


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.mark.parametrize("case", STREAMED_ROWS)
def test_run_reproduces_committed_streamed_golden_rows(case):
    with open(ug.GOLDEN_PATH) as f:
        golden = json.load(f)["cases"][case]
    overrides, chan, _ = ug._cases()[case]
    assert chan == {} and overrides["bank_backend"] == "streamed"
    trainer, state, x, y = _port_trainer(**overrides)
    assert isinstance(trainer.bank, StreamedBank)
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    got = _port_digest(end, metrics)
    _assert_close(case, got, {k: golden[k] for k in got},
                  GOLDEN_RTOL)
    assert end.bank.counts.device.type == "cpu"
    assert int(end.bank.counts.sum()) == ug.ROUNDS * \
        ug.BASE["clients_per_round"]


def _assert_bit_equal(a_state, a_metrics, b_state, b_metrics):
    assert torch.equal(ravel(a_state.params), ravel(b_state.params))
    assert torch.equal(a_state.prev_delta, b_state.prev_delta)
    assert a_metrics.keys() == b_metrics.keys()
    for k in a_metrics:
        assert torch.equal(a_metrics[k], b_metrics[k]), k
    assert torch.equal(a_state.bank.lanes.cpu(), b_state.bank.lanes.cpu())
    assert torch.equal(a_state.bank.counts.cpu(), b_state.bank.counts.cpu())
    if a_state.residuals is None:
        assert b_state.residuals is None
    else:
        assert torch.equal(a_state.residuals.cpu(), b_state.residuals.cpu())
    assert torch.equal(a_state.key, b_state.key)
    assert int(a_state.round) == int(b_state.round)
    for f in ("eps_sum", "eps_max", "spends"):
        assert torch.equal(getattr(a_state.ledger, f),
                           getattr(b_state.ledger, f))


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_streamed_is_bit_equal_to_resident(ef):
    """Tensors as data; 3 rounds in two ``run`` calls, so the bank crosses
    a call; then ``step``."""
    kw = dict(error_feedback=True, transmit_clip=0.5) if ef else {}
    res, state, x, y = _port_trainer(**kw)
    st, sstate, _, _ = _port_trainer(bank_backend="streamed", **kw)
    a, am = res.run(state, x, y, rounds=2)
    b, bm = st.run(sstate, x, y, rounds=2)
    _assert_bit_equal(a, am, b, bm)
    a, am = res.run(a, x, y, rounds=1)
    b, bm = st.run(b, x, y, rounds=1)
    _assert_bit_equal(a, am, b, bm)
    a, am = res.step(a, x, y)
    b, bm = st.step(b, x, y)
    _assert_bit_equal(a, am, b, bm)
    assert b.bank.lanes.device.type == "cpu"


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_streamed_from_a_population_source_is_bit_equal(ef):
    """``run(source)`` with ``data_y`` None on a ``ClientFnSource`` against
    the resident run on the same clients' data made in one piece; the
    streamed call leaves the state it was given valid (its bank is
    cloned), so running it again gives the same result."""
    params, _, _, _, _, loss_fn = _port_problem()
    n = ug.BASE["num_clients"]
    source, _, _ = make_population_source(
        prng.PRNGKey(5, "cpu"), n_clients=n, per_client=20,
        num_classes=10, image_shape=(1, 8, 8), device="cpu")
    x, y = source.cohort(torch.arange(n))
    kw = dict(ug.BASE, error_feedback=ef, transmit_clip=0.5 if ef else None)
    res = Trainer(PFELSConfig(**kw), loss_fn, params, device="cpu")
    st = Trainer(PFELSConfig(bank_backend="streamed", **kw), loss_fn,
                 params, device="cpu")
    s0 = replace(st.init(prng.PRNGKey(1, "cpu")), key=prng.PRNGKey(2, "cpu"))
    r0 = replace(res.init(prng.PRNGKey(1, "cpu")),
                 key=prng.PRNGKey(2, "cpu"))
    seen = []
    b, bm = st.run(s0, source, rounds=3, on_round=lambda t, m: seen.append(t))
    assert seen == [0, 1, 2]
    a, am = res.run(r0, x, y, rounds=3)
    _assert_bit_equal(a, am, b, bm)
    assert int(s0.bank.counts.sum()) == 0
    b2, bm2 = st.run(s0, source, rounds=3)
    _assert_bit_equal(b, bm, b2, bm2)


def test_source_size_must_match_the_population():
    params, _, _, _, _, loss_fn = _port_problem()
    trainer = Trainer(PFELSConfig(**ug.BASE, bank_backend="streamed"),
                      loss_fn, params, device="cpu")
    state = trainer.init(prng.PRNGKey(1, "cpu"))
    source, _, _ = make_population_source(
        prng.PRNGKey(5, "cpu"), n_clients=ug.BASE["num_clients"] + 1,
        per_client=20, num_classes=10, image_shape=(1, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="cfg.num_clients"):
        trainer.run(state, source, rounds=1)
    with pytest.raises(ValueError, match="rounds >= 1"):
        trainer.run(state, source, rounds=0)
    x = torch.zeros((ug.BASE["num_clients"], 2, 1, 8, 8))
    with pytest.raises(ValueError, match="data_y is required"):
        trainer.run(state, x, rounds=1)
    assert isinstance(loader.as_cohort_source(source), loader.ClientFnSource)


# the paper's second experiment at the reduced width: energy is quadratic
# in the updates, so its relative gap is twice theirs. Measured: params
# and prev_delta digests at most 6.8e-7, update_norm 1.0e-6, train_loss
# 3.0e-7, energy 2.1e-6 and 2.5e-6 (rounds 1, 2); again 1.02e-6 and
# 2.50e-6 with every draw bit-equal to the reference's. The updates' gap
# is the f32 convolutions' order: the reference's own vmapped round and
# its unbatched local training differ by 3.5e-6 on one client's update
# norm.
FEMNIST_ENERGY_RTOL = 2 * RTOL


def test_bench_cnn_femnist_pfels_matches_live_reference():
    from repro.configs import PFELSConfig as JConfig
    from repro.configs.paper_models import BENCH_CNN_FEMNIST as JFEMNIST
    from repro.data import make_federated_classification as jmake
    from repro.fl import Trainer as JTrainer
    from repro.fl.api import replace as jreplace
    from repro.models import cnn as jcnn

    key = jax.random.PRNGKey(0)
    jparams = jcnn.init_cnn(key, JFEMNIST)
    x, y, _, _ = jmake(key, n_clients=ug.BASE["num_clients"], per_client=20,
                       num_classes=62, image_shape=(1, 14, 14), alpha=0.5)
    jtrainer = JTrainer(JConfig(**ug.BASE),
                        lambda p, b: jcnn.cnn_loss(p, JFEMNIST, b), jparams)
    jstate = jreplace(jtrainer.init(jax.random.PRNGKey(1)),
                      key=jax.random.PRNGKey(2))
    jend, jmetrics = jtrainer.run(jstate, x, y, rounds=ug.ROUNDS)

    tcfg = tpm.BENCH_CNN_FEMNIST
    trainer = Trainer(PFELSConfig(**ug.BASE),
                      lambda p, b: cnn.cnn_loss(p, tcfg, b),
                      convert.params_from_jax(jax.device_get(jparams),
                                              "cpu"), device="cpu")
    assert trainer.d == 705_486
    state = replace(trainer.init(prng.PRNGKey(1, "cpu")),
                    key=prng.PRNGKey(2, "cpu"))
    end, metrics = trainer.run(
        state, convert.tensor_from_numpy(np.asarray(x), "cpu"),
        convert.tensor_from_numpy(np.asarray(y), "cpu").long(),
        rounds=ug.ROUNDS)
    got, want = _port_digest(end, metrics), _jax_digest(jend, jmetrics)
    energy = (got["metrics"].pop("energy"), want["metrics"].pop("energy"))
    _assert_close("femnist", got, want)
    np.testing.assert_allclose(energy[0], energy[1],
                               rtol=FEMNIST_ENERGY_RTOL)
    assert all(np.isfinite(v) for v in got["metrics"]["train_loss"])
