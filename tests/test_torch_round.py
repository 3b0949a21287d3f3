"""The port's whole slice, one PFELS ``Trainer.run``, against the
reference: the committed ``pfels-unfused`` and ``pfels-fused`` golden
rows, live JAX runs with a transmit clip (which takes the
``client_sumsq`` pass), ``step``, a state carried across mid-run,
``evaluate`` and ``ledger_totals``.

The golden problem is ``tools/update_goldens.py``'s: BENCH_MLP, N = 20,
r = 4, tau = 2, 2 rounds, init key 1, run key 2; the port draws its data
and init from the same keys with its own threefry.

Tolerance: rtol 2e-6 on every digest. The gap is set by the ``normal``
and ``exponential`` draws (a few ulp on a few percent of the values,
tests/test_torch_prng.py) and f32 sums in another order; measured at
most 5.1e-7 (the round-1 energy).
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))

import update_goldens as ug  # noqa: E402
from repro.configs import PFELSConfig as JConfig  # noqa: E402
from repro.fl import Trainer as JTrainer  # noqa: E402
from repro.fl.api import replace as jreplace  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import privacy  # noqa: E402
from repro_torch.configs import (BENCH_MLP, ChannelConfig,  # noqa: E402
                                 PFELSConfig)
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import Trainer, replace  # noqa: E402
from repro_torch.kernels.pfels_transmit import ref as tref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import ravel  # noqa: E402

RTOL = 2e-6


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


_CACHE = {}


def _port_problem():
    if "port" not in _CACHE:
        key = prng.PRNGKey(0, "cpu")
        params = cnn.init_cnn(key, BENCH_MLP, device="cpu")
        x, y, xt, yt = make_federated_classification(
            key, n_clients=ug.BASE["num_clients"], per_client=20,
            num_classes=10, image_shape=(1, 8, 8), device="cpu")
        _CACHE["port"] = (params, x, y, xt, yt,
                          lambda p, b: cnn.cnn_loss(p, BENCH_MLP, b))
    return _CACHE["port"]


def _jax_problem():
    if "jax" not in _CACHE:
        from repro.data import make_federated_classification as jmake
        from repro.models import cnn as jcnn
        _, _, xt, yt = jmake(jax.random.PRNGKey(0), n_clients=20,
                             per_client=20, num_classes=10,
                             image_shape=(1, 8, 8))
        _CACHE["jax"] = ug._problem() + (xt, yt, jcnn)
    return _CACHE["jax"]


def _digest(params_flat, prev_delta, metrics, ledger):
    return {
        "params": ug._digest_arr(params_flat),
        "prev_delta": ug._digest_arr(prev_delta),
        "metrics": {k: [float(v) for v in np.asarray(metrics[k], np.float64)]
                    for k in ug.METRIC_KEYS},
        "ledger": {"eps_sum": float(ledger.eps_sum),
                   "eps_max": float(ledger.eps_max),
                   "spends": int(ledger.spends)},
    }


def _port_digest(end, metrics):
    m = {k: v.double().numpy() for k, v in metrics.items()}
    return _digest(ravel(end.params).numpy(), end.prev_delta.numpy(), m,
                   end.ledger)


def _jax_digest(end, metrics):
    return _digest(ravel_jax(end.params), end.prev_delta, metrics,
                   end.ledger)


def ravel_jax(params):
    from jax.flatten_util import ravel_pytree
    return np.asarray(ravel_pytree(params)[0])


def _port_trainer(**cfg_kw):
    params, x, y, xt, yt, loss_fn = _port_problem()
    cfg = PFELSConfig(**ug.BASE, **cfg_kw)
    trainer = Trainer(cfg, loss_fn, params, device="cpu")
    state = replace(trainer.init(prng.PRNGKey(1, "cpu")),
                    key=prng.PRNGKey(2, "cpu"))
    return trainer, state, x, y


def _jax_trainer(**cfg_kw):
    params, x, y, loss_fn, _, _, _, _ = _jax_problem()
    trainer = JTrainer(JConfig(**ug.BASE, **cfg_kw), loss_fn, params)
    state = jreplace(trainer.init(jax.random.PRNGKey(1)),
                     key=jax.random.PRNGKey(2))
    return trainer, state, x, y


def _assert_close(path, got, want):
    if isinstance(want, dict):
        for k in want:
            _assert_close(f"{path}.{k}", got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(f"{path}[{i}]", g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), \
            f"{path}: reference={want!r} port={got!r}"
    else:
        assert got == want, f"{path}: reference={want!r} port={got!r}"


@pytest.mark.parametrize("case,fused", [("pfels-unfused", False),
                                        ("pfels-fused", True)])
def test_run_reproduces_committed_golden_rows(case, fused):
    with open(ug.GOLDEN_PATH) as f:
        golden = json.load(f)["cases"][case]
    trainer, state, x, y = _port_trainer(use_fused_kernel=fused)
    seen = []
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS,
                               on_round=lambda t, m: seen.append(t))
    assert seen == list(range(ug.ROUNDS))
    got = _port_digest(end, metrics)
    _assert_close(case, got, {k: golden[k] for k in got})


@pytest.mark.parametrize("clip", [0.25, 0.1])
def test_transmit_clip_fused_matches_live_reference(clip, monkeypatch):
    """0.25 (= eta tau C1 of the paper's defaults) does not bind on this
    problem and 0.1 does; both take the ``client_sumsq`` pass."""
    calls = []
    real = tref.client_sumsq_ref
    monkeypatch.setattr(tref, "client_sumsq_ref",
                        lambda u: calls.append(1) or real(u))
    trainer, state, x, y = _port_trainer(transmit_clip=clip)
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    assert len(calls) == ug.ROUNDS
    jtrainer, jstate, jx, jy = _jax_trainer(transmit_clip=clip)
    jend, jmetrics = jtrainer.run(jstate, jx, jy, rounds=ug.ROUNDS)
    _assert_close(f"clip={clip}", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))


def test_evaluate_and_ledger_totals_match_reference():
    trainer, state, x, y = _port_trainer()
    end, _ = trainer.run(state, x, y, rounds=ug.ROUNDS)
    jtrainer, jstate, jx, jy = _jax_trainer()
    jend, _ = jtrainer.run(jstate, jx, jy, rounds=ug.ROUNDS)
    _, _, xt, yt, _ = _port_problem()[1:]
    jxt, jyt = _jax_problem()[5:7]
    loss, acc = trainer.evaluate(end, xt, yt)
    jloss, jacc = jtrainer.evaluate(jend, jxt, jyt)
    assert loss == pytest.approx(jloss, rel=RTOL)
    assert acc == pytest.approx(jacc, abs=1e-6)
    got, want = trainer.ledger_totals(end), jtrainer.ledger_totals(jend)
    assert got["spends"] == want["spends"] == ug.ROUNDS
    for k in ("basic", "advanced"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    assert got["eps_max_round"] == pytest.approx(want["eps_max_round"],
                                                 rel=RTOL)


def test_host_privacy_ledger_matches_round_ledger():
    """``PrivacyLedger`` fed the per-round ``eps_round`` metrics totals to
    what the Trainer's ledger reports (same f32 spends, summed in the
    same order)."""
    trainer, state, x, y = _port_trainer()
    end, metrics = trainer.run(state, x, y, rounds=3)
    host = privacy.PrivacyLedger(n=ug.BASE["num_clients"],
                                 delta=trainer.cfg.resolved_delta())
    for eps in metrics["eps_round"]:
        host.spend(float(eps))
    totals = trainer.ledger_totals(end)
    assert totals["spends"] == 3
    np.testing.assert_allclose(host.total_basic(), totals["basic"],
                               rtol=1e-6)
    assert host.total_advanced() == pytest.approx(totals["advanced"])
    assert privacy.PrivacyLedger(n=1, delta=0.1).total_basic() == (0.0, 0.0)


def test_step_and_carried_state_match_reference():
    """``step`` consumes the key whole; a JAX state carried across after
    one step continues in the port as it does in the reference, bank
    lanes and counts included."""
    trainer, state, x, y = _port_trainer()
    jtrainer, jstate, jx, jy = _jax_trainer()
    s1, m1 = trainer.step(state, x, y)
    j1, jm1 = jtrainer.step(jstate, jx, jy)
    assert np.array_equal(s1.bank.lanes.numpy(),
                          np.asarray(j1.bank.lanes).astype(np.int64))
    assert np.array_equal(s1.bank.counts.numpy(), np.asarray(j1.bank.counts))
    assert np.array_equal(s1.key.numpy(),
                          np.asarray(j1.key).astype(np.int64))
    for k in ug.METRIC_KEYS:
        assert float(m1[k]) == pytest.approx(float(jm1[k]), rel=RTOL)

    carried = convert.train_state_from_jax(jax.device_get(j1), "cpu")
    assert int(carried.round) == 1
    end, metrics = trainer.run(carried, x, y, rounds=1)
    jend, jmetrics = jtrainer.run(j1, jx, jy, rounds=1)
    _assert_close("carried", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    assert np.array_equal(end.bank.counts.numpy(),
                          np.asarray(jend.bank.counts))


def test_cohort_in_one_process_is_the_unsharded_round():
    """``client_sharding="cohort"`` without ``torch.distributed`` is one
    shard: the run is the ``"none"`` run, bit for bit."""
    runs = []
    for sharding in ("none", "cohort"):
        trainer, state, x, y = _port_trainer(client_sharding=sharding)
        assert (trainer.cohort is None) == (sharding == "none")
        end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
        runs.append((ravel(end.params), end.prev_delta, metrics))
    (pa, da, ma), (pb, db, mb) = runs
    assert torch.equal(pa, pb) and torch.equal(da, db)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_streamed_bank_with_sharded_cohort_raises_reference_error():
    """The reference refuses the streamed bank with a sharded cohort
    (``repro/fl/api.py``); so does the port, with the same error."""
    params, _, _, _, _, loss_fn = _port_problem()
    cfg = dataclasses.replace(PFELSConfig(**ug.BASE),
                              bank_backend="streamed",
                              client_sharding="cohort")
    with pytest.raises(ValueError, match="does not compose") as got:
        Trainer(cfg, loss_fn, params, device="cpu")
    jparams, _, _, jloss_fn, _, _, _, _ = _jax_problem()
    with pytest.raises(ValueError) as want:
        JTrainer(JConfig(**ug.BASE, bank_backend="streamed",
                         client_sharding="cohort"), jloss_fn, jparams)
    assert str(got.value) == str(want.value)


def test_imperfect_csi_matches_reference():
    """``csi_error > 0`` is ported: one extra ``normal`` draw on the csi
    lane, and precompensation with the observed gains."""
    chan = dict(channel=ChannelConfig(csi_error=0.2))
    trainer, state, x, y = _port_trainer(**chan)
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    from repro.configs import ChannelConfig as JChannel
    jtrainer, jstate, jx, jy = _jax_trainer(channel=JChannel(csi_error=0.2))
    jend, jmetrics = jtrainer.run(jstate, jx, jy, rounds=ug.ROUNDS)
    _assert_close("csi", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    assert torch.all(torch.isfinite(end.prev_delta))
