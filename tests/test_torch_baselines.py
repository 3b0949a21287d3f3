"""The paper's baselines and the round options of the port against the
reference: WFL-P (Eq. 36), WFL-PDP (Eq. 37), DP-FedAvg (Alg. 1) and
FedAvg, error feedback and ``randk_mode="server_topk"``.

Whole runs reproduce the committed golden rows (``tools/update_goldens.py``
's problem and configs) or live reference runs, within the rtol 2e-6 of
``tests/test_torch_round.py`` (set by the ``normal`` and ``exponential``
draws and f32 sums in another order). The pieces (beta designs, the
digital aggregates, ``sparsify``, the server-top-k support) are held
against the reference's functions on the same numpy inputs.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import update_goldens as ug  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import power_control as jpc  # noqa: E402
from repro.core.compressors import base as jcbase  # noqa: E402
from repro.core.compressors import rand_k as jrand_k  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import PFELSConfig  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import power_control as tpc  # noqa: E402
from repro_torch.core.compressors import base as tcbase  # noqa: E402
from repro_torch.core.compressors import rand_k as trand_k  # noqa: E402
from repro_torch.fl import Trainer, algorithms, bank  # noqa: E402
from repro_torch.fl.rounds import ROUND_KEY_LANES  # noqa: E402
from repro_torch.kernels.pfels_transmit import ref as tref  # noqa: E402
from test_torch_round import (GOLDEN_RTOL, RTOL,  # noqa: E402
                              _assert_close,
                              _jax_digest, _jax_trainer, _port_digest,
                              _port_problem, _port_trainer)

GOLDEN_ROWS = ["wfl_p-unfused", "wfl_p-fused", "wfl_pdp-unfused",
               "wfl_pdp-fused", "dp_fedavg-unfused", "fedavg-unfused",
               "pfels-error_feedback"]


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("case", GOLDEN_ROWS)
def test_run_reproduces_committed_golden_rows(case):
    with open(ug.GOLDEN_PATH) as f:
        golden = json.load(f)["cases"][case]
    overrides, chan, _ = ug._cases()[case]
    assert chan == {}
    trainer, state, x, y = _port_trainer(**overrides)
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    got = _port_digest(end, metrics)
    _assert_close(case, got, {k: golden[k] for k in got},
                  GOLDEN_RTOL)
    if trainer.algorithm.aircomp:
        assert torch.all(metrics["subcarriers"] > 0)
    else:
        assert torch.all(metrics["beta"] == 0)
        assert torch.all(metrics["energy"] == 0)


@pytest.mark.parametrize("alg", ["wfl_p", "wfl_pdp"])
def test_full_support_transmits_every_coordinate(alg, monkeypatch):
    """k = d: the support is arange(d), the fused mask all ones."""
    seen = []
    real = tref.dense_noise_and_mask
    monkeypatch.setattr(tref, "dense_noise_and_mask",
                        lambda idx, *a: seen.append(idx) or real(idx, *a))
    trainer, state, x, y = _port_trainer(algorithm=alg)
    _, metrics = trainer.run(state, x, y, rounds=1)
    assert len(seen) == 1
    assert torch.equal(seen[0], torch.arange(trainer.d))
    assert int(metrics["subcarriers"][0]) == trainer.d


@pytest.mark.parametrize("overrides", [
    dict(randk_mode="server_topk", use_fused_kernel=False),
    dict(randk_mode="server_topk"),
    dict(randk_mode="server_topk", error_feedback=True, transmit_clip=0.5),
    dict(algorithm="dp_fedavg", error_feedback=True),
    dict(error_feedback=True, transmit_clip=0.1),
])
def test_round_options_match_live_reference(overrides):
    trainer, state, x, y = _port_trainer(**overrides)
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    jtrainer, jstate, jx, jy = _jax_trainer(**overrides)
    jend, jmetrics = jtrainer.run(jstate, jx, jy, rounds=ug.ROUNDS)
    _assert_close(str(overrides), _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    if trainer.cfg.error_feedback:
        _assert_close("residuals", ug._digest_arr(end.residuals.numpy()),
                      ug._digest_arr(jend.residuals))


def test_server_topk_supports_equal_in_round_two():
    """Round 2 selects from |Delta_hat_1|: the port's support equals the
    reference's, from the reference's prev_delta and from the port's
    own; round 1 (prev_delta = 0) is the uniform draw."""
    cfg_kw = dict(randk_mode="server_topk")
    trainer, state, x, y = _port_trainer(**cfg_kw)
    jtrainer, jstate, jx, jy = _jax_trainer(**cfg_kw)
    s1, _ = trainer.step(state, x, y)
    j1, _ = jtrainer.step(jstate, jx, jy)
    cfg, d = trainer.cfg, trainer.d
    k = max(int(round(cfg.compression_ratio * d)), 1)
    lane = ROUND_KEY_LANES["support"]
    ks = prng.split(s1.key, 7)
    jks = jax.random.split(j1.key, 7)
    want = np.asarray(jrand_k.select_support(jtrainer.cfg, d, k,
                                             j1.prev_delta, jks[lane]).idx)
    from_ref = trand_k.select_support(
        cfg, d, k, torch.as_tensor(np.array(j1.prev_delta)), ks[lane]).idx
    own = trand_k.select_support(cfg, d, k, s1.prev_delta, ks[lane]).idx
    np.testing.assert_array_equal(from_ref.numpy(), want)
    np.testing.assert_array_equal(own.numpy(), want)
    assert len(set(want.tolist())) == k
    cold = trand_k.select_support(cfg, d, k, torch.zeros(d), ks[lane]).idx
    np.testing.assert_array_equal(
        cold.numpy(), np.asarray(jax.random.permutation(jks[lane], d)[:k]))


@pytest.mark.parametrize("mode", ["exact", "mask"])
def test_other_modes_take_the_uniform_draw(mode):
    cfg = PFELSConfig(randk_mode=mode)
    key = prng.PRNGKey(4, "cpu")
    prev = torch.arange(1000, dtype=torch.float32)
    got = trand_k.select_support(cfg, 1000, 300, prev, key).idx
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.permutation(
                                      jax.random.PRNGKey(4), 1000)[:300]))


def test_top_k_ties_take_the_lower_index_first():
    x = np.asarray([0.5, 1.0, 0.5, 1.0, 0.25, 0.5, 1.0], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 5)
    got = trand_k.top_k_indices(torch.as_tensor(x), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_error_feedback_state_carries_across():
    """A reference state with EF residuals, carried over after one step,
    continues in the port as it does in the reference."""
    cfg_kw = dict(error_feedback=True, transmit_clip=0.5)
    trainer, _, x, y = _port_trainer(**cfg_kw)
    jtrainer, jstate, jx, jy = _jax_trainer(**cfg_kw)
    j1, _ = jtrainer.step(jstate, jx, jy)
    carried = convert.train_state_from_jax(jax.device_get(j1), "cpu")
    assert carried.residuals.shape == (ug.BASE["num_clients"], trainer.d)
    assert np.array_equal(carried.residuals.numpy(), np.asarray(j1.residuals))
    assert float(torch.abs(carried.residuals).sum()) > 0
    end, metrics = trainer.run(carried, x, y, rounds=1)
    jend, jmetrics = jtrainer.run(j1, jx, jy, rounds=1)
    _assert_close("carried", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    _assert_close("residuals", ug._digest_arr(end.residuals.numpy()),
                  ug._digest_arr(jend.residuals))


def test_error_feedback_fused_matches_unfused():
    runs = []
    for fused in (True, False):
        trainer, state, x, y = _port_trainer(error_feedback=True,
                                             transmit_clip=0.5,
                                             use_fused_kernel=fused)
        runs.append(trainer.run(state, x, y, rounds=ug.ROUNDS))
    (a, ma), (b, mb) = runs
    torch.testing.assert_close(a.residuals, b.residuals, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(a.prev_delta, b.prev_delta, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(ma["energy"], mb["energy"], rtol=1e-5,
                               atol=0.0)


def test_bank_refuses_a_repeated_client():
    b = bank.ResidentBank(5, 3, True, "cpu")
    state = b.init()
    sel = torch.tensor([1, 3, 1])
    lanes = torch.zeros((3, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="repeats a client"):
        b.scatter(state, sel, torch.ones((3, 3)), lanes)
    out = b.scatter(state, torch.tensor([4, 0]), torch.ones((2, 3)),
                    lanes[:2])
    assert out.residuals is state.residuals       # updated in place
    assert torch.equal(out.residuals.sum(dim=1),
                       torch.tensor([3.0, 0.0, 0.0, 0.0, 3.0]))
    assert torch.equal(out.counts, torch.tensor([1, 0, 0, 0, 1],
                                                dtype=torch.int32))


def test_unknown_algorithm_is_a_key_error():
    with pytest.raises(KeyError, match="unknown algorithm"):
        algorithms.get_algorithm("fedprox")


# ------------------------------------------------------------ the pieces

def _channel_inputs(seed, r=7, n=20):
    rng = np.random.default_rng(seed)
    gains = _f32(1e-3 + 0.1 * rng.random(r))
    p = _f32(1.0 + 50.0 * rng.random(r))
    return gains, p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beta_designs_match_reference(seed):
    gains, p = _channel_inputs(seed)
    kw = dict(c1=1.0, eta=0.05, tau=5)
    got = tpc.beta_wfl_p(torch.as_tensor(gains), torch.as_tensor(p), **kw)
    want = jpc.beta_wfl_p(jnp.asarray(gains), jnp.asarray(p), **kw)
    assert float(got) == pytest.approx(float(want), rel=1e-7)
    priv = dict(epsilon=[0.05, 1.5, 50.0][seed], r=32, n=1000, delta=1e-3,
                sigma0=1.0)
    got = tpc.beta_wfl_pdp(torch.as_tensor(gains), torch.as_tensor(p),
                           **kw, **priv)
    want = jpc.beta_wfl_pdp(jnp.asarray(gains), jnp.asarray(p), **kw,
                            **priv)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-7)


@pytest.mark.parametrize("r,d,clip,sigma", [(4, 1000, 0.1, 1.0),
                                            (3, 4099, 10.0, 0.7),
                                            (5, 257, 0.5, 2.3)])
def test_digital_aggregates_match_reference(r, d, clip, sigma):
    u = _f32(0.2 * np.random.default_rng(d).standard_normal((r, d)))
    key = 17 + r
    got = tagg.dp_fedavg_aggregate(torch.as_tensor(u), clip, sigma,
                                   prng.PRNGKey(key, "cpu"), r=r)
    want = jagg.dp_fedavg_aggregate(jnp.asarray(u), clip, sigma,
                                    jax.random.PRNGKey(key), r=r)
    # the normal draw is bit-equal (tests/test_torch_prng.py); the clip's
    # norms and the mean sum in another order: an ulp on a few values
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tagg.fedavg_aggregate(torch.as_tensor(u)),
                               np.asarray(jagg.fedavg_aggregate(
                                   jnp.asarray(u))), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("active", [False, True])
def test_sparsify_matches_reference(active):
    rng = np.random.default_rng(3)
    u = _f32(rng.standard_normal((3, 50)))
    idx = rng.permutation(50)[:20]
    act = _f32(rng.random(20) < 0.7) if active else None
    got = tcbase.sparsify(torch.as_tensor(u), tcbase.Support(
        torch.as_tensor(idx), None if act is None else torch.as_tensor(act)),
        50)
    jsup = jcbase.Support(jnp.asarray(idx),
                          None if act is None else jnp.asarray(act))
    want = jax.vmap(lambda v: jcbase.sparsify(v, jsup, 50))(jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dp_fedavg_charges_the_ledger_like_reference():
    trainer, state, x, y = _port_trainer(algorithm="dp_fedavg")
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    jtrainer, jstate, jx, jy = _jax_trainer(algorithm="dp_fedavg")
    jend, _ = jtrainer.run(jstate, jx, jy, rounds=ug.ROUNDS)
    got, want = trainer.ledger_totals(end), jtrainer.ledger_totals(jend)
    assert got["spends"] == want["spends"] == ug.ROUNDS
    for k in ("basic", "advanced"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    _, _, _, _, _, loss_fn = _port_problem()
    cfg = dataclasses.replace(trainer.cfg, algorithm="fedavg")
    fed = Trainer(cfg, loss_fn, _port_problem()[0], device="cpu")
    fend, _ = fed.run(fed.init(prng.PRNGKey(1, "cpu")), x, y, rounds=1)
    assert fed.ledger_totals(fend)["basic"] == (0.0, 0.0)
