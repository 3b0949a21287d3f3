"""The port's channel models, compressors and schedules against the
reference on the CPU.

- The 22 single-device ``chan_*`` and ``comp_*`` golden rows, each built
  from ``tools/update_goldens.py``'s ``_cases()``, through the port's
  ``Trainer.run`` against the committed digests at the rtol 2e-6 of
  ``tests/test_torch_round.py``'s ``GOLDEN_RTOL`` of 1e-6 (measured at
  most 5.9e-7: the round-1 energy of ``chan_dropout-fused``).
- Live reference runs (under ``jax.threefry_partitionable(False)``) for
  what no golden row holds: dropout under ``fedavg`` and ``dp_fedavg``
  with rounds where every client drops, ``markov_fading`` under
  ``csi_error > 0``, ``top_k_ef`` forcing the bank's residual memory with
  ``error_feedback=False`` on both banks, and a JAX state taken after a
  ``markov_fading`` round carried into the port.
- The pieces on their own: top-k ties, the quantizer, the schedules, the
  antenna gains, the dropout mask, the unfused aggregate's noise add, the
  ``decode`` hook, the registries.

What is bit-exact: the dropout mask, the Markov latent's AR(1) step (the
constant folded into the draw and ``rho z`` contracted into an FMA, as
the reference's jitted round computes it) and its gains (XLA's ``ndtr``
and ``log1p``, ``repro_torch.prng``), and the MIMO antenna gains and
their combine (summed in XLA's order), so a Markov run's carried latent
equals the reference's bit for bit. What is left between the digests is
f32 sums in another order in local training. ``top_k_ef`` and
``threshold`` select by magnitude, so an ulp in ``Delta_hat`` can
reorder two magnitudes that the reference has equal: the unfused
aggregate adds the receiver noise as XLA's CPU backend does
(``prng.normal_fma``), and with it ``comp_top_k_ef-unfused`` went from
2.7e-5 (a tie at coordinates 14546 and 21929 broken the other way in
round 1) to 5.1e-7.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from test_torch_round import (GOLDEN_RTOL, RTOL, _assert_close,
                              _jax_digest,
                              _jax_trainer, _port_digest, _port_problem,
                              _port_trainer)
from test_torch_streamed import _assert_bit_equal

import update_goldens as ug
from repro.configs import ChannelConfig as JChannel
from repro.configs import CompressionSchedule as JSchedule
from repro.core import channels as jchannels
from repro.core import compressors as jcomp
from repro_torch import convert, prng
from repro_torch.configs import (ChannelConfig, CompressionSchedule,
                                 PFELSConfig)
from repro_torch.core import channels, compressors
from repro_torch.core.channels import dropout, markov, mimo
from repro_torch.core.compressors import quant, rand_k, schedules
from repro_torch.fl import Trainer

SCENARIO_ROWS = sorted(
    n for n, (_, _, devices) in ug._cases().items()
    if devices == 1 and n.startswith(("chan_", "comp_")))


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _port_kw(cfg_kw, chan_kw):
    """A golden case's overrides with the port's config types."""
    kw = dict(cfg_kw)
    if "schedule" in kw:
        kw["schedule"] = CompressionSchedule(
            **dataclasses.asdict(kw["schedule"]))
    if chan_kw:
        kw["channel"] = ChannelConfig(**chan_kw)
    return kw


def test_scenario_rows_are_the_reference_s_22():
    assert len(SCENARIO_ROWS) == 22
    assert sum(n.startswith("chan_") for n in SCENARIO_ROWS) == 12


@pytest.mark.parametrize("case", SCENARIO_ROWS)
def test_run_reproduces_committed_scenario_rows(case):
    with open(ug.GOLDEN_PATH) as f:
        golden = json.load(f)["cases"][case]
    cfg_kw, chan_kw, _ = ug._cases()[case]
    trainer, state, x, y = _port_trainer(**_port_kw(cfg_kw, chan_kw))
    end, metrics = trainer.run(state, x, y, rounds=ug.ROUNDS)
    got = _port_digest(end, metrics)
    _assert_close(case, got, {k: golden[k] for k in got},
                  GOLDEN_RTOL)
    stateful = chan_kw.get("model") == "markov_fading"
    assert (end.chan is not None) == stateful
    if compressors.carry_required(trainer.cfg):
        assert end.residuals is not None


def _live(port_kw, jax_kw, rounds):
    trainer, state, x, y = _port_trainer(**port_kw)
    end, metrics = trainer.run(state, x, y, rounds=rounds)
    jtrainer, jstate, jx, jy = _jax_trainer(**jax_kw)
    jend, jmetrics = jtrainer.run(jstate, jx, jy, rounds=rounds)
    return end, metrics, jend, jmetrics


@pytest.mark.parametrize("algorithm", ["fedavg", "dp_fedavg"])
def test_dropout_digital_schemes_match_reference(algorithm):
    """p = 0.9 drops every client in rounds 1 and 2 and none of the
    third's cohort but one: those rounds apply no update, the third
    rescales to the realized count."""
    end, metrics, jend, jmetrics = _live(
        dict(algorithm=algorithm,
             channel=ChannelConfig(model="dropout", dropout_prob=0.9)),
        dict(algorithm=algorithm,
             channel=JChannel(model="dropout", dropout_prob=0.9)), 3)
    assert metrics["r_realized"].tolist() == [0.0, 0.0, 3.0]
    assert np.array_equal(metrics["r_realized"].numpy(),
                          np.asarray(jmetrics["r_realized"]))
    _assert_close(algorithm, _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))


def test_markov_with_imperfect_csi_matches_reference():
    chan = dict(model="markov_fading", markov_rho=0.9, csi_error=0.2)
    end, metrics, jend, jmetrics = _live(
        dict(channel=ChannelConfig(**chan)), dict(channel=JChannel(**chan)),
        ug.ROUNDS)
    _assert_close("markov+csi", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    assert np.array_equal(end.chan.numpy(), np.asarray(jend.chan))


@pytest.mark.parametrize("backend", ["resident", "streamed"])
def test_top_k_ef_forces_the_bank_s_residuals(backend):
    """``error_feedback=False``: the compressor's ``carry`` turns the
    residual memory on in the bank and the round, as in the reference."""
    kw = dict(compressor="top_k_ef", transmit_clip=0.5,
              error_feedback=False, bank_backend=backend)
    end, metrics, jend, jmetrics = _live(kw, kw, ug.ROUNDS)
    _assert_close("top_k_ef", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    want = np.asarray(jend.bank.residuals)
    got = end.residuals.cpu().numpy()
    assert got.shape == want.shape
    seen = np.asarray(jend.bank.counts) > 0
    assert np.array_equal(got.any(axis=1), seen)
    assert np.array_equal(want.any(axis=1), seen)
    # the updates' own gap: local training sums in another order
    # (measured 1.06e-6 of max|residual|, the draws bit-equal)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    assert np.array_equal(end.bank.counts.cpu().numpy(),
                          np.asarray(jend.bank.counts))


def test_markov_state_carried_from_jax_continues_as_reference():
    """A JAX state after round 1 of ``chan_markov`` (its (N,) latent in
    ``chan``) continues in the port as the reference's round 2 does."""
    cfg_kw, chan_kw, _ = ug._cases()["chan_markov"]
    trainer, _, x, y = _port_trainer(**_port_kw(cfg_kw, chan_kw))
    jtrainer, jstate, jx, jy = _jax_trainer(channel=JChannel(**chan_kw),
                                            **cfg_kw)
    j1, _ = jtrainer.run(jstate, jx, jy, rounds=1)
    carried = convert.train_state_from_jax(jax.device_get(j1), "cpu")
    assert carried.chan.dtype == torch.float32
    assert np.array_equal(carried.chan.numpy(), np.asarray(j1.chan))
    end, metrics = trainer.run(carried, x, y, rounds=1)
    jend, jmetrics = jtrainer.run(j1, jx, jy, rounds=1)
    _assert_close("carried markov", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))
    assert np.array_equal(end.chan.numpy(), np.asarray(jend.chan))


@pytest.mark.parametrize("overrides", [
    dict(channel=ChannelConfig(model="markov_fading")),
    dict(channel=ChannelConfig(model="dropout", dropout_prob=0.4),
         error_feedback=True, transmit_clip=0.5),
    dict(compressor="threshold", threshold_frac=0.3,
         schedule=CompressionSchedule(mode="budget", k_end_ratio=0.5,
                                      eps_floor=0.1)),
    dict(compressor="stoch_quant", quant_bits=4, transmit_clip=0.5,
         channel=ChannelConfig(model="mimo_mrc", num_antennas=3)),
], ids=["markov", "dropout_ef", "threshold_budget", "quant_mimo"])
def test_streamed_bit_equal_to_resident(overrides):
    runs = []
    for backend in ("resident", "streamed"):
        trainer, state, x, y = _port_trainer(bank_backend=backend,
                                             **overrides)
        runs.append(trainer.run(state, x, y, rounds=ug.ROUNDS))
    (a, am), (b, bm) = runs
    _assert_bit_equal(a, am, b, bm)
    if a.chan is not None:
        assert torch.equal(a.chan, b.chan)


# --------------------------------------------------------- the pieces

def _top_k_vectors():
    rng = np.random.default_rng(3)
    sparse = np.zeros(200, np.float32)
    sparse[rng.choice(200, 30, replace=False)] = rng.standard_normal(30)
    repeated = rng.integers(0, 4, 300).astype(np.float32)
    signed = np.repeat(np.float32([0.5, -0.5, 0.25, -0.25]), 40)
    rng.shuffle(signed)
    return [("zeros_past_support", sparse, 50),
            ("all_equal", np.ones(64, np.float32), 17),
            ("repeated_at_kth", repeated, 101),
            ("equal_magnitudes", signed, 60)]


@pytest.mark.parametrize("name,x,k", _top_k_vectors(),
                         ids=[v[0] for v in _top_k_vectors()])
def test_top_k_ties_match_reference(name, x, k):
    """``jax.lax.top_k`` takes the lower index among equal values; the
    port's selection (``rand_k.top_k_indices``) must too, and so must
    ``top_k_ef``'s and ``threshold``'s supports built on it."""
    want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)[1])
    got = rand_k.top_k_indices(torch.abs(torch.from_numpy(x)), k).numpy()
    assert np.array_equal(got, want)
    cfg = PFELSConfig(threshold_frac=0.6)
    key = prng.PRNGKey(4, "cpu")
    jkey = jax.random.PRNGKey(4)
    for name_ in ("top_k_ef", "threshold"):
        sup = compressors.get_compressor(name_).select_support(
            cfg, x.size, k, torch.from_numpy(x), key)
        jsup = jcomp.get_compressor(name_).select_support(
            cfg, x.size, k, jnp.asarray(x), jkey)
        assert np.array_equal(sup.idx.numpy(), np.asarray(jsup.idx))
        if jsup.active is not None:
            assert np.array_equal(sup.active.numpy(),
                                  np.asarray(jsup.active))


@pytest.mark.parametrize("sigma0", [1.0, 8.0 ** 0.5])
def test_unfused_receive_matches_xla_s_fused_noise_add(sigma0):
    """The reference's jitted ``y = einsum + sigma0 * normal`` on XLA's
    CPU backend: the port's ``prng.normal_fma`` gives the same y, bit for
    bit (the superposition plus a separately rounded noise gave about
    73%)."""
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation
    rng = np.random.default_rng(1)
    r, d, k = 4, 26_122, 7_837
    u = (rng.standard_normal((r, d)) * 1e-2).astype(np.float32)
    idx = rng.permutation(d)[:k].astype(np.int32)
    g = (rng.random(r) * 0.05 + 0.01).astype(np.float32)
    beta = np.float32(6.1)
    want = np.asarray(jax.jit(lambda *a: jagg.aircomp_aggregate(
        *a, d=d, sigma0=sigma0, r=r)[2])(u, idx, g, beta,
                                          jax.random.PRNGKey(5)))
    got = aggregation.aircomp_aggregate(
        torch.from_numpy(u), torch.from_numpy(idx).long(),
        torch.from_numpy(g), torch.tensor(beta), prng.PRNGKey(5, "cpu"),
        d=d, sigma0=sigma0, r=r)[2].numpy()
    np.testing.assert_array_equal(got, want)


def test_cold_start_supports_are_rand_k():
    cfg = PFELSConfig()
    zeros = torch.zeros(500)
    key = prng.PRNGKey(9, "cpu")
    for name in ("top_k_ef", "threshold"):
        sup = compressors.get_compressor(name).select_support(
            cfg, 500, 40, zeros, key)
        jsup = jcomp.get_compressor(name).select_support(
            cfg, 500, 40, jnp.zeros(500), jax.random.PRNGKey(9))
        assert np.array_equal(sup.idx.numpy(), np.asarray(jsup.idx))
        assert (sup.active is None) == (name == "top_k_ef")


def test_stoch_quant_encode_matches_reference():
    """Bit-equal levels; values within an ulp of the norm (the port sums
    each row's squares pairwise, ``core/clipping.row_norms``)."""
    rng = np.random.default_rng(5)
    u = (rng.standard_normal((3, 5000)) * 0.01).astype(np.float32)
    u[1] = 0.0
    cfg = PFELSConfig(compressor="stoch_quant", quant_bits=6)
    keys = prng.split(prng.PRNGKey(7, "cpu"), 3)
    got = quant.encode(cfg, torch.from_numpy(u), keys).numpy()
    want = np.asarray(jcomp.quant.encode(
        cfg, jnp.asarray(u), jax.random.split(jax.random.PRNGKey(7), 3)))
    s = 31.0
    scale = np.linalg.norm(u.astype(np.float64), axis=1, keepdims=True)
    scale[scale == 0] = 1.0
    assert np.array_equal(np.rint(got / scale * s), np.rint(want / scale * s))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not got[1].any()
    assert quant.sensitivity(cfg, 10_000) == \
        jcomp.quant.sensitivity(cfg, 10_000) == 1.0 + 100.0 / s


@pytest.mark.parametrize("sched", [
    dict(mode="linear", k_end_ratio=0.5, power_end=0.7),
    dict(mode="budget", k_end_ratio=0.3, eps_floor=0.1),
    dict(mode="budget", power_end=0.4, eps_floor=0.4),
], ids=["linear", "budget_k", "budget_power"])
def test_schedules_match_reference(sched):
    cfg = PFELSConfig(rounds=7, epsilon=1.5)
    tsched, jsched = CompressionSchedule(**sched), JSchedule(**sched)
    for t, spent in ((0, 0.0), (2, 2.9), (5, 9.5), (9, 11.0)):
        tt = torch.tensor(t, dtype=torch.int32)
        ts = torch.tensor(spent, dtype=torch.float32)
        pairs = [(schedules.k_active(tsched, cfg, 1000, tt),
                  jcomp.schedules.k_active(jsched, cfg, 1000, t)),
                 (schedules.power_scale(tsched, cfg, tt),
                  jcomp.schedules.power_scale(jsched, cfg, t)),
                 (schedules.epsilon_round(tsched, cfg, tt, ts),
                  jcomp.schedules.epsilon_round(jsched, cfg, t, spent))]
        for got, want in pairs:
            assert (got is None) == (want is None)
            if got is not None:
                assert np.array_equal(got.numpy(),
                                      np.asarray(want, np.float32)), (t, got)


def test_antenna_gains_and_mrc_match_reference():
    cfg = ChannelConfig(model="mimo_mrc", num_antennas=4)
    key = prng.PRNGKey(11, "cpu")
    jcfg = JChannel(model="mimo_mrc", num_antennas=4)
    ant = mimo.antenna_gains(key, 6, cfg)
    want = np.asarray(jchannels.mimo.antenna_gains(
        jax.random.PRNGKey(11), 6, jcfg))
    assert ant.shape == (6, 4)
    assert np.array_equal(ant.numpy(), want)
    for m in (4, 5, 8, 33):
        a = prng.uniform(prng.PRNGKey(m, "cpu"), (40, m))
        assert np.array_equal(
            mimo.combine_mrc(a).numpy(),
            np.asarray(jchannels.mimo.combine_mrc(jnp.asarray(a.numpy()))))
    one = ChannelConfig(model="mimo_mrc", num_antennas=1)
    _, cr = mimo._step(None, one, 6, None, key, key)
    _, base = channels.get_channel_model("block_fading").step(
        None, one, 6, None, key, key)
    assert torch.equal(cr.gains, base.gains)
    assert channels.effective_noise_std(cfg) == \
        jchannels.effective_noise_std(jcfg) == 2.0


def test_dropout_mask_matches_reference():
    cfg = ChannelConfig(model="dropout", dropout_prob=0.3)
    jcfg = JChannel(model="dropout", dropout_prob=0.3)
    for seed in range(4):
        key = prng.PRNGKey(seed, "cpu")
        _, cr = dropout._step(None, cfg, 64, None, key, key)
        _, jcr = jchannels.dropout._step(None, jcfg, 64, None,
                                         jax.random.PRNGKey(seed),
                                         jax.random.PRNGKey(seed))
        assert np.array_equal(cr.tx_mask.numpy(), np.asarray(jcr.tx_mask))
    u = prng.uniform(prng.PRNGKey(2, "cpu"), (1000,))
    assert torch.equal(prng.bernoulli(prng.PRNGKey(2, "cpu"), 0.7, (1000,)),
                       u < 0.7)


def test_markov_gains_close_to_reference():
    """The copula transform on the same latent: bit-equal (XLA's ndtr and
    log1p), the gains near their clip of 5 x the mean included."""
    cfg = ChannelConfig(model="markov_fading")
    z = np.array(jax.random.normal(jax.random.PRNGKey(0), (20_000,)))
    z = np.concatenate([z, np.linspace(-6.0, 6.0, 4001, dtype=np.float32)])
    got = markov._gains_from_latent(torch.from_numpy(z), cfg).numpy()
    want = np.asarray(jchannels.markov._gains_from_latent(
        jnp.asarray(z), JChannel(model="markov_fading")))
    assert np.array_equal(got, want)


def test_registries():
    """Every reference name is registered; unknown names raise the
    reference's ``KeyError``; a model that masks without ``may_mask``
    is refused by the round."""
    assert channels.list_channel_models() == \
        jchannels.list_channel_models()
    assert compressors.list_compressors() == jcomp.list_compressors()
    with pytest.raises(KeyError, match="unknown channel model"):
        channels.get_channel_model("nope")
    with pytest.raises(KeyError, match="unknown compressor"):
        compressors.get_compressor("nope")
    assert compressors.carry_required(PFELSConfig(compressor="top_k_ef"))
    assert not compressors.carry_required(PFELSConfig())
    assert compressors.get_compressor("threshold").dynamic_support(None)
    assert channels.get_channel_model("markov_fading").stateful(None)
    assert channels.get_channel_model("dropout").may_mask(ChannelConfig())
    sup = compressors.and_active(
        compressors.Support(torch.tensor([3, 0]), torch.tensor([1.0, 1.0])),
        torch.tensor([1.0, 0.0]))
    assert compressors.dense_mask(sup, 5).tolist() == [0, 0, 0, 1, 0]

    base = channels.get_channel_model("block_fading")

    def masking_step(carry, cfg, r, sel, gains_key, csi_key):
        carry, cr = base.step(carry, cfg, r, sel, gains_key, csi_key)
        return carry, cr._replace(tx_mask=torch.ones(r))

    channels.register_channel_model("masks_unannounced", channels.ChannelModel(
        name="masks_unannounced", init=base.init, step=masking_step,
        noise_std=base.noise_std))
    try:
        with pytest.raises(ValueError, match="already registered"):
            channels.register_channel_model(
                "masks_unannounced", channels.get_channel_model("mimo_mrc"))
        trainer, state, x, y = _port_trainer(
            channel=ChannelConfig(model="masks_unannounced"))
        with pytest.raises(ValueError, match="may_mask"):
            trainer.step(state, x, y)
    finally:
        channels.unregister_channel_model("masks_unannounced")
    assert "masks_unannounced" not in channels.list_channel_models()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decode_hook_replaces_the_unprojection(fused):
    """A compressor's ``decode`` takes the place of A^T y, and the round
    still unscales by r beta: with ``decode_support`` as the hook the run
    is rand-k's bit for bit."""
    rk = compressors.get_compressor("rand_k")
    compressors.register_compressor("rand_k_decoded", compressors.Compressor(
        name="rand_k_decoded", select_support=rk.select_support,
        decode=lambda cfg, y, sup, d: compressors.decode_support(y, sup, d)))
    try:
        runs = []
        for name in ("rand_k", "rand_k_decoded"):
            trainer, state, x, y = _port_trainer(compressor=name,
                                                 use_fused_kernel=fused)
            runs.append(trainer.run(state, x, y, rounds=ug.ROUNDS))
    finally:
        compressors.unregister_compressor("rand_k_decoded")
    (a, am), (b, bm) = runs
    _assert_bit_equal(a, am, b, bm)


def test_check_ported_refuses_only_sharding():
    params, _, _, _, _, loss_fn = _port_problem()
    for kw in (dict(channel=ChannelConfig(model="dropout")),
               dict(compressor="stoch_quant"),
               dict(schedule=CompressionSchedule(mode="linear"))):
        Trainer(dataclasses.replace(PFELSConfig(**ug.BASE), **kw), loss_fn,
                params, device="cpu")
    # the sharded cohort is ported: in one process it is one shard
    trainer = Trainer(dataclasses.replace(PFELSConfig(**ug.BASE),
                                          client_sharding="cohort"),
                      loss_fn, params, device="cpu")
    assert trainer.cohort.shards == 1
    with pytest.raises(ValueError, match="unknown client_sharding"):
        Trainer(dataclasses.replace(PFELSConfig(**ug.BASE),
                                    client_sharding="pods"),
                loss_fn, params, device="cpu")
