"""The port's sharded cohort (``client_sharding="cohort"``) over real
``torch.distributed`` worlds of gloo ranks on the CPU.

The module spawns two worlds once, a world of 4 ranks and a world of 3,
each rank a fresh interpreter running this file as a script (it imports
``torch`` and ``repro_torch`` only), with one intra-op thread a rank and
``file://`` initialisation. Each rank runs every case of its world and
saves what it got; the tests compare the ranks with each other and with
the one-process port:

- the seven ``*-sharded`` golden rows (``tools/update_goldens.py``'s
  problem, r = 4 on 4 ranks: the reference's 4 shards of one client)
  against the committed digests, within the digests' rtol 2e-6;
- the reference's sharded-parity problem (BENCH_MLP, 30 clients, r = 8 on
  4 ranks, tau 2; ``tests/test_sharded_round.py``) through the legacy
  shims, against the one-process port at that file's tolerances (atol
  5e-5, rtol 5e-4; atol 1e-4 for the 2-round training fn);
- r = 5 on 3 ranks (``cohort_shape`` leaves one shard): bit-equal to the
  one-process port;
- r = 4 on 3 ranks (2 shards and one spare rank): within rtol 2e-6 of the
  one-process port's digests;
- the decode-hook ``ValueError`` on more than one shard;
- the production aggregate over a 2-rank group against the same sum in
  one process and against the reference's ``axis_name`` psum under
  ``jax.vmap``.

Every rank must end with the same bits: the all-reduce and the gathers
hand every rank the same result, and the rest of the round is replicated.
The parity cases' gaps come from f32 sums in another order: the gloo
ring sums the shards' partial MAC sums, where one process sums the
clients in one pass.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import BENCH_MLP, PFELSConfig  # noqa: E402
from repro_torch.core import aggregation, compressors, randk  # noqa: E402
from repro_torch.core.compressors import rand_k  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import (Trainer, make_round_fn,  # noqa: E402
                            make_training_fn, replace, setup)
from repro_torch.launch.mesh import cohort_shape  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import Unravel, ravel, tree_leaves  # noqa: E402

GOLDEN_PATH = os.path.join(ROOT, "tests", "goldens", "golden_digests.json")
RTOL = 2e-6               # live runs' rtol (tests/test_torch_round.py)
GOLDEN_RTOL = 1e-6        # the committed digests' (the reference's own)
METRIC_KEYS = ("train_loss", "update_norm", "beta", "energy",
               "subcarriers", "eps_round")

# the committed *-sharded rows and their configs (tools/update_goldens.py)
SHARDED_ROWS = {
    f"{alg}-sharded": dict(algorithm=alg, use_fused_kernel=False)
    for alg in ("pfels", "wfl_p", "wfl_pdp", "dp_fedavg", "fedavg")}
SHARDED_ROWS["pfels-sharded-fused"] = {}
SHARDED_ROWS["comp_stoch_quant-sharded"] = dict(
    compressor="stoch_quant", quant_bits=6, transmit_clip=0.5)

# the reference's sharded-parity problem (tests/test_sharded_round.py)
PARITY_BASE = dict(num_clients=30, clients_per_round=8, local_steps=2,
                   rounds=2)
PARITY_CASES = {
    "unfused": (dict(use_fused_kernel=False), None, 5e-5),
    "fused": (dict(use_fused_kernel=True), None, 5e-5),
    "error_feedback": (dict(error_feedback=True, transmit_clip=0.5), None,
                       5e-5),
    "training_fn": (dict(error_feedback=True), 2, 1e-4),
}
# r = 4 on 3 ranks: 2 shards of 2 clients and one spare rank
SPARE_CASES = {
    "pfels-fused": {},
    "pfels-error_feedback": dict(error_feedback=True, transmit_clip=0.5,
                                 use_fused_kernel=False),
    "fedavg": dict(algorithm="fedavg", use_fused_kernel=False),
    "comp_stoch_quant": dict(compressor="stoch_quant", quant_bits=6,
                             transmit_clip=0.5),
}
WORLDS = (4, 3)
TIMEOUT_S = 600


# ------------------------------------------------------------- problems

def _golden_base():
    with open(GOLDEN_PATH) as f:
        meta = json.load(f)["meta"]
    return meta["base"], meta["rounds"]


def _golden_problem():
    key = prng.PRNGKey(0, "cpu")
    params = cnn.init_cnn(key, BENCH_MLP, device="cpu")
    x, y, _, _ = make_federated_classification(
        key, n_clients=20, per_client=20, num_classes=10,
        image_shape=(1, 8, 8), device="cpu")
    return params, x, y


def _loss(p, b):
    return cnn.cnn_loss(p, BENCH_MLP, b)


def _trainer_run(cfg_kw, group=None):
    """``Trainer.run`` of the golden problem (init key 1, run key 2)."""
    base, rounds = _golden_base()
    params, x, y = _golden_problem()
    cfg = PFELSConfig(**{**base, **cfg_kw})
    trainer = Trainer(cfg, _loss, params, device="cpu", group=group)
    state = replace(trainer.init(prng.PRNGKey(1, "cpu")),
                    key=prng.PRNGKey(2, "cpu"))
    end, metrics = trainer.run(state, x, y, rounds=rounds)
    return {"shards": 1 if trainer.cohort is None else trainer.cohort.shards,
            "params": ravel(end.params), "prev_delta": end.prev_delta,
            "metrics": metrics,
            "ledger": [end.ledger.eps_sum, end.ledger.eps_max,
                       end.ledger.spends]}


def _parity_problem():
    key = prng.PRNGKey(0, "cpu")
    params = cnn.init_cnn(key, BENCH_MLP, device="cpu")
    x, y, _, _ = make_federated_classification(
        key, n_clients=30, per_client=30, num_classes=10,
        image_shape=(1, 8, 8), device="cpu")
    return params, x, y


def _shim_run(cfg_kw, t_rounds=None, group=None):
    """The reference test's ``_run``: ``setup`` and ``make_round_fn`` (or
    ``make_training_fn`` over ``t_rounds``) on the parity problem."""
    params, x, y = _parity_problem()
    unravel = Unravel(params)
    cfg = PFELSConfig(**{**PARITY_BASE, **cfg_kw})
    st = setup(prng.PRNGKey(1, "cpu"), params, cfg, unravel.d)
    if t_rounds is not None:
        fn = make_training_fn(cfg, _loss, unravel.d, unravel,
                              rounds=t_rounds, group=group, device="cpu")
    else:
        fn = make_round_fn(cfg, _loss, unravel.d, unravel, group=group,
                           device="cpu")
    return fn(params, st.power_limits, x, y, prng.PRNGKey(2, "cpu"),
              residuals=st.residuals)


def _aggregate_inputs(rank):
    """One client's update tree (from ``rank``), the shared masks and the
    aggregate's scalars."""
    g = torch.Generator().manual_seed(100 + rank)
    tree = {"a": torch.randn((7, 5), generator=g),
            "b": {"w": torch.randn((33,), generator=g)}}
    km, kn = prng.split(prng.PRNGKey(7, "cpu"))
    masks = randk.mask_tree(km, tree, 0.3)
    return tree, masks, dict(beta=torch.tensor(7.3), r=2, sigma0=1.3,
                             noise_key=kn, unbiased_rescale=True,
                             compression_p=0.3)


# ------------------------------------------------------------ the ranks

def _decode_hook_refused():
    compressors.register_compressor("rand_k_decoded", dataclasses.replace(
        compressors.get_compressor("rand_k"), name="rand_k_decoded",
        select_support=rand_k.select_support,
        decode=lambda cfg, y, sup, d: compressors.decode_support(y, sup,
                                                                 d)))
    try:
        Trainer(PFELSConfig(**{**_golden_base()[0],
                               "client_sharding": "cohort",
                               "compressor": "rand_k_decoded"}),
                _loss, _golden_problem()[0], device="cpu")
    except ValueError as e:
        return "decode hook" in str(e)
    finally:
        compressors.unregister_compressor("rand_k_decoded")
    return False


def _rank_main(rank: int, world: int, init_file: str, out: str) -> None:
    if "jax" in sys.modules or "repro" in sys.modules:
        raise RuntimeError("a rank imported the JAX reference")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    got = {}
    try:
        if world == 4:
            for name, kw in SHARDED_ROWS.items():
                got[name] = _trainer_run(dict(kw, client_sharding="cohort"))
            for name, (kw, t_rounds, _) in PARITY_CASES.items():
                got[f"parity-{name}"] = _shim_run(
                    dict(kw, client_sharding="cohort"), t_rounds)
            got["decode_hook_refused"] = _decode_hook_refused()
            pair = dist.new_group([0, 1])
            if rank < 2:
                tree, masks, kw = _aggregate_inputs(rank)
                got["production_aggregate"] = \
                    aggregation.pfels_production_aggregate(
                        tree, masks, group=pair, **kw)
        else:
            got["r5"] = _shim_run(dict(clients_per_round=5,
                                       client_sharding="cohort"))
            for name, kw in SPARE_CASES.items():
                got[f"spare-{name}"] = _trainer_run(
                    dict(kw, client_sharding="cohort"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(got, os.path.join(out, f"world{world}_rank{rank}.pt"))


@pytest.fixture(scope="module")
def worlds():
    """Both worlds' ranks run at once; -> {world: [rank 0's results,
    ...]}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for world in WORLDS:
            init = os.path.join(tmp, f"init{world}")
            procs += [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(world), init, tmp], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for rank in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return {world: [torch.load(os.path.join(
            tmp, f"world{world}_rank{rank}.pt"), weights_only=False)
            for rank in range(world)] for world in WORLDS}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- checks

def _digest_arr(t):
    a = np.asarray(t, np.float64)
    return [float(a.sum()), float(np.abs(a).sum()), float((a * a).sum())]


def _digest(run):
    return {"params": _digest_arr(run["params"]),
            "prev_delta": _digest_arr(run["prev_delta"]),
            "metrics": {k: [float(v) for v in run["metrics"][k].double()]
                        for k in METRIC_KEYS},
            "ledger": {"eps_sum": float(run["ledger"][0]),
                       "eps_max": float(run["ledger"][1]),
                       "spends": int(run["ledger"][2])}}


def _assert_close(path, got, want, rtol=RTOL):
    if isinstance(want, dict):
        for k in want:
            _assert_close(f"{path}.{k}", got[k], want[k], rtol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(f"{path}[{i}]", g, w, rtol)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=1e-12), \
            f"{path}: want {want!r}, got {got!r}"
    else:
        assert got == want, f"{path}: want {want!r}, got {got!r}"


def _leaves(out):
    """The tensors of a run or a shim's output, in a fixed order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return [torch.as_tensor(out)]


def _assert_ranks_bit_equal(ranks, name):
    first = _leaves(ranks[0][name])
    for i, other in enumerate(ranks[1:], 1):
        for a, b in zip(first, _leaves(other[name])):
            assert torch.equal(a, b), f"{name}: rank {i} differs from 0"


@pytest.mark.parametrize("r,n_dev,want", [
    (32, 8, (2, 4)), (8, 8, (2, 4)), (5, 8, (1, 5)), (6, 4, (1, 3)),
    (7, 4, (1, 1)), (1, 8, (1, 1)), (9, 3, (1, 3))])
def test_cohort_shape_matches_reference(r, n_dev, want):
    """The reference test's seven cases (tests/test_sharded_round.py),
    and the reference's function."""
    from repro.launch.mesh import cohort_shape as j_cohort_shape
    assert cohort_shape(r, n_dev) == want == j_cohort_shape(r, n_dev)


@pytest.mark.parametrize("case", sorted(SHARDED_ROWS))
def test_sharded_golden_rows_on_four_ranks(worlds, case):
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)["cases"][case]
    assert golden["needs_devices"] == 8
    ranks = worlds[4]
    assert ranks[0][case]["shards"] == 4
    got = _digest(ranks[0][case])
    _assert_close(case, got, {k: golden[k] for k in got},
                  GOLDEN_RTOL)
    _assert_ranks_bit_equal(ranks, case)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_sharded_shims_match_one_process(worlds, case):
    kw, t_rounds, atol = PARITY_CASES[case]
    want = _shim_run(kw, t_rounds)
    got = worlds[4][0][f"parity-{case}"]
    for w, g in zip(_leaves(want), _leaves(got)):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   atol=atol, rtol=5e-4)
    _assert_ranks_bit_equal(worlds[4], f"parity-{case}")


def test_one_shard_on_three_ranks_is_the_unsharded_round(worlds):
    """r = 5 on 3 ranks: ``cohort_shape(5, 3)`` is (1, 1), so every rank
    runs the one-process round, bit for bit."""
    want = _shim_run(dict(clients_per_round=5))
    for rank in worlds[3]:
        for w, g in zip(_leaves(want), _leaves(rank["r5"])):
            assert torch.equal(w, g)


@pytest.mark.parametrize("case", sorted(SPARE_CASES))
def test_spare_rank_ends_with_the_replicated_state(worlds, case):
    """r = 4 on 3 ranks: 2 shards of 2 clients; the third rank holds no
    client, adds zeros to the sums and ends bit-equal to the others."""
    assert worlds[3][0][f"spare-{case}"]["shards"] == 2
    want = _digest(_trainer_run(SPARE_CASES[case]))
    got = _digest(worlds[3][0][f"spare-{case}"])
    _assert_close(case, got, want)
    _assert_ranks_bit_equal(worlds[3], f"spare-{case}")


def test_decode_hook_refused_on_more_than_one_shard(worlds):
    assert all(rank["decode_hook_refused"] for rank in worlds[4])


def test_production_aggregate_over_two_ranks(worlds):
    """Each of ranks 0 and 1 holds one client's update; the all-reduced
    aggregate equals the same superposition computed in one process."""
    trees, masks, kw = [], None, None
    for rank in (0, 1):
        tree, masks, kw = _aggregate_inputs(rank)
        trees.append(tree)
    leaves = [tree_leaves(t) for t in trees]
    keys = prng.split(kw["noise_key"], len(leaves[0]))
    scale = 1.0 / (kw["r"] * kw["beta"]) / torch.tensor(kw["compression_p"])
    want = []
    for j, (m, k) in enumerate(zip(tree_leaves(masks), keys)):
        mf = m.float()
        summed = (leaves[0][j] * mf) * kw["beta"] + \
            (leaves[1][j] * mf) * kw["beta"]
        z = prng.normal(k, tuple(summed.shape))
        want.append((summed + (kw["sigma0"] * mf) * z) * scale)
    for rank in worlds[4][:2]:
        for w, g in zip(want, tree_leaves(rank["production_aggregate"])):
            assert torch.equal(w, g)
    assert "production_aggregate" not in worlds[4][2]



def test_production_aggregate_over_two_ranks_matches_reference(worlds):
    """The 2-rank all-reduce against the reference's ``axis_name`` route:
    its ``psum`` over the two clients' updates under ``jax.vmap``, with
    the same masks and noise key, to rounding: the draws are bit-equal,
    but the group route adds the noise after the all-reduce, where XLA
    contracts the beta product into the noise add
    (tests/test_torch_llm_train.py)."""
    import jax
    import jax.numpy as jnp
    from repro.core import aggregation as jagg
    from repro.core import randk as jrandk

    trees = [_aggregate_inputs(rank)[0] for rank in (0, 1)]
    _, masks, kw = _aggregate_inputs(0)
    with jax.threefry_partitionable(False):
        km, kn = jax.random.split(jax.random.PRNGKey(7))
        stacked = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x.numpy()) for x in xs]),
            *trees)
        jmasks = jrandk.mask_tree(km, jax.tree.map(lambda x: x[0], stacked),
                                  kw["compression_p"])
        for t, j in zip(tree_leaves(masks), jax.tree.leaves(jmasks)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        jout = jax.vmap(lambda u: jagg.pfels_production_aggregate(
            u, jmasks, beta=jnp.float32(float(kw["beta"])), r=kw["r"],
            sigma0=kw["sigma0"], noise_key=kn, axis_name="c",
            unbiased_rescale=kw["unbiased_rescale"],
            compression_p=kw["compression_p"]), axis_name="c")(stacked)
    for rank in (0, 1):
        got = tree_leaves(worlds[4][rank]["production_aggregate"])
        for g, j in zip(got, jax.tree.leaves(jout)):
            j = np.asarray(j)[rank]
            np.testing.assert_allclose(g.numpy(), j, rtol=1e-6,
                                       atol=1e-6 * np.abs(j).max())

if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
