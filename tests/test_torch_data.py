"""The port's data module against ``repro.data``: the Dirichlet label
skew of ``make_federated_classification``, ``make_population_source``,
and the cohort sources and prefetcher of ``data/loader.py``.

Labels and images are held bit for bit: the draws are
``jax.random``'s (``tests/test_torch_prng.py``), and the population
source's cohort adds its noise as the reference's jitted cohort does (one
rounding, ``prng.normal_fma``).
"""
import threading
import time

import jax
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.data import loader as jloader
from repro.data import synthetic as jsyn
from repro_torch import prng
from repro_torch.data import loader, synthetic



@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.mark.parametrize("alpha", [0.5, 0.1])
def test_dirichlet_branch_matches_reference(alpha):
    kw = dict(n_clients=40, per_client=30, num_classes=62,
              image_shape=(1, 7, 7), alpha=alpha)
    want = jax.device_get(jsyn.make_federated_classification(
        jax.random.PRNGKey(4), **kw))
    got = synthetic.make_federated_classification(
        prng.PRNGKey(4, "cpu"), device="cpu", **kw)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    # the skew: a client's labels concentrate on few classes, unlike IID
    iid = synthetic.make_federated_classification(
        prng.PRNGKey(4, "cpu"), device="cpu", **dict(kw, alpha=None))[1]

    def distinct(y):
        return np.mean([len(set(row.tolist())) for row in y])

    assert distinct(got[1]) < distinct(iid)


def test_population_source_matches_reference():
    kw = dict(n_clients=100_000, per_client=12, num_classes=10,
              image_shape=(3, 4, 4))
    jsrc, jxt, jyt = jsyn.make_population_source(jax.random.PRNGKey(2),
                                                 **kw)
    src, xt, yt = synthetic.make_population_source(prng.PRNGKey(2, "cpu"),
                                                   device="cpu", **kw)
    assert isinstance(src, loader.ClientFnSource) and src.n == 100_000
    sel = np.array([0, 99_999, 5, 12_345], np.int32)
    jx, jy = jax.device_get(jsrc.cohort(sel))
    x, y = src.cohort(torch.as_tensor(sel))
    assert x.shape == (4, 12, 3, 4, 4) and y.shape == (4, 12)
    assert np.array_equal(y.numpy(), jy)
    assert np.array_equal(x.numpy(), jx)
    assert np.array_equal(yt.numpy(), np.asarray(jyt))
    assert np.array_equal(xt.numpy(), np.asarray(jxt))
    # deterministic in the client id, whichever cohort asks
    x2, y2 = src.cohort(torch.as_tensor([5]))
    assert torch.equal(x2[0], x[2]) and torch.equal(y2[0], y[2])


def test_array_source_and_as_cohort_source():
    x = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    y = torch.arange(15).reshape(5, 3)
    src = loader.as_cohort_source(x, y)
    assert isinstance(src, loader.ArraySource) and src.n == 5
    cx, cy = src.cohort(torch.tensor([4, 0]))
    assert torch.equal(cx, x[[4, 0]]) and torch.equal(cy, y[[4, 0]])
    assert loader.as_cohort_source(src) is src
    with pytest.raises(ValueError, match="not both"):
        loader.as_cohort_source(src, y)
    with pytest.raises(ValueError, match="data_y is required"):
        loader.as_cohort_source(x)
    assert loader.epoch_batches(120, 50) == jloader.epoch_batches(120, 50)
    assert loader.epoch_batches(10, 50) == 1


def test_prefetch_yields_cohorts_in_round_order():
    src = loader.ArraySource(torch.arange(10.0)[:, None],
                             torch.arange(10)[:, None])
    sels = [torch.tensor([i, (i + 3) % 10]) for i in range(7)]
    got = [(cx[:, 0].tolist(), cy[:, 0].tolist())
           for cx, cy in loader.prefetch_cohorts(src, sels, device="cpu")]
    assert got == [([float(i), float((i + 3) % 10)], [i, (i + 3) % 10])
                   for i in range(7)]


class _Failing(loader.CohortSource):
    n = 10

    def cohort(self, sel):
        if int(sel[0]) == 2:
            raise RuntimeError("client 2 is unreachable")
        return torch.zeros((1, 1)), torch.zeros((1,), dtype=torch.long)


def test_prefetch_reraises_worker_errors_at_the_consuming_round():
    seen = []
    with pytest.raises(RuntimeError, match="client 2 is unreachable"):
        for cx, _ in loader.prefetch_cohorts(
                _Failing(), [torch.tensor([i]) for i in range(5)]):
            seen.append(cx)
    assert len(seen) == 2


class _Counting(loader.CohortSource):
    n = 1000

    def __init__(self):
        self.calls = 0

    def cohort(self, sel):
        self.calls += 1
        return torch.zeros((1, 1)), torch.zeros((1,), dtype=torch.long)


def test_abandoned_prefetch_never_leaves_the_worker_blocked():
    """A consumer that stops early (it raised, or broke out of the loop):
    the worker stops within its put timeout instead of blocking on a full
    queue, and makes no more cohorts than the queue's depth allows."""
    before = {t.ident for t in threading.enumerate()}
    src = _Counting()
    gen = loader.prefetch_cohorts(src, (torch.tensor([i])
                                        for i in range(1000)), depth=2)
    next(gen)
    gen.close()
    deadline = time.time() + 5
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "cohort-prefetch" and t.ident not in before]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive
    assert src.calls <= 5
