"""The port's multi-pod PFELS step (``launch.steps.make_pfels_train_step``
with ``n_clients`` > 1) and the ``clientize_*`` helpers, against the
reference on the CPU.

The reference's multi-pod step reads only ``mesh.shape["pod"]``, so it
takes a stand-in mesh with 2 pods, and runs under a context mesh with a
``pod`` axis (its ``vmap(spmd_axis_name="pod")`` needs one) on one CPU
device. Both packages start from the same clientized params of the
reduced configs in f32, batch 4 x 32 (2 rows a client), keys
``fold_in(PRNGKey(0), i)``, under ``jax.threefry_partitionable(False)``.

Tolerances are those of the single-client steps
(``tests/test_torch_llm_train.py``): the metrics within 1e-5 relative;
each leaf's theta within 1e-4 of the leaf's largest update plus one f32
ulp of theta.
"""
import types

import jax
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import PFELSConfig as JPFELS
from repro.core.channel import scaled_channel as j_scaled
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.models import transformer as JT
from repro_torch import prng
from repro_torch.configs import PFELSConfig, reduced_config
from repro_torch.core.channel import scaled_channel
from repro_torch.kernels.clip_norm import kernel as clip_kernel
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves
from test_torch_llm_train import _assert_steps_close, _setup

N_CLIENTS = 2


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


def _run_both(arch, n_steps, **over):
    jcfg, tcfg, jp, tp, d, jb, tb = _setup(arch)
    kw = dict(dict(num_clients=1000, clients_per_round=N_CLIENTS,
                   compression_ratio=0.5, epsilon=4.0, local_lr=0.1,
                   local_steps=1), **over)
    jstep = jax.jit(jsteps.make_pfels_train_step(
        jcfg, JPFELS(channel=j_scaled(d), **kw), d,
        types.SimpleNamespace(shape={"pod": N_CLIENTS})))
    tstep = steps.make_pfels_train_step(
        tcfg, PFELSConfig(channel=scaled_channel(d), **kw), d,
        n_clients=N_CLIENTS)
    jps = [jsteps.clientize_params(jp, N_CLIENTS)]
    tps = [steps.clientize_params(tp, N_CLIENTS)]
    jms, tms = [], []
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    with use_mesh(make_host_mesh((1, 1, 1), ("pod", "data", "model"))):
        for i in range(n_steps):
            p, m = jstep(jps[-1], jb, jax.random.fold_in(jkey, i))
            jps.append(jax.device_get(p))
            jms.append(m)
            p, m = tstep(tps[-1], tb, prng.fold_in(tkey, i))
            tps.append(p)
            tms.append(m)
    return jps, tps, jms, tms


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"],
                         ids=["ssm", "hybrid"])
def test_multi_pod_step_matches_reference(arch):
    """Two steps with 2 clients: the metrics (means over the clients, and
    the energy summed over them) and every client's theta against the
    reference; both clients' replicas stay equal; no kernel launched on
    the CPU."""
    clip_kernel.reset_launch_counts()
    jps, tps, jms, tms = _run_both(arch, 2)
    assert clip_kernel.LAUNCHES["clip_norm"] == 0
    _assert_steps_close(jps, tps, jms, tms)
    for leaf in tree_leaves(tps[-1]):
        assert leaf.shape[0] == N_CLIENTS
        assert torch.equal(leaf[0], leaf[1])


def test_multi_pod_local_steps_match_reference():
    """tau = 2 on the reduced mamba2-130m: each client's two clipped SGD
    steps on halves of its 2-row slice."""
    _assert_steps_close(*_run_both("mamba2-130m", 1, local_steps=2))


def test_multi_pod_metrics_are_client_means():
    """The step's loss is the mean of the losses of the clients' own
    single-client steps, each on its slice of the batch."""
    _, tcfg, _, tp, d, _, tb = _setup("mamba2-130m")
    kw = dict(num_clients=1000, compression_ratio=0.5, epsilon=4.0,
              local_lr=0.1, local_steps=1, channel=scaled_channel(d))
    key = prng.PRNGKey(3, "cpu")
    _, multi = steps.make_pfels_train_step(
        tcfg, PFELSConfig(clients_per_round=N_CLIENTS, **kw), d,
        n_clients=N_CLIENTS)(steps.clientize_params(tp, N_CLIENTS), tb,
                             key)
    single = steps.make_pfels_train_step(
        tcfg, PFELSConfig(clients_per_round=1, **kw), d)
    half = tb["tokens"].shape[0] // N_CLIENTS
    losses = [single(tp, {k: v[i * half:(i + 1) * half]
                          for k, v in tb.items()}, key)[1]["loss"]
              for i in range(N_CLIENTS)]
    np.testing.assert_allclose(float(multi["loss"]),
                               float(torch.mean(torch.stack(losses))),
                               rtol=1e-6)


def test_clientize_helpers_match_reference():
    jcfg, tcfg, jp, tp, d, _, _ = _setup("zamba2-2.7b")
    jshapes = jsteps.clientize_shapes(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jp),
        3)
    tshapes = steps.clientize_shapes(tp, 3)
    for t, j in zip(tree_leaves(tshapes), jax.tree.leaves(jshapes)):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    logical = JT.logical_axes(jcfg)
    is_spec = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    jl = jsteps.clientize_logical(logical, 3)
    tl = steps.clientize_logical(logical, 3)
    assert (jax.tree.leaves(tl, is_leaf=is_spec)
            == jax.tree.leaves(jl, is_leaf=is_spec))
    assert (jax.tree.structure(tl, is_leaf=is_spec)
            == jax.tree.structure(jl, is_leaf=is_spec))
    tc = steps.clientize_params(tp, 3)
    jc = jsteps.clientize_params(jp, 3)
    for t, j, t0 in zip(tree_leaves(tc), jax.tree.leaves(jc),
                        tree_leaves(tp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.data_ptr() != t0.data_ptr() and t.is_contiguous()
    tc["embed"]["table"][0].zero_()
    assert not torch.equal(tc["embed"]["table"][1],
                           tc["embed"]["table"][0])


def test_multi_pod_needs_a_client():
    with pytest.raises(ValueError, match="n_clients"):
        steps.make_pfels_train_step(reduced_config("mamba2-130m"),
                                    PFELSConfig(), 1000, n_clients=0)
