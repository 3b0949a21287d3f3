"""The port's public surface against the JAX package's.

- Coverage: every public top-level name of every module of ``repro`` (its
  functions, classes and constants; a package's re-exports) has a
  counterpart in the port's module of the same name, or is on
  ``XLA_ONLY`` with what the port does instead. Two modules are renamed:
  the HLO analysis became an analysis of dispatched torch ops.
- The last functions ported: the paper's privacy lemmas and composition
  helpers, ``lambda_k``, ``compression_ratio_of`` and ``sparsify``,
  ``sample_noise``, ``transmit_energy``, ``dense_init`` and
  ``dense_apply``, each against the reference on the inputs of its own
  tests; ``sample_noise`` and ``dense_init`` bit for bit.
"""
import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import ChannelConfig as JChannel
from repro.core import channel as jchannel
from repro.core import power_control as jpower
from repro.core import privacy as jprivacy
from repro.core import randk as jrandk
from repro.models import layers as jlayers
from repro_torch import prng
from repro_torch.configs import ChannelConfig
from repro_torch.core import channel, power_control, privacy, randk
from repro_torch.models import layers

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF = os.path.join(_ROOT, "src", "repro")
_PORT = os.path.join(_ROOT, "src", "repro_torch")

# reference module -> the port module that stands in for it
RENAMED = {"launch/hlo_analysis.py": "launch/roofline.py",
           "launch/hlo_cost.py": "launch/op_cost.py"}

# public names with no counterpart, each XLA-, mesh- or TPU-only
XLA_ONLY = {
    "launch/mesh.py": {
        "make_mesh": "a jax.sharding.Mesh over devices; the port's meshes "
                     "are shapes (MeshShape) and its cohort a process group",
        "make_cohort_mesh": "the cohort is launch.mesh.CohortGroup over "
                            "torch.distributed",
        "shard_map_compat": "no shard_map: each rank runs its own shard",
        "use_mesh": "no ambient mesh: the group is passed explicitly",
    },
    "launch/dryrun.py": {
        "lower_and_compile": "no XLA compile: the dry run dispatches the "
                             "step's ops on the meta device",
    },
    "launch/hlo_analysis.py": {
        "normalize_cost": "op_cost counts FLOPs and bytes of dispatched "
                          "ops; there is no XLA cost analysis to normalize",
        "collective_bytes": "op_cost.charge_collective counts the bytes of "
                            "each torch.distributed call",
        "HBM_BW": "roofline's H100 constants replace the TPU's",
        "LINK_BW": "roofline's H100 constants replace the TPU's",
    },
    "launch/hlo_cost.py": {
        "Op": "no HLO text to parse: op_cost.OpCounter sees the ops",
        "analyze_hlo": "op_cost.OpCounter counts the dispatched ops",
    },
    "models/attention.py": {
        "shard_qkv": "a sharding constraint on XLA's SPMD partitioner",
        "shard_cache": "a sharding constraint on XLA's SPMD partitioner",
    },
    "sharding/__init__.py": {
        "constraint": "with_sharding_constraint; the port lays out no "
                      "tensor across devices in one program",
        "named_sharding": "a jax NamedSharding; the port's specs are "
                          "tuples (sharding.rules.resolve_spec)",
        "tree_shardings": "NamedShardings of a tree; the port's are specs",
    },
    "sharding/rules.py": {
        "constraint": "with_sharding_constraint (see sharding/__init__)",
        "named_sharding": "a jax NamedSharding (see sharding/__init__)",
        "tree_shardings": "NamedShardings of a tree (see sharding/__init__)",
        "get_abstract_mesh_or_none": "jax's ambient abstract mesh",
    },
    "kernels/pfels_transmit/kernel.py": {
        "LANES": "the TPU kernel's 128-lane tiling; the CUDA kernels tile "
                 "by thread blocks",
    },
}


def _modules():
    for dirpath, _, files in os.walk(_REF):
        for fname in sorted(files):
            if fname.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, fname), _REF)


def _bound(path: str, imports: bool) -> set:
    """The top-level names a module binds: its defs, classes and
    assignments, and with ``imports`` what it imports."""
    out = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def _public(rel: str) -> set:
    """A reference module's public names; a package's ``__init__`` also
    exports what it imports."""
    names = _bound(os.path.join(_REF, rel), rel.endswith("__init__.py"))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(_modules()))
def test_every_public_name_has_a_port_counterpart(rel):
    port_rel = RENAMED.get(rel, rel)
    path = os.path.join(_PORT, port_rel)
    assert os.path.exists(path), f"no port module for {rel}"
    have = _bound(path, True)
    if rel.endswith("__init__.py"):       # a package's submodules
        have |= {f[:-3] if f.endswith(".py") else f
                 for f in os.listdir(os.path.dirname(path))}
    allowed = XLA_ONLY.get(rel, {})
    missing = sorted(_public(rel) - have - set(allowed))
    assert missing == [], f"{port_rel} lacks {missing}"
    # an allowed name is one the reference has and the port lacks
    assert set(allowed) <= _public(rel) - have, rel


def test_xla_only_names_give_a_reason():
    assert all(isinstance(why, str) and len(why) > 20
               for names in XLA_ONLY.values() for why in names.values())
    assert sum(map(len, XLA_ONLY.values())) == 21


# ------------------------------------------------------------- privacy

PRIVACY_CASES = [
    ("sensitivity_bound", (2.0, 0.05, 5, 1.0)),
    ("sensitivity_bound", (0.37, 0.1, 1, 2.5)),
    ("gaussian_mechanism_sigma", (2.0, 0.5, 1e-5)),
    ("gaussian_mechanism_sigma", (0.25, 1.5, 1e-3)),
    ("amplified_epsilon", (0.8, 1, 1000)),
    ("amplified_epsilon", (0.8, 100, 1000)),
    ("amplified_epsilon", (0.8, 1000, 1000)),
    ("compose_basic", (0.1, 1e-5, 100)),
    ("compose_zcdp", (2.0, 500, 1e-5)),
    ("compose_zcdp", (0.5, 5000, 1e-5)),
    ("compose_zcdp", (0.0, 100, 1e-5)),
    ("pfels_noise_multiplier", (2.0, 0.05, 5, 1.0, 1.0)),
    ("pfels_noise_multiplier", (0.0, 0.05, 5, 1.0, 1.0)),
]


@pytest.mark.parametrize("name,args", PRIVACY_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(PRIVACY_CASES)])
def test_privacy_functions_equal_reference(name, args):
    """Host float64 math on both sides: equal, not close."""
    assert getattr(privacy, name)(*args) == getattr(jprivacy, name)(*args)


def test_zcdp_and_noise_multiplier_compose():
    z = privacy.pfels_noise_multiplier(2.0, 0.05, 5, 1.0, 1.0)
    assert z == pytest.approx(1.0 / (2.0 * 0.05 * 5))
    eps, delta = privacy.compose_zcdp(z, 100, 1e-5)
    assert math.isfinite(eps) and delta == 1e-5
    assert privacy.compose_zcdp(0.0, 100, 1e-5)[0] == float("inf")


# --------------------------------------------------------------- rand-k

@pytest.mark.parametrize("k,d", [(0, 10), (10, 10), (3, 10), (16, 64),
                                 (922_285, 9_222_858)])
def test_lambda_k_and_ratio_equal_reference(k, d):
    assert randk.lambda_k(k, d) == jrandk.lambda_k(k, d)
    assert randk.compression_ratio_of(k, d) == jrandk.compression_ratio_of(
        k, d)


def test_sparsify_equals_reference():
    d, k = 100, 30
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (d,)))
    idx = np.array(jrandk.sample_indices(jax.random.PRNGKey(0), d, k))
    want = np.asarray(jrandk.sparsify(jnp.asarray(x), jnp.asarray(idx), d))
    got = randk.sparsify(torch.from_numpy(x), torch.from_numpy(idx)
                         .long(), d)
    assert np.array_equal(got.numpy(), want)
    assert int((got != 0).sum()) <= k


# --------------------------------------------------- channel and power

@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread: these tests interleave torch
    and XLA work (see tests/test_torch_checkpoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,k,noise_std", [(2, 100_000, 2.0),
                                              (0, 1001, 1.0),
                                              (7, 26_122, 0.3)])
def test_sample_noise_bit_equal(seed, k, noise_std):
    want = np.asarray(jchannel.sample_noise(
        jax.random.PRNGKey(seed), k, JChannel(noise_std=noise_std)))
    got = channel.sample_noise(prng.PRNGKey(seed, "cpu"), k,
                               ChannelConfig(noise_std=noise_std))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("beta,gains,sq", [
    (1.0, [0.5, 0.25], [2.0, 8.0]),
    (0.37, [0.02, 0.013, 0.1, 0.0004], [3.1, 0.2, 7.9, 1.0]),
])
def test_transmit_energy_equals_reference(beta, gains, sq):
    g32, s32 = np.float32(gains), np.float32(sq)
    want = np.asarray(jpower.transmit_energy(beta, jnp.asarray(g32),
                                             jnp.asarray(s32)))
    got = power_control.transmit_energy(beta, torch.from_numpy(g32),
                                        torch.from_numpy(s32))
    assert np.array_equal(got.numpy(), want)
    assert float(got) == pytest.approx(
        sum((beta / g) ** 2 * s for g, s in zip(gains, sq)), rel=1e-6)


def test_transmit_energy_of_a_cohort_equals_reference():
    """r = 40 (above 32, where XLA sums in windows) and a tensor beta."""
    rng = np.random.default_rng(0)
    g = rng.uniform(1e-3, 0.1, 40).astype(np.float32)
    s = rng.uniform(0.0, 10.0, 40).astype(np.float32)
    beta = np.float32(0.021)
    want = np.asarray(jpower.transmit_energy(jnp.asarray(beta),
                                             jnp.asarray(g), jnp.asarray(s)))
    got = power_control.transmit_energy(torch.tensor(beta),
                                        torch.from_numpy(g),
                                        torch.from_numpy(s))
    assert np.array_equal(got.numpy(), want)


# ----------------------------------------------------------------- dense

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("d_in,d_out", [(64, 96), (7, 5)])
def test_dense_init_bit_equal_and_apply(dtype, bias, d_in, d_out):
    jp, jlg = jlayers.dense_init(jax.random.PRNGKey(3), d_in, d_out,
                                 bias=bias, dtype=getattr(jnp, dtype),
                                 logical=("embed", "mlp"))
    tp, tlg = layers.dense_init(prng.PRNGKey(3, "cpu"), d_in, d_out,
                                bias=bias, dtype=getattr(torch, dtype),
                                logical=("embed", "mlp"))
    assert tlg == jlg
    assert sorted(tp) == sorted(jp)
    for name in jp:
        want = np.asarray(jp[name].astype(jnp.float32))
        assert tp[name].dtype == getattr(torch, dtype)
        assert np.array_equal(tp[name].float().numpy(), want), name
    x = np.random.default_rng(1).standard_normal((3, d_in)).astype(
        np.float32)
    want = np.asarray(jlayers.dense_apply(jp, jnp.asarray(x)))
    got = layers.dense_apply(tp, torch.from_numpy(x)).numpy()
    # an f32 matmul: the two libraries sum the d_in products in another
    # order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dense_init_default_logical_axes_and_device():
    p, lg = layers.dense_init(prng.PRNGKey(0, "cpu"), 8, 4, bias=True,
                              dtype="float32", device="cpu")
    _, jlg = jlayers.dense_init(jax.random.PRNGKey(0), 8, 4, bias=True,
                                dtype=jnp.float32)
    assert lg == jlg == {"w": ("fsdp", "tensor"), "b": ("tensor",)}
    assert p["w"].device.type == "cpu" and p["b"].shape == (4,)
    assert not p["b"].any()
