"""The port's production-analysis shapes against the JAX reference on the
CPU: ``configs.SHAPES``, the sharding rules (``repro_torch.sharding``) on
the production meshes as shapes (``launch.mesh.MeshShape``) against the
reference's rules on ``jax.sharding.AbstractMesh`` (a mesh with no
devices), the params' logical axes and meta shapes of all ten
architectures at full width, the decode cache's spec, one device's param
bytes against ``NamedSharding.shard_shape``, and the shapes, dtypes and
specs of the dry run's inputs (``launch.inputs``).

Every check is exact: these are shapes, names and integer byte counts.
"""
import contextlib
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.configs.shapes import InputShape as JInputShape
from repro.launch import inputs as JI
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch.configs import SHAPES, get_config, list_archs, \
    reduced_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import MeshShape, make_host_mesh, \
    make_production_mesh
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as R

ARCHS = list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
# tests/test_launch.py's four shapes of the reduced configs
SMALL_SHAPES = (("t_train", 128, 8, "train"), ("t_prefill", 256, 4, "prefill"),
                ("t_decode", 256, 4, "decode"), ("long_500k", 512, 1,
                                                 "decode"))
REDUCED = ("phi3-mini-3.8b", "zamba2-2.7b", "granite-moe-3b-a800m",
           "whisper-tiny", "qwen2-vl-72b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread, as the other files that mix
    torch and XLA work pin it (ROADMAP's test-time note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's (init_shapes, logical_axes) of ``arch`` at full
    width, traced once a file (each is an abstract trace of the whole
    init)."""
    jcfg = j_get_config(arch)
    return JT.init_shapes(jcfg), JT.logical_axes(jcfg)


def _meshes(name):
    sizes, axes = MESHES[name]
    return MeshShape(axes, sizes), AbstractMesh(sizes, axes)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _ctx(mode):
    if mode == "plain":
        return contextlib.nullcontext(), contextlib.nullcontext()
    if mode == "fsdp":
        return R.logical_overrides(R.PURE_FSDP), \
            JR.logical_overrides(JR.PURE_FSDP)
    return R.exclude_axes("data"), JR.exclude_axes("data")


def _jax_tree(tree):
    """A port tree (dicts, tuples of dicts, tensors) as nested Python
    containers with shape tuples for the leaves."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_jax_tree(v) for v in tree)
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _ref_tree(tree):
    if isinstance(tree, dict):
        return {k: _ref_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_ref_tree(v) for v in tree)
    return tuple(tree.shape), str(tree.dtype)


def test_shapes_are_the_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in J_SHAPES.items()}


def test_production_and_host_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        MeshShape(("data",), (2, 2))


# tests/test_sharding.py's cases, on its (1, 1) mesh
@pytest.mark.parametrize("case", [
    ("plain", ("fsdp", "tensor"), (4, 8)),
    ("plain", ("batch", None), (4, 4)),
    ("exclude", ("fsdp", "tensor"), (4, 8)),
    ("plain", ("tensor",), (5,)),
])
def test_resolve_spec_on_the_reference_cases(case):
    mode, logical, shape = case
    mesh, jmesh = make_host_mesh(), AbstractMesh((1, 1), ("data", "model"))
    ctx, jctx = _ctx(mode)
    with ctx, jctx:
        assert R.resolve_spec(logical, shape, mesh) == \
            tuple(JR.resolve_spec(logical, shape, jmesh))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", ["plain", "fsdp", "exclude"])
def test_resolve_spec_on_every_param_leaf(mesh_name, mode):
    """Every param leaf of all ten full-width architectures resolves to
    the reference's spec, plain, under PURE_FSDP and under
    exclude_axes; the batch, cohort and sequence names too."""
    mesh, jmesh = _meshes(mesh_name)
    ctx, jctx = _ctx(mode)
    n = 0
    with ctx, jctx:
        for arch in ARCHS:
            cfg = get_config(arch)
            shapes, logical = T.init_shapes(cfg), T.logical_axes(cfg)
            specs = R.tree_specs(mesh, logical, shapes)
            jshapes, jlogical = _ref_params(arch)
            jspecs = JR.tree_shardings(jmesh, jlogical, jshapes)
            jflat = jax.tree.leaves_with_path(jspecs)
            for path, sh in jflat:
                ours = specs
                for p in path:
                    ours = ours[getattr(p, "key", getattr(p, "idx", None))]
                assert ours == tuple(sh.spec), (arch, path)
                n += 1
        for logical in (("batch", None), ("cohort",), ("clients", "fsdp"),
                        ("seq_mp", "seq_all"), ("batch_nopod", None)):
            for shape in ((32, 64), (512, 256), (3, 5)):
                assert R.resolve_spec(logical, shape, mesh) == tuple(
                    JR.resolve_spec(logical, shape, jmesh))
    assert n == 199
    assert R.cohort_axis_size(mesh) == JR.cohort_axis_size(jmesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_logical_axes_are_the_reference(arch):
    """Full-width params as meta tensors: the reference's tree of shapes
    and dtypes (``init_shapes``) and of logical axes."""
    cfg = get_config(arch)
    shapes = T.init_shapes(cfg)
    assert {t.device.type for t in _leaves(shapes)} == {"meta"}
    jshapes, jlogical = _ref_params(arch)
    assert _jax_tree(shapes) == _ref_tree(jshapes)
    assert T.logical_axes(cfg) == jlogical
    assert T.param_count(shapes) == JT.param_count(jshapes)


@pytest.mark.parametrize("shape", [(128, 32768, 8, 128), (1, 524288, 8, 128),
                                   (128, 32768, 32, 100), (128, 32768, 5, 100),
                                   (3, 64, 8, 64)])
@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16},
                                  {"data": 1, "model": 1}])
def test_kv_cache_spec_is_the_reference(shape, axes):
    assert A.kv_cache_spec(shape, FakeMesh(axes)) == \
        JA.kv_cache_spec(shape, FakeMesh(axes))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_bytes_per_device(mesh_name):
    """One device's param bytes on each production mesh: the sum of
    ``shard_shape`` over the leaves equals the reference's
    ``NamedSharding.shard_shape`` sum."""
    mesh, jmesh = _meshes(mesh_name)
    for arch in ARCHS:
        cfg = get_config(arch)
        shapes = T.init_shapes(cfg)
        specs = R.tree_specs(mesh, T.logical_axes(cfg), shapes)
        ours = 0
        for t, spec in zip(_leaves(shapes), _leaves(specs, spec=True)):
            ours += int(np.prod(R.shard_shape(tuple(t.shape), spec, mesh))) \
                * t.element_size()
        jshapes, jlogical = _ref_params(arch)
        jsh = JR.tree_shardings(jmesh, jlogical, jshapes)
        ref = sum(int(np.prod(sh.shard_shape(sd.shape))) * sd.dtype.itemsize
                  for sd, sh in zip(jax.tree.leaves(jshapes),
                                    jax.tree.leaves(jsh)))
        assert ours == ref, arch


def _leaves(tree, spec=False):
    """Leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], spec)]
    if isinstance(tree, tuple) and not (spec and all(
            isinstance(e, (str, type(None), tuple)) for e in tree)):
        return [x for v in tree for x in _leaves(v, spec)]
    return [tree]


def _norm(spec):
    """A spec's entries with one-axis tuples as the axis name (how
    ``PartitionSpec`` stores them)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _check_inputs(ours, specs, ref):
    """Our meta tensors and specs against the reference's
    ShapeDtypeStructs with their NamedShardings."""
    for name, sd in ref.items():
        if name == "caches":
            for c, cs, jc in zip(ours[name], specs[name], sd):
                for k, jt in jc.items():
                    assert tuple(c[k].shape) == jt.shape, (name, k)
                    assert str(c[k].dtype).replace("torch.", "") == \
                        str(jt.dtype)
                    assert c[k].device.type == "meta"
                    assert _norm(cs[k]) == _norm(jt.sharding.spec), (name, k)
            continue
        t = ours[name]
        assert tuple(t.shape) == sd.shape, name
        assert str(t.dtype).replace("torch.", "") == str(sd.dtype), name
        assert t.device.type == "meta"
        assert specs[name] == tuple(sd.sharding.spec), name
    assert set(ours) == set(ref)


def _inputs_pair(cfg, jcfg, shape, jshape, mesh, jmesh):
    if shape.kind == "train":
        return (I.train_batch_specs(cfg, shape, mesh),
                JI.train_batch_specs(jcfg, jshape, jmesh))
    if shape.kind == "prefill":
        return (I.prefill_batch_specs(cfg, shape, mesh),
                JI.prefill_batch_specs(jcfg, jshape, jmesh))
    window = I.long_context_window(cfg, shape)
    assert window == JI.long_context_window(jcfg, jshape)
    return (I.decode_specs(cfg, shape, mesh, window=window),
            JI.decode_specs(jcfg, jshape, jmesh, window=window))


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("small", SMALL_SHAPES, ids=lambda s: s[0])
def test_inputs_of_reduced_configs(arch, small):
    shape, jshape = InputShape(*small), JInputShape(*small)
    cfg, jcfg = reduced_config(arch), j_reduced(arch)
    mesh, jmesh = make_host_mesh(), AbstractMesh((1, 1), ("data", "model"))
    (ours, specs), ref = _inputs_pair(cfg, jcfg, shape, jshape, mesh, jmesh)
    _check_inputs(ours, specs, ref)
    plain = _inputs_pair(cfg, jcfg, shape, jshape, None, jmesh)[0]
    assert set(plain) == set(ours)


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_of_full_configs_on_the_production_meshes(arch):
    """The four SHAPES at full width, both production meshes; the decode
    caches through the reference's ``jax.eval_shape``."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for mesh_name in MESHES:
        mesh, jmesh = _meshes(mesh_name)
        for name in SHAPES:
            (ours, specs), ref = _inputs_pair(cfg, jcfg, SHAPES[name],
                                              J_SHAPES[name], mesh, jmesh)
            _check_inputs(ours, specs, ref)
    assert I.batch_div(make_production_mesh(multi_pod=True)) == \
        JI._batch_div(FakeMesh({"pod": 2, "data": 16, "model": 16}))
    assert P(*R.resolve_spec(("batch", None), (256, 4), mesh)) == \
        JR.resolve_spec(("batch", None), (256, 4), jmesh)
