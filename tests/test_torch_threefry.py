"""The threefry kernels' wrappers off the card (``repro_torch.kernels.
threefry``): the CPU route is ``prng``'s plain code, the ``meta`` route
returns the outputs' shapes and charges the kernels' bytes, the wrapper
refuses what the kernels do not take, and the kernel's constants are
``prng``'s. The kernels themselves run in ``tests/test_torch_kernels_cuda.
py`` on a card."""
import re
from pathlib import Path

import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import prng
from repro_torch.core import aggregation, randk
from repro_torch.kernels.threefry import kernel, ref
from repro_torch.launch import op_cost
from repro_torch.tree import tree_leaves

SOURCE = Path(kernel.__file__).resolve().parents[2] / "csrc" / "threefry.cu"
SIZES = [1, 2, 3, 720, 1025]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint8 if t.dtype == torch.bool else np.uint32)


def _hex_floats(text: str):
    return [float.fromhex(v.rstrip("f")) for v in
            re.findall(r"-?0x[0-9a-f.]+p[-+]\d+f", text)]


def test_kernel_constants_are_prngs():
    src = SOURCE.read_text()

    def table(name):
        m = re.search(rf"#define {name}\s+\\\s*\{{(.*?)\}}", src, re.S)
        return _hex_floats(m.group(1))

    def scalar(name):
        return _hex_floats(re.search(rf"constexpr float {name} = ([^;]+);",
                                     src).group(1))[0]

    def f32(values):
        return [prng._f32(v) for v in values]

    assert table("ERFINV_LT5") == f32(prng._ERFINV_LT5)
    assert table("ERFINV_GE5") == f32(prng._ERFINV_GE5)
    assert table("LOG_P") == f32(prng._LOG_P)
    assert table("LOG1P_NUM") == f32(prng._LOG1P_NUM)
    assert table("LOG1P_DEN") == f32(prng._LOG1P_DEN)
    assert scalar("kLogQ1") == prng._f32(prng._LOG_Q1)
    assert scalar("kLogQ2") == prng._f32(prng._LOG_Q2)
    assert scalar("kSqrtHalf") == prng._f32(0.707106781186547524)
    assert scalar("kLog1pSmall") == prng._f32(prng._LOG1P_SMALL)
    assert scalar("kNormalLo") == prng._f32(prng._NORMAL_LO)
    assert scalar("kNormalSpan") == prng._f32(1.0 - prng._NORMAL_LO)
    assert scalar("kSqrt2") == prng._SQRT2_F32
    rot = re.search(r"kRot\[2\]\[4\] = \{\{([\d, ]+)\}, \{([\d, ]+)\}\}",
                    src)
    assert tuple(tuple(int(v) for v in g.split(",")) for g in rot.groups()) \
        == prng._ROTATIONS
    assert f"0x{prng._KS_PARITY:X}u" in src


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", kernel.KINDS)
def test_cpu_route_is_the_plain_version(kind, n):
    """A CPU key takes ``ref.py`` (``prng``'s code), launches nothing, and
    ``prng``'s samplers give the same bits."""
    key = prng.PRNGKey(11, "cpu")
    before = dict(kernel.LAUNCHES)
    got = kernel.sample(key, n, kind, 0.3)
    assert kernel.LAUNCHES == before
    want = ref.sample_ref(key, n, kind, 0.3)
    assert got.shape == (n,) and got.dtype == want.dtype
    assert np.array_equal(_bits(got), _bits(want))
    hashed = prng._hash_counts(key, n, prng._bits_to_unit, torch.float32)
    via = {"uniform": lambda: prng.uniform(key, (n,)),
           "normal": lambda: prng.normal(key, (n,)),
           "bernoulli": lambda: prng.bernoulli(key, 0.3, (n,))}[kind]()
    assert np.array_equal(_bits(via), _bits(want))
    if kind == "uniform":
        assert np.array_equal(_bits(want), _bits(hashed))
    if kind == "bernoulli":
        assert torch.equal(want, hashed < prng._f32(0.3))


def test_batch_of_strided_keys_draws_one_row_a_key():
    """A (M, 2) view whose rows lie 4 words apart (``split``'s output
    sliced, as the gamma sampler passes it) draws row j from key j."""
    ks = prng.split(prng.PRNGKey(2, "cpu"), 6).reshape(3, 2, 2)[:, 1]
    assert ks.stride() == (4, 1)
    got = kernel.sample(ks, 7, "normal")
    assert got.shape == (3, 7)
    for j in range(3):
        assert np.array_equal(_bits(got[j]),
                              _bits(prng.normal(ks[j].clone(), (7,))))


def _leaf_tree():
    """Odd-sized leaves with signed zeros, negatives and subnormals of x,
    and masks all 0, all 1 and Bernoulli(0.5)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 241)).astype(np.float32)
    a[0, :6] = [0.0, -0.0, -3.5, 1e-40, -1e-42, 2.0 ** -149]
    b = (rng.standard_normal(1025) * 1e-38).astype(np.float32)
    c = rng.standard_normal((7,)).astype(np.float32)
    tree = {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
            "c": torch.from_numpy(c)}
    masks = randk.mask_tree(prng.PRNGKey(8, "cpu"), tree, 0.5)
    masks["b"] = torch.zeros_like(masks["b"])
    masks["c"] = torch.ones_like(masks["c"])
    return tree, masks


@pytest.mark.parametrize("unbiased", [False, True])
def test_combine_cpu_route_is_the_aggregates_leaf(unbiased):
    """``combine`` on the CPU, leaf by leaf, gives the production
    aggregate's single-client CPU route bit for bit."""
    tree, masks = _leaf_tree()
    beta, key = torch.tensor(7.3), prng.PRNGKey(4, "cpu")
    out = aggregation.pfels_production_aggregate(
        tree, masks, beta=beta, r=1, sigma0=1.3, noise_key=key,
        unbiased_rescale=unbiased, compression_p=0.3)
    scale = 1.0 / (1 * beta)
    if unbiased:
        scale = scale / torch.full_like(scale, 0.3)
    keys = prng.split(key, 3)
    before = dict(kernel.LAUNCHES)
    for x, m, k, want in zip(tree_leaves(tree), tree_leaves(masks), keys,
                             tree_leaves(out)):
        got = kernel.combine(x, m, k, beta, 1.3, scale)
        assert np.array_equal(_bits(got), _bits(want))
    assert kernel.LAUNCHES == before


def test_meta_aggregate_and_masks_take_the_kernels():
    """On ``meta`` the masks are one ``threefry_sample`` a leaf and the
    single-client aggregate one ``threefry_combine`` a leaf, with the
    plain routes' shapes and dtypes."""
    tree, masks = _leaf_tree()
    meta = {k: v.to("meta") for k, v in tree.items()}
    key = prng.PRNGKey(4, "meta")
    with op_cost.OpCounter() as c:
        m_meta = randk.mask_tree(key, meta, 0.5)
        out = aggregation.pfels_production_aggregate(
            meta, m_meta, beta=torch.tensor(2.0, device="meta"), r=1,
            sigma0=0.5, noise_key=key)
    c.close()
    assert c.kernels["threefry_sample"]["launches"] == 3
    assert c.kernels["threefry_combine"]["launches"] == 3
    assert c.kernels["threefry_combine"]["bytes"] == sum(
        kernel.combine_work(x.numel())[0] for x in tree.values())
    for got, x in zip(tree_leaves(out), tree_leaves(tree)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (x.shape, x.dtype)
    for got, m in zip(tree_leaves(m_meta), tree_leaves(masks)):
        assert (got.shape, got.dtype) == (m.shape, m.dtype)
    assert sum(kernel.LAUNCHES.values()) == 0


def test_aggregate_rounds_a_number_beta_to_f32():
    """beta as a number is rounded to the f32 scalar that the kernel
    reads: on the CPU the same bits as beta an f32 tensor, and on
    ``meta`` one ``threefry_combine`` a leaf."""
    tree, masks = _leaf_tree()
    key = prng.PRNGKey(4, "cpu")
    got = aggregation.pfels_production_aggregate(
        tree, masks, beta=7.3, r=1, sigma0=1.3, noise_key=key)
    want = aggregation.pfels_production_aggregate(
        tree, masks, beta=torch.tensor(7.3), r=1, sigma0=1.3, noise_key=key)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert np.array_equal(_bits(g), _bits(w))
    meta = {k: v.to("meta") for k, v in tree.items()}
    m_meta = {k: v.to("meta") for k, v in masks.items()}
    with op_cost.OpCounter() as c:
        aggregation.pfels_production_aggregate(
            meta, m_meta, beta=2.0, r=1, sigma0=0.5,
            noise_key=prng.PRNGKey(4, "meta"))
    c.close()
    assert c.kernels["threefry_combine"]["launches"] == 3
    assert "threefry_sample" not in c.kernels


def test_aggregate_off_the_cpu_refuses_what_the_kernel_does_not_take():
    """Off the CPU the single-client aggregate has no plain route: a bf16
    leaf or a float mask is refused, not drawn by the plain ops."""
    tree, masks = _leaf_tree()
    meta = {k: v.to("meta") for k, v in tree.items()}
    m_meta = {k: v.to("meta") for k, v in masks.items()}
    key = prng.PRNGKey(4, "meta")
    with pytest.raises(TypeError, match="float32"):
        aggregation.pfels_production_aggregate(
            {k: v.bfloat16() for k, v in meta.items()}, m_meta,
            beta=2.0, r=1, sigma0=0.5, noise_key=key)
    with pytest.raises(TypeError, match="bool"):
        aggregation.pfels_production_aggregate(
            meta, {k: v.float() for k, v in m_meta.items()},
            beta=2.0, r=1, sigma0=0.5, noise_key=key)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrapper_refuses_what_the_kernels_do_not_take():
    key = prng.PRNGKey(1, "meta")
    one = _meta(())
    for dev in ("cpu", "meta"):
        k = prng.PRNGKey(1, dev)
        with pytest.raises(ValueError, match="2\\^32"):
            kernel.sample(k, 2 ** 32, "uniform")
        with pytest.raises(ValueError, match="2\\^32"):
            kernel.sample(k, -1, "uniform")
        with pytest.raises(ValueError, match="kind"):
            kernel.sample(k, 4, "gamma")
        with pytest.raises(ValueError, match="p"):
            kernel.sample(k, 4, "bernoulli")
    with pytest.raises(ValueError, match="key"):
        kernel.sample(key.to(torch.int32), 4, "uniform")
    with pytest.raises(ValueError, match="adjacent"):
        kernel.sample(_meta((4,), torch.int64)[::2], 4, "uniform")
    x, m = _meta((5, 3)), _meta((5, 3), torch.bool)
    with pytest.raises(ValueError, match="2\\^32"):
        kernel.combine(_meta((1 << 32,)), _meta((1 << 32,), torch.bool),
                       key, one, 1.0, one)
    with pytest.raises(TypeError, match="float32"):
        kernel.combine(x.bfloat16(), m, key, one, 1.0, one)
    with pytest.raises(TypeError, match="bool"):
        kernel.combine(x, m.float(), key, one, 1.0, one)
    with pytest.raises(ValueError, match="shape"):
        kernel.combine(x, _meta((3, 5), torch.bool), key, one, 1.0, one)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.combine(x.t(), m.t(), key, one, 1.0, one)
    with pytest.raises(ValueError, match="key"):
        kernel.combine(x, m, prng.split(key, 2), one, 1.0, one)
    with pytest.raises(TypeError, match="beta"):
        kernel.combine(x, m, key, _meta((2,)), 1.0, one)
    with pytest.raises(TypeError, match="scale"):
        kernel.combine(x, m, key, one, 1.0, _meta((), torch.float64))
    with pytest.raises(TypeError, match="sigma0"):
        kernel.combine(x, m, key, one, one, one)
    with pytest.raises(ValueError, match="several devices"):
        kernel.combine(x, torch.ones((5, 3), dtype=torch.bool), key, one,
                       1.0, one)


def test_work_counts_what_the_kernels_move():
    assert kernel.sample_work(1, 2 ** 24 + 1, "normal") == \
        (16 + 4 * (2 ** 24 + 1), 0.0)
    assert kernel.sample_work(3, 720, "bernoulli") == (48 + 3 * 720, 0.0)
    assert kernel.combine_work(240_721_920) == (9 * 240_721_920 + 24, 0.0)
    assert kernel.MAX_N == 2 ** 32 - 1
