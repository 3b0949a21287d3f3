"""The port's CNN families against ``repro.models.cnn`` on the CPU:
forward, loss and gradients with params carried across
(``repro_torch.convert``), init through the port's PRNG, and the flat
order of the params (the rand-k indices address the flat vector). The
ResNet also at image sizes whose stride-2 SAME padding is (1, 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")
from jax.flatten_util import ravel_pytree

from repro.configs.paper_models import (BENCH_CNN_CIFAR, BENCH_CNN_FEMNIST,
                                        BENCH_MLP, PAPER_RESNET18_FEMNIST)
from repro.models import cnn as jcnn
from repro_torch import convert, prng
from repro_torch.configs import paper_models as tpm
from repro_torch.models import cnn as tcnn
from repro_torch.tree import Unravel, ravel

CFGS = {"mlp": (BENCH_MLP, tpm.BENCH_MLP),
        "vgg": (BENCH_CNN_CIFAR, tpm.BENCH_CNN_CIFAR),
        "resnet": (BENCH_CNN_FEMNIST, tpm.BENCH_CNN_FEMNIST)}
# f32 forward and backward in another summation order (XLA vs ATen
# kernels): a few ulp on O(1) values
RTOL, ATOL = 1e-5, 1e-6
# the ResNet has no normalization: its logits grow to 10-50 and its
# gradients to 1-20 at these widths, so its absolute tolerances are 1e-6
# of the largest magnitude (forward: measured at most 4.7e-7 of
# max|logit|; gradient: at most 9.4e-7 of max|g|, at image sizes 7, 13,
# 14 and 28)
RESNET_ATOL_OF_MAX = 1e-6


def _atol(arch, want, default=ATOL):
    if arch == "resnet":
        return RESNET_ATOL_OF_MAX * float(np.abs(want).max())
    return default


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


def _problem(arch, batch=6, seed=0):
    jcfg, tcfg = CFGS[arch]
    jparams = jax.device_get(jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, jcfg.in_channels, jcfg.image_size,
                             jcfg.image_size)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, batch).astype(np.int32)
    return jcfg, tcfg, jparams, x, y


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_forward_loss_and_grads_match(arch):
    jcfg, tcfg, jparams, x, y = _problem(arch)
    tparams = convert.params_from_jax(jparams, device="cpu")
    want = np.asarray(jcnn.apply_cnn(jparams, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(
        tcnn.apply_cnn(tparams, tcfg, torch.as_tensor(x)).numpy(), want,
        rtol=RTOL, atol=_atol(arch, want))

    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    (jloss, jaux), jgrads = jax.value_and_grad(
        jcnn.cnn_loss, has_aux=True)(jparams, jcfg, jbatch)
    leaves = {n: t.clone().requires_grad_(True) for n, t in tparams.items()}
    tloss, taux = tcnn.cnn_loss(
        leaves, tcfg, {"x": torch.as_tensor(x),
                       "y": torch.as_tensor(y).long()})
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL)
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    tflat = ravel(dict(zip(leaves, grads))).numpy()
    jflat = np.asarray(ravel_pytree(jgrads)[0])
    np.testing.assert_allclose(tflat, jflat, rtol=1e-4,
                               atol=_atol(arch, jflat, 1e-6))


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_flat_order_equals_ravel_pytree(arch):
    jcfg, tcfg, jparams, _, _ = _problem(arch)
    tparams = convert.params_from_jax(jparams, device="cpu")
    jflat = np.asarray(ravel_pytree(jparams)[0])
    assert np.array_equal(ravel(tparams).numpy(), jflat)
    # the port's own init lays its dict out in the same order, and the
    # round trip through the flat vector and back to JAX is exact
    assert list(tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")) \
        == list(tparams)
    back = Unravel(tparams)(torch.as_tensor(jflat.copy()))
    rt = convert.params_to_jax(back)
    assert np.array_equal(np.asarray(ravel_pytree(rt)[0]), jflat)


@pytest.mark.parametrize("arch", sorted(CFGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_init_matches_reference_to_the_normal_gap(arch, seed):
    """Same key, same weights, to the ``normal`` gap (<= 3 ulp of the
    draw, then one f32 rounding of the scale): rtol 5e-7."""
    jcfg, tcfg = CFGS[arch]
    jflat = np.asarray(ravel_pytree(
        jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg))[0])
    tflat = ravel(tcnn.init_cnn(prng.PRNGKey(seed, "cpu"), tcfg,
                                device="cpu")).numpy()
    assert tflat.shape == jflat.shape
    np.testing.assert_allclose(tflat, jflat, rtol=5e-7, atol=0)


def test_paper_vgg11_dimension():
    """The full-width VGG-11 of the paper's CIFAR-10 runs has d =
    9,222,858 here (the reference's VGG has no conv biases)."""
    params = tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tpm.PAPER_VGG11_CIFAR10,
                           device="cpu")
    assert sum(p.numel() for p in params.values()) == 9_222_858


# ------------------------------------------------------------ the ResNet

def test_same_pads_are_xla_s():
    """XLA's SAME: the odd pixel goes high, and at stride 2 the pads
    depend on the size's parity."""
    assert tcnn._same_pads(28, 3, 1) == (1, 1)
    assert [tcnn._same_pads(n, 3, 2) for n in (28, 14, 7, 4)] == [
        (0, 1), (0, 1), (1, 1), (0, 1)]
    assert [tcnn._same_pads(n, 1, 2) for n in (28, 7, 13)] == [(0, 0)] * 3


@pytest.mark.parametrize("size", [7, 13])
def test_resnet_at_odd_sizes_matches(size):
    """Sizes 7 and 13: the stride-2 convolutions of stages 1-3 pad (1, 1)
    where an even size pads (0, 1). Forward within RTOL, the gradient
    within rtol 1e-4 (as the other families), both with the ResNet's
    absolute tolerance."""
    jcfg = dataclasses.replace(BENCH_CNN_FEMNIST, image_size=size)
    tcfg = dataclasses.replace(tpm.BENCH_CNN_FEMNIST, image_size=size)
    jparams = jax.device_get(jcnn.init_cnn(jax.random.PRNGKey(1), jcfg))
    tparams = convert.params_from_jax(jparams, device="cpu")
    rng = np.random.default_rng(size)
    x = rng.standard_normal((5, 1, size, size)).astype(np.float32)
    y = rng.integers(0, 62, 5).astype(np.int32)
    want = np.asarray(jcnn.apply_cnn(jparams, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(
        tcnn.apply_cnn(tparams, tcfg, torch.as_tensor(x)).numpy(), want,
        rtol=RTOL, atol=_atol("resnet", want))
    jgrads = jax.grad(lambda p: jcnn.cnn_loss(
        p, jcfg, {"x": jnp.asarray(x), "y": jnp.asarray(y)})[0])(jparams)
    leaves = {n: t.clone().requires_grad_(True) for n, t in tparams.items()}
    loss, _ = tcnn.cnn_loss(leaves, tcfg, {"x": torch.as_tensor(x),
                                           "y": torch.as_tensor(y).long()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    jflat = np.asarray(ravel_pytree(jgrads)[0])
    np.testing.assert_allclose(ravel(dict(zip(leaves, grads))).numpy(),
                               jflat, rtol=1e-4,
                               atol=_atol("resnet", jflat))


def test_resnet_leaf_names_order_and_dimensions():
    """Names by path, in JAX's ``tree_flatten`` order; d = 705,486 at
    BENCH_CNN_FEMNIST and 11,189,886 at the paper's width (the paper
    quotes 11,192,746; the reference's model is this one), the latter
    from shapes alone on the meta device."""
    tparams = tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tpm.BENCH_CNN_FEMNIST,
                            device="cpu")
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), BENCH_CNN_FEMNIST)
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(tparams) == paths
    assert paths[:3] == ["out.b", "out.w", "stages.0.0.c1"]
    assert paths[-1] == "stem"
    assert "stages.1.0.proj" in paths and "stages.0.0.proj" not in paths
    assert sum(t.numel() for t in tparams.values()) == 705_486
    meta = tcnn.init_cnn(prng.PRNGKey(0, "meta"),
                         tpm.PAPER_RESNET18_FEMNIST, device="meta")
    assert sum(t.numel() for t in meta.values()) == 11_189_886
    assert [tuple(meta[n].shape) for n in meta] == [
        tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0),
                                                 PAPER_RESNET18_FEMNIST)))]


@pytest.mark.parametrize("full", [False, True], ids=["bench", "paper"])
def test_resnet_params_round_trip_through_convert(full):
    """``params_from_jax`` and ``params_to_jax`` carry the nested lists of
    block dicts both ways, bit for bit."""
    jcfg = PAPER_RESNET18_FEMNIST if full else BENCH_CNN_FEMNIST
    jparams = jax.device_get(jcnn.init_cnn(jax.random.PRNGKey(2), jcfg))
    tparams = convert.params_from_jax(jparams, device="cpu")
    back = convert.params_to_jax(tparams)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)))
    assert isinstance(back["stages"][3][1], dict)


# ------------------------------------------------ cuDNN flags of the convs

def _cudnn_flags():
    c = torch.backends.cudnn
    return {"enabled": c.enabled, "benchmark": c.benchmark,
            "deterministic": c.deterministic, "allow_tf32": c.allow_tf32}


# PyTorch's defaults, which a caller may well run under
CALLER = {"enabled": True, "benchmark": False, "deterministic": False,
          "allow_tf32": True}
SCOPED = {"enabled": True, "benchmark": False, "deterministic": True,
          "allow_tf32": False}


def test_local_train_runs_forward_and_backward_in_f32_deterministic():
    """One ``local_train`` step on BENCH_CNN_CIFAR under PyTorch's default
    cuDNN flags: the forward (read in ``loss_fn``, before ``apply_cnn``
    sets its own scope) and the backward (read in a hook on every param
    leaf, which fires as each conv's weight gradient is formed) see f32,
    deterministic convolutions; after the step the caller's flags are
    back."""
    from repro_torch.fl import client as tclient
    tcfg = tpm.BENCH_CNN_CIFAR
    params = tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((20, 3, 16, 16)).astype(
        np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 20)).long()
    seen = {"forward": [], "backward": []}

    def loss_fn(p, batch):
        seen["forward"].append(_cudnn_flags())
        for t in p.values():
            t.register_hook(
                lambda g: seen["backward"].append(_cudnn_flags()))
        return tcnn.cnn_loss(p, tcfg, batch)

    with torch.backends.cudnn.flags(**CALLER):
        tclient.local_train(params, x, y, prng.PRNGKey(5, "cpu"),
                            loss_fn=loss_fn, steps=1, lr=0.05, clip=1.0,
                            momentum=0.9, batch_size=10)
        assert _cudnn_flags() == CALLER
    assert seen["forward"] == [SCOPED]
    assert len(seen["backward"]) == len(params)
    assert all(f == SCOPED for f in seen["backward"])


@pytest.mark.parametrize("tcfg", [tpm.BENCH_CNN_CIFAR, tpm.BENCH_CNN_FEMNIST],
                         ids=["vgg", "resnet"])
def test_apply_cnn_runs_every_conv_in_f32_deterministic(tcfg, monkeypatch):
    """``apply_cnn`` (evaluation's path) scopes its convolutions itself,
    and gives the caller's flags back."""
    params = tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    seen = []
    conv2d = tcnn.F.conv2d

    def recording_conv2d(*args, **kwargs):
        seen.append(_cudnn_flags())
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(tcnn.F, "conv2d", recording_conv2d)
    size = tcfg.image_size
    with torch.backends.cudnn.flags(**CALLER):
        logits = tcnn.apply_cnn(params, tcfg, torch.zeros(
            (2, tcfg.in_channels, size, size)))
        assert _cudnn_flags() == CALLER
    assert logits.shape == (2, tcfg.num_classes)
    assert len(seen) == sum(t.ndim == 4 for t in params.values())
    assert all(f == SCOPED for f in seen)
