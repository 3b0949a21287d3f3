"""The port's CNN families against ``repro.models.cnn`` on the CPU:
forward, loss and gradients with params carried across
(``repro_torch.convert``), init through the port's PRNG, and the flat
order of the params (the rand-k indices address the flat vector)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.paper_models import BENCH_CNN_CIFAR, BENCH_MLP
from repro.models import cnn as jcnn
from repro_torch import convert, prng
from repro_torch.configs import paper_models as tpm
from repro_torch.models import cnn as tcnn
from repro_torch.tree import Unravel, ravel

CFGS = {"mlp": (BENCH_MLP, tpm.BENCH_MLP),
        "vgg": (BENCH_CNN_CIFAR, tpm.BENCH_CNN_CIFAR)}
# f32 forward and backward in another summation order (XLA vs ATen
# kernels): a few ulp on O(1) values
RTOL, ATOL = 1e-5, 1e-6


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
    np.testing.assert_allclose(
        tcnn.apply_cnn(tparams, tcfg, torch.as_tensor(x)).numpy(),
        np.asarray(jcnn.apply_cnn(jparams, jcfg, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)

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
    np.testing.assert_allclose(tflat, np.asarray(ravel_pytree(jgrads)[0]),
                               rtol=1e-4, atol=1e-6)


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


def test_resnet_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
        tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tpm.BENCH_CNN_FEMNIST,
                      device="cpu")
