"""The port's CNN families against ``repro.models.cnn`` on the CPU:
forward, loss and gradients with params carried across
(``repro_torch.convert``), init through the port's PRNG, and the flat
order of the params (the rand-k indices address the flat vector)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")
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


def test_apply_cnn_runs_every_conv_in_f32_deterministic(monkeypatch):
    """``apply_cnn`` (evaluation's path) scopes its convolutions itself,
    and gives the caller's flags back."""
    tcfg = tpm.BENCH_CNN_CIFAR
    params = tcnn.init_cnn(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    seen = []
    conv2d = tcnn.F.conv2d

    def recording_conv2d(*args, **kwargs):
        seen.append(_cudnn_flags())
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(tcnn.F, "conv2d", recording_conv2d)
    with torch.backends.cudnn.flags(**CALLER):
        logits = tcnn.apply_cnn(params, tcfg, torch.zeros((2, 3, 16, 16)))
        assert _cudnn_flags() == CALLER
    assert logits.shape == (2, 10)
    assert len(seen) == sum(n.startswith("convs.") for n in params)
    assert all(f == SCOPED for f in seen)


# ----------------------- the tolerances of chip_smoke's conv_parity_on_card
#
# On the card the port's convolutions are held against its CPU route. The
# limits are derived here, on the CPU: the same computation with f64
# convolutions in place of f32 ones (what summing in another order can
# move, and more), and with operands rounded to TF32's 10 mantissa bits in
# both directions of the pass (what cuDNN's default would move).

def _tf32(t):
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Conv(torch.autograd.Function):
    conv2d = staticmethod(torch.nn.functional.conv2d)

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return _TF32Conv.conv2d(_tf32(x), _tf32(w), padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(x.shape, _tf32(w), _tf32(g),
                                        padding=ctx.padding)
        gw = torch.nn.grad.conv2d_weight(_tf32(x), w.shape, _tf32(g),
                                         padding=ctx.padding)
        return gx, gw, None


def _conv_variants(monkeypatch):
    """Context setters for the f64 and the TF32 convolutions."""
    conv2d = torch.nn.functional.conv2d

    def f64(x, w, padding=0):
        return conv2d(x.double(), w.double(), padding=padding).float()

    def tf32(x, w, padding=0):
        return _TF32Conv.apply(x, w, padding)

    return {name: (lambda fn=fn: monkeypatch.setattr(tcnn.F, "conv2d", fn))
            for name, fn in (("f32", conv2d), ("f64", f64),
                             ("tf32", tf32))}


def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch", ["bench", "vgg11"])
def test_card_step_gradient_limit_separates_f32_order_from_tf32(
        arch, monkeypatch):
    """One ``local_train`` step's gradient (chip_smoke's own
    ``_step_gradient``): f64 convolutions move it by less than a tenth of
    ``CONV_GRAD_TOL`` of max|g|, TF32 ones by more than ten times it."""
    cs = _chip_smoke()
    cfg, size = {"bench": (tpm.BENCH_CNN_CIFAR, 16),
                 "vgg11": (tpm.PAPER_VGG11_CIFAR10, 32)}[arch]
    params = tcnn.init_cnn(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((50, 3, size, size)).astype(
        np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 50)).long()
    grads = {}
    for name, use in _conv_variants(monkeypatch).items():
        use()
        grads[name] = cs._step_gradient(cfg, params, x, y, "cpu")[0]
    scale = float(grads["f32"].abs().max())
    gap = {k: float((grads[k] - grads["f32"]).abs().max()) / scale
           for k in ("f64", "tf32")}
    assert gap["f64"] <= cs.CONV_GRAD_TOL / 10, gap
    assert gap["tf32"] >= cs.CONV_GRAD_TOL * 10, gap


def test_card_digest_limit_separates_f32_order_from_tf32(monkeypatch):
    """Two rounds of BENCH_CNN_CIFAR at the default config with the
    phase's keys (chip_smoke's ``_round_digests``): f64 convolutions move
    the digests by less than a tenth of ``CONV_DIGEST_TOL``, TF32 ones by
    more than ten times it."""
    cs = _chip_smoke()
    from repro_torch.configs import PFELSConfig
    from repro_torch.data import make_federated_classification
    tcfg = tpm.BENCH_CNN_CIFAR
    key = prng.PRNGKey(0, "cpu")
    params = tcnn.init_cnn(key, tcfg, device="cpu")
    x, y, _, _ = make_federated_classification(
        key, n_clients=1000, per_client=50, num_classes=10,
        image_shape=(3, 16, 16), device="cpu")
    cfg = PFELSConfig(rounds=2)
    digests = {}
    for name, use in _conv_variants(monkeypatch).items():
        use()
        digests[name] = cs._round_digests(tcfg, params, x, y, cfg,
                                          device="cpu")
    gap = {k: max(cs._digest_gaps(digests[k], digests["f32"]).values())
           for k in ("f64", "tf32")}
    assert gap["f64"] <= cs.CONV_DIGEST_TOL / 10, gap
    assert gap["tf32"] >= cs.CONV_DIGEST_TOL * 10, gap
