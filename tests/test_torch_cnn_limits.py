"""The tolerances of ``chip_smoke.py``'s ``conv_parity_on_card``, derived
on the CPU: one local step's gradient and two BENCH_CNN_CIFAR rounds with
f64 convolutions in place of f32 ones (what summing in another order can
move, and more), and with operands rounded to TF32 (what cuDNN's default
would move). Kept apart from ``tests/test_torch_cnn.py``, whose other
tests are quick, so that another worker runs these two long ones."""
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import prng
from repro_torch.configs import paper_models as tpm
from repro_torch.models import cnn as tcnn


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
