"""The paper's CNN families in torch (port of ``repro/models/cnn.py``):
the modified VGG-11 of CIFAR-10 and the benchmark MLP.

Layouts are the reference's: images NCHW, conv weights OIHW, dense
weights (in, out). The reference's SAME 3x3 stride-1 conv is
``padding=1`` and its 2x2 VALID max pool is ``max_pool2d(2)``. The
``resnet`` family waits: the reference's SAME padding at stride 2 pads
(0, 1), which ``padding=1`` does not.

The reference computes in f32 and gives the same result from run to run.
On the card cuDNN would round convolution inputs to TF32 (PyTorch's
default) and may pick backward algorithms that add with atomics, so every
convolution of the port runs inside ``f32_convs()``. The dense layers'
``@`` needs no such scope: ``torch.backends.cuda.matmul.allow_tf32`` is
False by PyTorch's default, and the port leaves that switch to the caller.
"""
from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import CNNConfig
from repro_torch.tree import Params, leaf_names

VGG11_PLAN = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def _conv_init(key, cin, cout, ksize):
    fan_in = cin * ksize * ksize
    w = prng.normal(key, (cout, cin, ksize, ksize))
    return w * math.sqrt(2.0 / fan_in)


def _resnet_not_ported():
    return NotImplementedError(
        "arch='resnet' is not ported yet (its stride-2 SAME padding is "
        "asymmetric): ROADMAP Queue 1, item 3")


def _in_leaf_order(params: Params) -> Params:
    return {n: params[n] for n in leaf_names(params)}


def init_cnn(key, cfg: CNNConfig, device: Union[str, torch.device] = "cuda"
             ) -> Params:
    """Params drawn from ``key`` exactly as the reference draws them
    (``split(key, 64)``, one subkey per weight in order)."""
    key = key.to(device)
    ks = iter(prng.split(key, 64))
    wm = cfg.width_mult
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    params = {}
    if cfg.arch == "mlp":
        d_in = cfg.in_channels * cfg.image_size ** 2
        h = max(int(128 * wm), 16)
        params["fc1.w"] = (prng.normal(next(ks), (d_in, h))
                           * math.sqrt(2 / d_in))
        params["fc1.b"] = zeros(h)
        params["fc2.w"] = prng.normal(next(ks), (h, h)) * math.sqrt(2 / h)
        params["fc2.b"] = zeros(h)
        params["out.w"] = (prng.normal(next(ks), (h, cfg.num_classes))
                           * math.sqrt(1 / h))
        params["out.b"] = zeros(cfg.num_classes)
        return _in_leaf_order(params)
    if cfg.arch == "vgg":
        cin = cfg.in_channels
        size = cfg.image_size
        ci = 0
        for item in VGG11_PLAN:
            if item == "M":
                if size > 1:
                    size //= 2
                continue
            cout = max(int(item * wm), 8)
            params[f"convs.{ci}"] = _conv_init(next(ks), cin, cout, 3)
            cin = cout
            ci += 1
        feat = cin * size * size
        params["out.w"] = (prng.normal(next(ks), (feat, cfg.num_classes))
                           * math.sqrt(1 / feat))
        params["out.b"] = zeros(cfg.num_classes)
        return _in_leaf_order(params)
    raise _resnet_not_ported()


def f32_convs():
    """cuDNN's flags for the port's convolutions: f32 (no TF32) and
    deterministic algorithms, restored to the caller's on exit. cuDNN
    reads them when a convolution launches, so a backward pass must run
    inside the context as well as the forward."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def apply_cnn(params: Params, cfg: CNNConfig, images: torch.Tensor):
    """images: (B, C, H, W) -> logits (B, num_classes)."""
    x = images
    if cfg.arch == "mlp":
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(x @ params["fc1.w"] + params["fc1.b"])
        x = torch.relu(x @ params["fc2.w"] + params["fc2.b"])
        return x @ params["out.w"] + params["out.b"]
    if cfg.arch == "vgg":
        ci = 0
        size = cfg.image_size
        with f32_convs():
            for item in VGG11_PLAN:
                if item == "M":
                    if size > 1:
                        x = F.max_pool2d(x, 2)
                        size //= 2
                else:
                    x = torch.relu(F.conv2d(x, params[f"convs.{ci}"],
                                            padding=1))
                    ci += 1
        x = x.reshape(x.shape[0], -1)
        return x @ params["out.w"] + params["out.b"]
    raise _resnet_not_ported()


def cnn_loss(params: Params, cfg: CNNConfig, batch):
    """(mean NLL, {"accuracy": acc}) of one batch {"x", "y"}."""
    logits = apply_cnn(params, cfg, batch["x"])
    labels = batch["y"]
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll.mean(), {"accuracy": acc}
