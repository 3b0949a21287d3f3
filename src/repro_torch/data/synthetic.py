"""Synthetic federated datasets: class-prototype images plus Gaussian
noise, split IID over the clients (port of ``repro/data/synthetic.py``).

Everything is drawn on ``device`` with the port's threefry, so the same
key gives the reference's labels exactly and its images to the ``normal``
gap (``repro_torch.prng``).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import prng

Device = Union[str, torch.device]


def make_prototypes(key, num_classes: int, image_shape, scale: float = 1.0):
    return scale * prng.normal(key, (num_classes,) + tuple(image_shape))


def make_federated_classification(
        key, *, n_clients: int, per_client: int, num_classes: int = 10,
        image_shape=(1, 8, 8), noise: float = 0.6, alpha: float = None,
        device: Device = "cuda"):
    """Returns (x (N, n, C, H, W) f32, y (N, n) int64, test_x, test_y), all
    on ``device``.

    alpha=None draws labels IID; the Dirichlet label-skew branch is not
    ported yet (ROADMAP Queue 1, item 2)."""
    if alpha is not None:
        raise NotImplementedError(
            "Dirichlet label skew (alpha) is not ported yet: ROADMAP "
            "Queue 1, item 2")
    key = key.to(device)
    kp, kl, kn, kt = prng.split(key, 4)
    protos = make_prototypes(kp, num_classes, image_shape)

    y = prng.randint(kl, (n_clients, per_client), 0, num_classes)
    # noise * normal + protos[y], built in place: the noise draw is the
    # largest tensor (614 MB at the paper's CIFAR size)
    x = prng.normal(kn, (n_clients, per_client) + tuple(image_shape))
    x.mul_(noise).add_(protos[y])

    n_test = max(num_classes * 20, 200)
    yt = prng.randint(kt, (n_test,), 0, num_classes)
    xt = prng.normal(prng.fold_in(kt, 1), (n_test,) + tuple(image_shape))
    xt.mul_(noise).add_(protos[yt])
    return x, y, xt, yt
