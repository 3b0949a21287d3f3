"""Synthetic federated datasets: class-prototype images plus Gaussian
noise, split IID or with a Dirichlet label skew over the clients, or
generated client by client on demand for populations too large to hold
(port of ``repro/data/synthetic.py``).

Everything is drawn on ``device`` with the port's threefry, so the same
key gives the reference's IID labels exactly and its images to the
``normal`` gap (``repro_torch.prng``); the Dirichlet branch's labels to
the gap of ``prng.dirichlet`` (``tests/test_torch_data.py``).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import prng
from repro_torch.data import loader

Device = Union[str, torch.device]


def make_prototypes(key, num_classes: int, image_shape, scale: float = 1.0):
    return scale * prng.normal(key, (num_classes,) + tuple(image_shape))


def _test_set(kt, protos, num_classes: int, shape, noise: float):
    n_test = max(num_classes * 20, 200)
    yt = prng.randint(kt, (n_test,), 0, num_classes)
    xt = prng.normal(prng.fold_in(kt, 1), (n_test,) + shape)
    xt.mul_(noise).add_(protos[yt])
    return xt, yt


def make_federated_classification(
        key, *, n_clients: int, per_client: int, num_classes: int = 10,
        image_shape=(1, 8, 8), noise: float = 0.6, alpha: float = None,
        device: Device = "cuda"):
    """Returns (x (N, n, C, H, W) f32, y (N, n) int64, test_x, test_y), all
    on ``device``.

    alpha=None draws labels IID; else each client's class distribution
    is Dirichlet(alpha) and its labels are drawn from it, one ``choice``
    a client keyed by ``split(kl, N)`` (the same ``kl`` as the Dirichlet
    draw, as the reference does)."""
    key = key.to(device)
    kp, kl, kn, kt = prng.split(key, 4)
    shape = tuple(image_shape)
    protos = make_prototypes(kp, num_classes, shape)

    if alpha is None:
        y = prng.randint(kl, (n_clients, per_client), 0, num_classes)
    else:
        probs = prng.dirichlet(
            kl, torch.full((num_classes,), float(alpha), device=key.device),
            (n_clients,))
        y = prng.choice(prng.split(kl, n_clients), num_classes,
                        (per_client,), p=probs)
    # noise * normal + protos[y], built in place: the noise draw is the
    # largest tensor (614 MB at the paper's CIFAR size)
    x = prng.normal(kn, (n_clients, per_client) + shape)
    x.mul_(noise).add_(protos[y])

    xt, yt = _test_set(kt, protos, num_classes, shape, noise)
    return x, y, xt, yt


def make_population_source(key, *, n_clients: int, per_client: int,
                           num_classes: int = 10, image_shape=(1, 8, 8),
                           noise: float = 0.6, device: Device = "cuda"):
    """A population whose client ``i`` draws its samples on demand from
    ``fold_in(kc, i)`` (split into a label and a noise key), the same
    prototype-plus-noise family as :func:`make_federated_classification`;
    no (n, samples, ...) tensor exists, so n can be 100,000 or more.

    Returns ``(source, test_x, test_y)``: ``source`` is a
    :class:`repro_torch.data.loader.ClientFnSource` whose ``cohort(sel)``
    draws the selected clients' data on ``device``, the whole cohort at
    once. The same client always serves the same samples."""
    key = key.to(device)
    kp, kc, kt = prng.split(key, 3)
    shape = tuple(image_shape)
    protos = make_prototypes(kp, num_classes, shape)

    def cohort(sel):
        ck = prng.fold_in(kc, torch.as_tensor(sel))
        lanes = prng.split(ck)
        y = prng.randint(lanes[:, 0], (per_client,), 0, num_classes)
        x = prng.normal(lanes[:, 1], (per_client,) + shape)
        x.mul_(noise).add_(protos[y])
        return x, y

    xt, yt = _test_set(kt, protos, num_classes, shape, noise)
    return loader.ClientFnSource(cohort, n_clients), xt, yt


def make_lm_sequences(key, *, n_seqs: int, seq_len: int, vocab: int,
                      order: int = 1) -> torch.Tensor:
    """Synthetic LM data from a random Markov chain (learnable structure):
    (n_seqs, seq_len) int32 tokens on the key's device, the reference's
    draws. The chain's logits are ``2 normal(kt, (vocab, vocab))``; each
    sequence starts at ``randint(k0, (), 0, vocab)`` and takes each next
    token by ``categorical`` from the row of the current one, one key a
    step, the sequences drawn together as the reference's ``vmap``.
    ``order`` is the reference's argument, which its chain ignores."""
    kt, ks, _ = prng.split(key, 3)
    logits = 2.0 * prng.normal(kt, (vocab, vocab))
    pair = prng.split(prng.split(ks, n_seqs), 2)        # (n, 2, 2)
    tok = prng.randint(pair[:, 0], (), 0, vocab)        # (n,)
    step_keys = prng.split(pair[:, 1], seq_len - 1)     # (n, S - 1, 2)
    out = [tok]
    for t in range(seq_len - 1):
        tok = prng.categorical(step_keys[:, t], logits[tok])
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)
