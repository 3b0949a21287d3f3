"""The inputs of every cell, made from ``--seed`` on the device: weights,
token batches and PRNG keys. The harness hands them to the program, and
the references make them again from the same seed, so both sides get the
same inputs and the reference takes nothing the program made.

Each input has its own stream: a 64-bit mix of the seed and the stream's
number seeds one ``torch.Generator`` on the device, or gives a PRNG key's
two 32-bit words."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_M64 = (1 << 64) - 1
WEIGHTS, TOKENS, KEYS = 1, 2, 3


def mix(seed: int, stream: int, index: int = 0) -> int:
    """A 64-bit value from any whole seed, a stream and an index
    (splitmix64's finaliser over their sum)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB + 0x632BE59BD9B4E019) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        mix(seed, stream, index) >> 1)


def make_weights(specs, seed: int, device) -> Dict[Tuple, torch.Tensor]:
    """Every leaf of ``specs`` [(path, shape, dtype, init)]: the random
    leaves of a dtype drawn in one call into one flat buffer of that
    dtype and scaled as views; the constant leaves filled."""
    out: Dict[Tuple, torch.Tensor] = {}
    rand: Dict[str, List] = {}
    for path, shape, dtype, init in specs:
        if init[0] == "normal":
            rand.setdefault(dtype, []).append((path, shape, init[1]))
            continue
        dt = getattr(torch, dtype)
        if init[0] == "ones":
            out[path] = torch.ones(shape, dtype=dt, device=device)
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, dtype=dt, device=device)
        elif init[0] == "a_log":
            nh = shape[-1]
            row = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                           device=device))
            out[path] = row.expand(shape).to(dt).clone()
        else:
            raise ValueError(f"unknown init {init!r} of {path}")
    gen = generator(seed, WEIGHTS, 0, device)
    for dtype, leaves in sorted(rand.items()):
        total = sum(math.prod(s) for _, s, _ in leaves)
        buf = torch.empty((total,), dtype=getattr(torch, dtype),
                          device=device)
        buf.normal_(generator=gen)
        o = 0
        for path, shape, scale in leaves:
            n = math.prod(shape)
            view = buf[o:o + n].view(shape)
            if scale != 1.0:
                view.mul_(scale)
            out[path] = view
            o += n
    return {s[0]: out[s[0]] for s in specs}


def token_batch(seed: int, index: int, batch: int, seq: int, vocab: int,
                device) -> torch.Tensor:
    """(batch, seq) token ids drawn uniformly from the vocabulary, the
    ``index``-th batch of the run."""
    return torch.randint(0, vocab, (batch, seq), device=device,
                         generator=generator(seed, TOKENS, index, device))


def key_words(seed: int, index: int) -> Tuple[int, int]:
    """The ``index``-th PRNG key of the run as two 32-bit words."""
    z = mix(seed, KEYS, index)
    return (z >> 32) & 0xFFFFFFFF, z & 0xFFFFFFFF


DATA = 4


def classification_data(seed: int, n_clients: int, per_client: int,
                        num_classes: int, image_shape, alpha: float,
                        noise: float, device):
    """A federated population of synthetic images: each client's labels
    drawn from its own Dirichlet(alpha) class mix (on the host, 50,000
    draws), each image its class's prototype (N(0, 1) pixels) plus
    N(0, noise^2) pixels (on the device). Returns x (n_clients,
    per_client, *image_shape) f32 and y (n_clients, per_client) int64."""
    import numpy as np
    rng = np.random.default_rng(mix(seed, DATA, 0))
    mixes = rng.dirichlet(np.full(num_classes, alpha), size=n_clients)
    cdf = np.cumsum(mixes, axis=1)
    u = rng.random((n_clients, per_client))
    y = np.minimum((u[:, :, None] > cdf[:, None, :]).sum(-1),
                   num_classes - 1)
    y = torch.as_tensor(y, dtype=torch.int64, device=device)
    gen = generator(seed, DATA, 1, device)
    protos = torch.randn((num_classes, *image_shape), generator=gen,
                         device=device)
    x = torch.randn((n_clients, per_client, *image_shape), generator=gen,
                    device=device).mul_(noise).add_(protos[y])
    return x, y
