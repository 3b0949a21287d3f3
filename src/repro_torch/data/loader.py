"""The per-client minibatch sampler of local training (port of
``repro/data/loader.py:sample_batch``)."""
from __future__ import annotations

from repro_torch import prng


def sample_batch(key, x, y, batch_size: int):
    idx = prng.randint(key, (batch_size,), 0, x.shape[0])
    return {"x": x[idx], "y": y[idx]}
