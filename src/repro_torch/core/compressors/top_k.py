"""``top_k_ef``: magnitude top-k with mandatory error feedback (port of
``repro/core/compressors/top_k.py``).

omega_t is the k largest-magnitude coordinates of the previous round's
released aggregate (server-guided, so the support aligns across clients;
post-processing of a DP output, sensitivity factor 1). ``carry`` is True:
a coordinate never transmitted keeps ``|Delta_hat| = 0`` and would never
be picked again, so the bank's residual memory is on whatever
``cfg.error_feedback`` says. A cold start (zero ``prev_delta``) takes the
uniform rand-k draw from the same key.

``prev_delta`` is exactly zero off the last support, so ties at the k-th
magnitude are real: :func:`rand_k.top_k_indices` breaks them by the lower
index, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core import randk
from repro_torch.core.compressors.base import (Compressor, Support,
                                               register_compressor)
from repro_torch.core.compressors.rand_k import top_k_indices, warm


def select_support(cfg, d: int, k: int, prev_delta, key) -> Support:
    if warm(prev_delta):
        return Support(top_k_indices(torch.abs(prev_delta), k))
    return Support(randk.sample_indices(key, d, k))


register_compressor("top_k_ef", Compressor(
    name="top_k_ef", select_support=select_support,
    carry=lambda cfg: True))
