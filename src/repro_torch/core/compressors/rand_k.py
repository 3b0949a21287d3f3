"""``rand_k``: the paper's uniform random-k sparsifier (Alg. 2 line 12).
Sensitivity factor 1.0: the projection is a submatrix of the identity.

``randk_mode="server_topk"`` (beyond paper) is a rand-k mode: half the
budget goes to the top coordinates of ``|Delta_hat_{t-1}|``, the rest is
drawn uniformly from the others; a cold start (``prev_delta`` zero or
absent) falls back to the uniform draw. Every other mode, ``"mask"``
included, takes the uniform draw, as in the reference."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import randk
from repro_torch.core.compressors.base import (Compressor, Support,
                                               register_compressor)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices ``jax.lax.top_k(x, k)`` returns: the k largest values,
    in descending order, the lower index first among equal values. A
    stable descending sort gives that order; ``torch.topk`` promises none,
    and at d = 9.2M the uniform scores (2^23 distinct values) tie often."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _server_topk_indices(d: int, k: int, prev_delta, key) -> torch.Tensor:
    k1 = k // 2
    idx_top = top_k_indices(torch.abs(prev_delta), k1)
    scores = prng.uniform(key, (d,))
    scores[idx_top] = -torch.inf
    idx_rand = top_k_indices(scores, k - k1)
    return torch.cat([idx_top, idx_rand])


def select_support(cfg, d: int, k: int, prev_delta, key) -> Support:
    # the reference's cold-start test, ||prev_delta|| > 0 (one host read)
    if (cfg.randk_mode == "server_topk" and prev_delta is not None
            and bool(torch.sum(prev_delta * prev_delta) > 0)):
        return Support(_server_topk_indices(d, k, prev_delta, key))
    return Support(randk.sample_indices(key, d, k))


register_compressor("rand_k", Compressor(
    name="rand_k", select_support=select_support))
