"""``rand_k``: the paper's uniform random-k sparsifier (Alg. 2 line 12).
Sensitivity factor 1.0: the projection is a submatrix of the identity."""
from __future__ import annotations

from repro_torch.core import randk
from repro_torch.core.compressors.base import (Compressor, Support,
                                               register_compressor)


def select_support(cfg, d: int, k: int, prev_delta, key) -> Support:
    if cfg.randk_mode != "exact":
        raise NotImplementedError(
            f"randk_mode={cfg.randk_mode!r} is not ported yet: ROADMAP "
            f"Queue 1, item 7")
    return Support(randk.sample_indices(key, d, k))


register_compressor("rand_k", Compressor(
    name="rand_k", select_support=select_support))
