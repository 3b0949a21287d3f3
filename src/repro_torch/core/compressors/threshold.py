"""``threshold``: hard-threshold sparsification, padded to the k budget
(port of ``repro/core/compressors/threshold.py``).

A coordinate is live when ``|Delta_hat_{t-1}| >= threshold_frac *
max|Delta_hat_{t-1}|``. The support keeps a static width: the k budget is
filled from the top-k of ``|Delta_hat_{t-1}|`` and the slots below the
threshold are switched off in ``Support.active``, whose sum is the live
count the beta design, the receiver and the ``subcarriers`` metric see.
A cold start takes a fully live rand-k draw. Sensitivity factor 1.
"""
from __future__ import annotations

import torch

from repro_torch.core import randk
from repro_torch.core.compressors.base import (Compressor, Support,
                                               register_compressor)
from repro_torch.core.compressors.rand_k import top_k_indices, warm


def select_support(cfg, d: int, k: int, prev_delta, key) -> Support:
    if not warm(prev_delta):
        idx = randk.sample_indices(key, d, k)
        return Support(idx, torch.ones((k,), dtype=torch.float32,
                                       device=idx.device))
    mag = torch.abs(prev_delta)
    idx = top_k_indices(mag, k)
    thresh = cfg.threshold_frac * torch.max(mag)
    return Support(idx, (mag[idx] >= thresh).float())


register_compressor("threshold", Compressor(
    name="threshold", select_support=select_support,
    dynamic_support=lambda cfg: True))
