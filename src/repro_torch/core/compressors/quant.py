"""``stoch_quant``: QSGD-style stochastic quantization over rand-k (port
of ``repro/core/compressors/quant.py``).

The support is the paper's rand-k draw. Each client's transmit-clipped
update is quantized to ``s = 2^(quant_bits - 1) - 1`` signed magnitude
levels with unbiased stochastic rounding: with ``y = |u_j| / ||u|| s``
the level is ``floor(y) + Bernoulli(y - floor(y))``, rescaled by
``||u|| / s``. Client i's uniforms come from the i-th of
``split(fold_in(ks[3], QUANT_STREAM_TAG), r)``, one (d,) draw a client.
Sensitivity ``1 + sqrt(d) / s``: rounding moves each coordinate by at
most one level, so ``||q(u)|| <= (1 + sqrt(d) / s) ||u||``.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.clipping import row_norms
from repro_torch.core.compressors.base import Compressor, register_compressor
from repro_torch.core.compressors.rand_k import select_support as _randk


def _levels(cfg) -> int:
    s = 2 ** (int(cfg.quant_bits) - 1) - 1
    if s < 1:
        raise ValueError(
            f"quant_bits={cfg.quant_bits} leaves no magnitude levels "
            f"(need quant_bits >= 2)")
    return s


def encode(cfg, updates: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(r, d) unbiased stochastic quantization, one key a client. The
    uniforms are drawn a client at a time: one threefry pass over r d
    counts would hold several (r, d) int64 temporaries."""
    s = float(_levels(cfg))
    u = updates.float()
    norms = row_norms(u)
    scales = torch.where(norms > 0, norms, torch.ones_like(norms))
    out = torch.empty_like(u)
    for i in range(u.shape[0]):
        y = torch.abs(u[i]) / scales[i] * s
        lo = torch.floor(y)
        level = lo + (prng.uniform(keys[i], tuple(y.shape)) < (y - lo)).float()
        torch.mul(torch.sign(u[i]) * level, scales[i] / s, out=out[i])
    return out


def sensitivity(cfg, d) -> float:
    if d is None:
        raise ValueError(
            "stoch_quant sensitivity is dimension-dependent "
            "(1 + sqrt(d)/levels); pass the flat model dimension d")
    return 1.0 + (float(d) ** 0.5) / float(_levels(cfg))


register_compressor("stoch_quant", Compressor(
    name="stoch_quant", select_support=_randk,
    sensitivity=sensitivity, encode=encode))
