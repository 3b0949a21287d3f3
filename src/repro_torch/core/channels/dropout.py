"""``dropout``: Bernoulli client dropout over any base fading model (port
of ``repro/core/channels/dropout.py``).

The wrapper fades by ``cfg.dropout_base`` and zeroes a
Bernoulli(``cfg.dropout_prob``) subset of the cohort's transmissions
through ``ChannelRound.tx_mask``: beta is designed over the clients that
transmit, the server unscales by the realized count, and under error
feedback a dropped client's whole update stays in its residual. The keep
mask is drawn from ``fold_in(gains_key, 0x44524F50)``, so the base
model's gains are the ones it draws alone.
"""
from __future__ import annotations

from repro_torch import prng
from repro_torch.configs.base import ChannelConfig
from repro_torch.core.channels.base import (ChannelModel, ChannelRound,
                                            get_channel_model,
                                            register_channel_model)

_MASK_TAG = 0x44524F50  # "DROP": the fold_in stream of the Bernoulli draw


def _base(cfg: ChannelConfig) -> ChannelModel:
    base = get_channel_model(cfg.dropout_base)
    if base.name == "dropout":
        raise ValueError("dropout cannot wrap itself")
    return base


def _init(key, n: int, cfg: ChannelConfig):
    return _base(cfg).init(key, n, cfg)


def _step(carry, cfg: ChannelConfig, r: int, sel, gains_key, csi_key):
    carry, cr = _base(cfg).step(carry, cfg, r, sel, gains_key, csi_key)
    keep = prng.bernoulli(prng.fold_in(gains_key, _MASK_TAG),
                          1.0 - cfg.dropout_prob, (r,))
    return carry, cr._replace(tx_mask=keep.float())


MODEL = register_channel_model("dropout", ChannelModel(
    name="dropout", init=_init, step=_step,
    noise_std=lambda cfg: _base(cfg).noise_std(cfg),
    stateful=lambda cfg: _base(cfg).stateful(cfg),
    may_mask=lambda cfg: True))
