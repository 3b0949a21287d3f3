"""``mimo_mrc``: an M-antenna base station with maximum-ratio combining
(port of ``repro/core/channels/mimo.py``).

Per-antenna gains ``h_{i,m}`` are i.i.d. draws of the paper's clipped
Exponential law; the station combines with the all-ones beam, so the
effective gain is ``g_i = sum_m h_{i,m}`` and the combined noise is
N(0, M sigma_0^2): ``noise_std`` is ``sqrt(M) sigma_0``, the value the
beta privacy cap, the receiver draw and the ledger all use. The (r, M)
matrix rides in ``ChannelRound.gains_ant`` to the fused kernel, whose
in-tile combine recomputes ``combine_mrc``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.configs.base import ChannelConfig
from repro_torch.core import channel
from repro_torch.core.channels.base import (ChannelModel, ChannelRound,
                                            register_channel_model)


def antenna_gains(key, r: int, cfg: ChannelConfig) -> torch.Tensor:
    """(r, M) per-antenna magnitudes: r M gains from one flat stream,
    reshaped, so M = 1 is the scalar channel bit for bit."""
    m = cfg.num_antennas
    return channel.sample_gains(key, r * m, cfg).reshape(r, m)


def combine_mrc(per_antenna: torch.Tensor) -> torch.Tensor:
    """(r, M) -> (r,) effective gains under the all-ones beam, added in
    the reference's order."""
    return prng.sum_last(per_antenna)


def _init(key, n: int, cfg: ChannelConfig):
    return None


def _step(carry, cfg: ChannelConfig, r: int, sel, gains_key, csi_key):
    per_ant = antenna_gains(gains_key, r, cfg)
    gains = combine_mrc(per_ant)
    obs = (channel.estimate_gains(csi_key, gains, cfg)
           if cfg.csi_error > 0 else None)
    return carry, ChannelRound(gains=gains, gains_obs=obs,
                               gains_ant=per_ant)


MODEL = register_channel_model("mimo_mrc", ChannelModel(
    name="mimo_mrc", init=_init, step=_step,
    noise_std=lambda cfg: math.sqrt(cfg.num_antennas) * cfg.noise_std))
