"""``markov_fading``: Gauss-Markov gains correlated across rounds (port of
``repro/core/channels/markov.py``).

Each client carries a latent AR(1) state
``z <- rho z + sqrt(1 - rho^2) xi``, xi ~ N(0, 1), with a stationary
N(0, 1) marginal, mapped through the normal CDF and the
Exponential(``gain_mean``) quantile to the paper's gain law and clipped
to ``gain_clip``. The (n,) state of the whole population lives in
``TrainState.chan`` and steps every round from the round's gains lane,
on both bank backends.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ChannelConfig
from repro_torch.core import channel
from repro_torch.core.channels.base import (ChannelModel, ChannelRound,
                                            register_channel_model)


def _gains_from_latent(z, cfg: ChannelConfig):
    """N(0, 1) latent -> Exponential(gain_mean) marginal, clipped."""
    u = prng.ndtr_f32(z)
    g = -cfg.gain_mean * prng.log1p_f32(-u)
    return torch.clamp(g, cfg.gain_clip[0], cfg.gain_clip[1])


def _init(key, n: int, cfg: ChannelConfig):
    # stationary start: z ~ N(0, 1) per client
    return prng.normal(key, (n,))


def _step(carry, cfg: ChannelConfig, r: int, sel, gains_key, csi_key):
    # rho z + sqrt(1 - rho^2) xi as the reference's jitted round computes
    # it: the constant folded into the draw, rho z contracted into an FMA
    rho = torch.tensor(cfg.markov_rho, dtype=torch.float32)
    scale = float(prng.sqrt_f32(1.0 - rho * rho))
    z = prng.fma_f32(carry, float(rho),
                     prng.normal_scaled(gains_key, tuple(carry.shape), scale))
    gains = _gains_from_latent(z[sel], cfg)
    obs = (channel.estimate_gains(csi_key, gains, cfg)
           if cfg.csi_error > 0 else None)
    return z, ChannelRound(gains=gains, gains_obs=obs)


MODEL = register_channel_model("markov_fading", ChannelModel(
    name="markov_fading", init=_init, step=_step,
    noise_std=lambda cfg: cfg.noise_std,
    stateful=lambda cfg: True))
