"""``block_fading``: the paper's flat block-fading MAC (§4.1, §8.1).
Gains are redrawn i.i.d. every round on the round's gains lane; the CSI
view comes from the csi lane only under imperfect CSI."""
from __future__ import annotations

from repro_torch.configs.base import ChannelConfig
from repro_torch.core import channel
from repro_torch.core.channels.base import (ChannelModel, ChannelRound,
                                            register_channel_model)


def _init(key, n: int, cfg: ChannelConfig):
    return None


def _step(carry, cfg: ChannelConfig, r: int, sel, gains_key, csi_key):
    gains = channel.sample_gains(gains_key, r, cfg)
    obs = (channel.estimate_gains(csi_key, gains, cfg)
           if cfg.csi_error > 0 else None)
    return carry, ChannelRound(gains=gains, gains_obs=obs)


MODEL = register_channel_model("block_fading", ChannelModel(
    name="block_fading", init=_init, step=_step,
    noise_std=lambda cfg: cfg.noise_std))
