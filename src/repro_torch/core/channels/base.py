"""Channel-model registry (port of ``repro/core/channels/base.py``): a
model supplies the round's gains and its post-combining receiver noise.
The port registers ``block_fading``; the other scenarios wait for ROADMAP
Queue 1, item 9."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ChannelConfig

# finite stand-in for "this client does not constrain beta"
DESIGN_GAIN_BIG = 1e12


class ChannelRound(NamedTuple):
    """One round's channel realization: ``gains`` (r,) true effective gains;
    ``gains_obs`` the gains the devices observe (None = perfect CSI);
    ``tx_mask`` (r,) 0/1 transmit indicator (None = every client sends);
    ``gains_ant`` optional (r, M) per-antenna magnitudes."""
    gains: torch.Tensor
    gains_obs: Optional[torch.Tensor] = None
    tx_mask: Optional[torch.Tensor] = None
    gains_ant: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class ChannelModel:
    """``init(key, n, cfg) -> carry``; ``step(carry, cfg, r, sel,
    gains_key, csi_key) -> (carry, ChannelRound)``; ``noise_std(cfg)`` the
    post-combining receiver noise std."""
    name: str
    init: Callable
    step: Callable
    noise_std: Callable


_REGISTRY: Dict[str, ChannelModel] = {}


def register_channel_model(name: str, model: ChannelModel) -> ChannelModel:
    if name in _REGISTRY:
        raise ValueError(f"channel model {name!r} already registered")
    _REGISTRY[name] = model
    return model


def get_channel_model(name: str) -> ChannelModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"channel model {name!r} is not ported yet (ported: "
            f"{sorted(_REGISTRY)}): ROADMAP Queue 1, item 9") from None


def effective_noise_std(cfg: ChannelConfig) -> float:
    return float(get_channel_model(cfg.model).noise_std(cfg))


def observed_gains(cr: ChannelRound) -> torch.Tensor:
    return cr.gains if cr.gains_obs is None else cr.gains_obs


def design_gains(cr: ChannelRound) -> torch.Tensor:
    """The gains beta-design mins over: the observed gains, with dropped
    clients lifted to ``DESIGN_GAIN_BIG``."""
    g = observed_gains(cr)
    if cr.tx_mask is None:
        return g
    return torch.where(cr.tx_mask > 0, g, torch.full_like(g, DESIGN_GAIN_BIG))


def realized_cohort_size(cr: ChannelRound, r: int) -> torch.Tensor:
    if cr.tx_mask is None:
        return torch.tensor(float(r), dtype=torch.float32,
                            device=cr.gains.device)
    return torch.sum(cr.tx_mask).float()
