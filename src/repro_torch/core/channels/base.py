"""Channel-model registry (port of ``repro/core/channels/base.py``): a
model supplies the round's gains (possibly from state carried across
rounds in ``TrainState.chan``), the observed-gain view, an optional
transmit mask and its post-combining receiver noise. Models that need
extra draws derive them by ``fold_in`` on the round's gains lane."""
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
    """``init(key, n, cfg) -> carry`` (None for stateless models);
    ``step(carry, cfg, r, sel, gains_key, csi_key) -> (carry,
    ChannelRound)``; ``noise_std(cfg)`` the post-combining receiver noise
    std; ``stateful(cfg)`` whether ``init`` returns real state;
    ``may_mask(cfg)`` whether ``step`` can return a ``tx_mask`` (the round
    body plumbs the mask only then)."""
    name: str
    init: Callable
    step: Callable
    noise_std: Callable
    stateful: Callable = lambda cfg: False
    may_mask: Callable = lambda cfg: False


_REGISTRY: Dict[str, ChannelModel] = {}


def register_channel_model(name: str, model: ChannelModel) -> ChannelModel:
    """Add a scenario under ``ChannelConfig.model == name``."""
    if name in _REGISTRY:
        raise ValueError(f"channel model {name!r} already registered")
    if model.init is None or model.step is None or model.noise_std is None:
        raise ValueError(f"channel model {name!r} needs init, step and "
                         f"noise_std hooks")
    _REGISTRY[name] = model
    return model


def unregister_channel_model(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_channel_model(name: str) -> ChannelModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown channel model {name!r}; registered: "
            f"{sorted(_REGISTRY)} (add new scenarios via "
            f"repro_torch.core.channels.register_channel_model)") from None


def list_channel_models():
    return sorted(_REGISTRY)


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
