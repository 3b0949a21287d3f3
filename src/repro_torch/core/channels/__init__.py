"""Wireless-scenario registry (port of ``repro/core/channels``).
``ChannelConfig.model`` names an entry; importing this package registers
the reference's four: ``block_fading`` (the paper's i.i.d. flat fading),
``markov_fading`` (Gauss-Markov gains across rounds), ``mimo_mrc`` (an
M-antenna base station with MRC) and ``dropout`` (Bernoulli transmission
dropout over any base model)."""
from repro_torch.core.channels import (block_fading, dropout,  # noqa: F401
                                       markov, mimo)
from repro_torch.core.channels.base import (DESIGN_GAIN_BIG, ChannelModel,
                                            ChannelRound, design_gains,
                                            effective_noise_std,
                                            get_channel_model,
                                            list_channel_models,
                                            observed_gains,
                                            realized_cohort_size,
                                            register_channel_model,
                                            unregister_channel_model)

__all__ = ["ChannelModel", "ChannelRound", "DESIGN_GAIN_BIG",
           "design_gains", "effective_noise_std", "get_channel_model",
           "list_channel_models", "observed_gains", "realized_cohort_size",
           "register_channel_model", "unregister_channel_model"]
