from repro_torch.core.channels import block_fading  # noqa: F401
from repro_torch.core.channels.base import (DESIGN_GAIN_BIG, ChannelModel,
                                            ChannelRound, design_gains,
                                            effective_noise_std,
                                            get_channel_model,
                                            list_channel_models,
                                            observed_gains,
                                            realized_cohort_size,
                                            register_channel_model)

__all__ = ["ChannelModel", "ChannelRound", "DESIGN_GAIN_BIG",
           "design_gains", "effective_noise_std", "get_channel_model",
           "list_channel_models", "observed_gains", "realized_cohort_size",
           "register_channel_model"]
