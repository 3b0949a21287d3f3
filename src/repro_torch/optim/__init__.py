from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.optim.schedules import constant, cosine, warmup_cosine
from repro_torch.optim.sgd import sgd_init, sgd_update

__all__ = ["sgd_init", "sgd_update", "adam_init", "adam_update",
           "constant", "cosine", "warmup_cosine"]
