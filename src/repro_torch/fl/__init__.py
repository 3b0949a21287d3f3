from repro_torch.fl.algorithms import Algorithm, get_algorithm
from repro_torch.fl.api import Trainer, TrainState, replace
from repro_torch.fl.bank import BankState, ResidentBank
from repro_torch.fl.client import local_train, model_update
from repro_torch.fl.rounds import (evaluate, sample_cohort,
                                   split_round_key)

__all__ = ["Algorithm", "BankState", "ResidentBank", "Trainer",
           "TrainState", "evaluate", "get_algorithm", "local_train",
           "model_update", "replace", "sample_cohort",
           "split_round_key"]
