from repro_torch.core.privacy import LedgerState
from repro_torch.fl.algorithms import (Algorithm, get_algorithm,
                                       list_algorithms, register_algorithm,
                                       unregister_algorithm)
from repro_torch.fl.api import Trainer, TrainState
from repro_torch.fl.api import replace as replace
from repro_torch.fl.bank import (BankState, ClientBank, ResidentBank,
                                 StreamedBank, make_bank)
from repro_torch.fl.client import local_train, model_update
from repro_torch.fl.rounds import (FLState, evaluate, make_round_fn,
                                   make_training_fn, round_epsilon_spent,
                                   sample_cohort, setup, split_round_key)

# the reference's list; ``replace`` is importable from here as well
__all__ = ["Algorithm", "BankState", "ClientBank", "LedgerState",
           "ResidentBank", "StreamedBank", "Trainer", "TrainState",
           "get_algorithm", "list_algorithms", "make_bank",
           "register_algorithm", "unregister_algorithm", "local_train",
           "model_update", "FLState", "evaluate", "make_round_fn",
           "make_training_fn", "round_epsilon_spent", "sample_cohort",
           "setup", "split_round_key"]
