from repro_torch.checkpoint.io import (load_meta, restore,
                                       restore_train_state, save,
                                       save_train_state)

__all__ = ["save", "restore", "load_meta", "save_train_state",
           "restore_train_state"]
