from repro_torch.data.loader import sample_batch
from repro_torch.data.synthetic import (make_federated_classification,
                                        make_prototypes)

__all__ = ["make_federated_classification", "make_prototypes",
           "sample_batch"]
