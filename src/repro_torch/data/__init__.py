from repro_torch.data.loader import (ArraySource, ClientFnSource,
                                     CohortSource, as_cohort_source,
                                     epoch_batches, prefetch_cohorts,
                                     sample_batch)
from repro_torch.data.synthetic import (make_federated_classification,
                                        make_lm_sequences,
                                        make_population_source,
                                        make_prototypes)

__all__ = ["ArraySource", "ClientFnSource", "CohortSource",
           "as_cohort_source", "epoch_batches", "make_federated_classification",
           "make_lm_sequences",
           "make_population_source", "make_prototypes", "prefetch_cohorts",
           "sample_batch"]
