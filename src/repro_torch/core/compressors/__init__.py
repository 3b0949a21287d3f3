"""Update-compression registry (port of ``repro/core/compressors``).
``PFELSConfig.compressor`` names an entry; importing this package
registers the reference's four: ``rand_k`` (the paper's uniform draw,
with the ``server_topk`` mode), ``top_k_ef`` (magnitude top-k of the
released aggregate with mandatory error feedback), ``threshold``
(hard-threshold sparsification padded to the budget) and
``stoch_quant`` (unbiased stochastic quantization). ``schedules``
evaluates ``CompressionSchedule``."""
from repro_torch.core.compressors import (quant, rand_k,  # noqa: F401
                                          schedules, threshold, top_k)
from repro_torch.core.compressors.base import (QUANT_STREAM_TAG,
                                               Compressor, Support,
                                               and_active, as_support,
                                               carry_required,
                                               decode_support, dense_mask,
                                               get_compressor,
                                               list_compressors, project,
                                               register_compressor,
                                               sensitivity_factor, sparsify,
                                               support_size,
                                               unregister_compressor)

__all__ = ["Compressor", "Support", "QUANT_STREAM_TAG", "and_active",
           "as_support", "carry_required", "decode_support", "dense_mask",
           "get_compressor", "list_compressors", "project",
           "register_compressor", "schedules", "sensitivity_factor",
           "sparsify", "support_size", "unregister_compressor"]
