from repro_torch.core.compressors import rand_k  # noqa: F401
from repro_torch.core.compressors.base import (Compressor, Support,
                                               as_support,
                                               decode_support,
                                               get_compressor, project,
                                               register_compressor,
                                               sensitivity_factor,
                                               sparsify, support_size)

__all__ = ["Compressor", "Support", "as_support",
           "decode_support", "get_compressor", "project",
           "register_compressor", "sensitivity_factor", "sparsify",
           "support_size"]
