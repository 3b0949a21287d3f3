from repro_torch.models import (attention, cnn, layers, mamba2, moe,
                                transformer)
from repro_torch.models.cnn import apply_cnn, cnn_loss, init_cnn
from repro_torch.models.transformer import (decode_step, forward_train,
                                            init_params, init_shapes,
                                            logical_axes, make_caches,
                                            param_count, prefill)

__all__ = [
    "attention", "cnn", "layers", "mamba2", "moe", "transformer",
    "apply_cnn", "cnn_loss", "init_cnn",
    "decode_step", "forward_train", "init_params", "init_shapes",
    "logical_axes", "make_caches", "param_count", "prefill",
]
