from repro_torch.sharding.rules import (PURE_FSDP, exclude_axes,
                                        logical_overrides, resolve_spec,
                                        shard_shape, tree_specs)

__all__ = ["PURE_FSDP", "exclude_axes", "logical_overrides",
           "resolve_spec", "shard_shape", "tree_specs"]
