"""zamba2-2.7b [hybrid] — Mamba2 blocks + shared attention blocks. [arXiv:2411.15242]

54 layers as 9 repeats of (5x mamba, 1x attn); the attention blocks play the
role of Zamba2's shared attention; for long_500k they run in sliding-window
mode (see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    mlp_act="swiglu",
    norm="rmsnorm",
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "attn"),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=128),
    long_context_window=8192,
    source="arXiv:2411.15242 (Zamba2)",
)
