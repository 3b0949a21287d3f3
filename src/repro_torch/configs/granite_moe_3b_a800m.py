"""granite-moe-3b-a800m [moe] — 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                      # per-expert FFN width
    vocab_size=49155,
    mlp_act="swiglu",
    norm="rmsnorm",
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=40, top_k=8, expert_ff=512, padded_experts=48),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (family card, 3b-a800m scale point)",
)
