"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                     # per-expert FFN width
    vocab_size=151936,
    mlp_act="swiglu",
    norm="rmsnorm",
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768),
    source="hf:Qwen/Qwen3-30B-A3B",
)
