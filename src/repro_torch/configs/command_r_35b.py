"""command-r-35b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    qkv_bias=False,
    mlp_act="swiglu",
    norm="layernorm",
    block_pattern=("attn",),
    source="hf:CohereForAI/c4ai-command-r-v01",
)
