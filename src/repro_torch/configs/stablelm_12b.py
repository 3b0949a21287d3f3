"""stablelm-12b [dense] — GQA. [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    mlp_act="swiglu",
    norm="layernorm",
    block_pattern=("attn",),
    source="hf:stabilityai/stablelm-2-1_6b (family card, 12B scale point)",
)
