"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution; ViT frontend is a STUB.
[arXiv:2409.12191]

``input_specs`` supplies precomputed patch embeddings for a vision prefix of
1024 tokens (32x32 grid at one frame); the language backbone applies M-RoPE
(temporal/height/width position ids) over the prefix and 1-D positions over
text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    rope_theta=1000000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    block_pattern=("attn",),
    vision_prefix=1024,
    source="arXiv:2409.12191 (Qwen2-VL)",
)
