"""whisper-tiny [audio] — enc-dec; conv/mel frontend is a STUB. [arXiv:2212.04356]

``input_specs`` supplies precomputed frame embeddings (batch, 1500, d_model)
for the encoder; we implement the transformer backbone only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_act="gelu",
    norm="layernorm",
    block_pattern=("attn",),
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    rope_theta=0.0,           # whisper uses learned absolute positions
    source="arXiv:2212.04356 (Whisper)",
)
