"""mamba2-130m [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,            # no attention heads; SSD heads under ssm config
    n_kv_heads=1,
    d_ff=0,               # attention-free, no dense MLP
    vocab_size=50280,
    block_pattern=("mamba",),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128),
    source="arXiv:2405.21060 (Mamba-2 SSD)",
)
