"""Architecture registry: dashed public ids -> ModelConfig, plus reduced
smoke variants (2 layers, d_model <= 512, <= 4 experts)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.command_r_35b import CONFIG as _commandr
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (
    _qwen25, _granite, _zamba2, _stablelm, _phi3,
    _mamba2, _whisper, _commandr, _qwen3moe, _qwen2vl,
)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def reduced_config(name: str) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests:
    2 layers (one pattern repeat where the pattern is longer), d_model<=256,
    <=4 experts, small vocab."""
    c = get_config(name)
    d_model = min(c.d_model, 256)
    n_heads = min(c.n_heads, 4)
    n_kv = min(c.n_kv_heads, n_heads)
    head_dim = 64
    kw = dict(
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(c.d_ff, 512) if c.d_ff else 0,
        vocab_size=min(c.vocab_size, 512),
        vision_prefix=min(c.vision_prefix, 16),
        encoder_seq=min(c.encoder_seq, 32),
        n_encoder_layers=min(c.n_encoder_layers, 2),
        long_context_window=256,
    )
    if len(c.block_pattern) > 2:
        # hybrid: keep the pattern shape but shrink to one repeat of
        # (mamba, attn)
        kw["block_pattern"] = ("mamba", "attn")
        kw["n_layers"] = 2
        kw["n_repeat"] = 1
    else:
        kw["n_layers"] = 2 * len(c.block_pattern)
        kw["n_repeat"] = 2
    if c.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2,
                              expert_ff=min(c.moe.expert_ff, 256),
                              capacity_factor=2.0)
    if c.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=min(c.ssm.state_dim, 32),
                              head_dim=32, expand=2, chunk_size=32)
    return dataclasses.replace(c, name=c.name + "-smoke", **kw)
