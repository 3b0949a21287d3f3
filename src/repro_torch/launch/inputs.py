"""Shape-only inputs of each step kind (port of
``repro/launch/inputs.py``): ``meta`` tensors with the reference's shapes
and dtypes, which ``launch.dryrun`` runs the port's steps on. With a mesh
(``launch.mesh.MeshShape``) each function also returns every input's
resolved spec (the entries of the reference's ``PartitionSpec``), in a
tree of the inputs' structure.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.attention import kv_cache_spec
from repro_torch.sharding.rules import resolve_spec


def _meta(shape, dtype, logical, mesh, specs: Dict, name: str):
    if mesh is not None:
        specs[name] = resolve_spec(logical, shape, mesh)
    return torch.empty(shape, dtype=dtype, device="meta")


def _with_specs(out, specs, mesh):
    return out if mesh is None else (out, specs)


def train_batch_specs(cfg: ModelConfig, shape: InputShape, mesh=None):
    """{tokens, labels (B, S_text) int32; the VLM's vision_embeds (B, P,
    D) and Whisper's audio_embeds (B, Senc, D) in the model's dtype}; with
    ``mesh``, (that dict, its specs)."""
    b, s = shape.global_batch, shape.seq_len
    dt = layers.torch_dtype(cfg.dtype)
    s_text = s - cfg.vision_prefix if cfg.family == "vlm" else s
    specs: Dict = {}
    batch = {"tokens": _meta((b, s_text), torch.int32, ("batch", None),
                             mesh, specs, "tokens"),
             "labels": _meta((b, s_text), torch.int32, ("batch", None),
                             mesh, specs, "labels")}
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta(
            (b, cfg.vision_prefix, cfg.d_model), dt, ("batch", None, None),
            mesh, specs, "vision_embeds")
    if cfg.is_encoder_decoder:
        batch["audio_embeds"] = _meta(
            (b, cfg.encoder_seq, cfg.d_model), dt, ("batch", None, None),
            mesh, specs, "audio_embeds")
    return _with_specs(batch, specs, mesh)


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape, mesh=None):
    """``train_batch_specs`` without the labels."""
    out = train_batch_specs(cfg, shape, mesh)
    batch, specs = (out, {}) if mesh is None else out
    batch.pop("labels")
    specs.pop("labels", None)
    return _with_specs(batch, specs, mesh)


def _cache_spec(name: str, t: torch.Tensor, mesh):
    if name in ("k", "v"):          # stacked (rep, B, S, Hkv, Dh)
        return (None,) + tuple(kv_cache_spec(tuple(t.shape[1:]), mesh))
    if name in ("ssm", "conv"):     # stacked (rep, B, ...) state
        return resolve_spec((None, "batch") + (None,) * (t.ndim - 2),
                            tuple(t.shape), mesh)
    return resolve_spec((None,) * t.ndim, tuple(t.shape), mesh)


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                 window: Optional[int] = None):
    """{token (B, 1) int32, caches (``T.make_caches`` on ``meta``: a
    cache of ``seq_len`` slots, or the ring buffer of ``window`` slots),
    and Whisper's enc_out (B, Senc, D)}: one new token's inputs; with
    ``mesh``, (that dict, its specs)."""
    b, s = shape.global_batch, shape.seq_len
    dt = layers.torch_dtype(cfg.dtype)
    caches = T.make_caches(cfg, b, s, window=window, dtype=dt,
                           device="meta")
    specs: Dict = {}
    out = {"token": _meta((b, 1), torch.int32, ("batch", None), mesh, specs,
                          "token"),
           "caches": caches}
    if mesh is not None:
        specs["caches"] = tuple({k: _cache_spec(k, t, mesh)
                                 for k, t in c.items()} for c in caches)
    if cfg.is_encoder_decoder:
        out["enc_out"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt,
                               ("batch", None, None), mesh, specs, "enc_out")
    return _with_specs(out, specs, mesh)


def batch_div(mesh) -> int:
    """The extent of the batch axes (pod x data) of ``mesh``."""
    n = 1
    for a in ("pod", "data"):
        n *= mesh.shape.get(a, 1)
    return n


def long_context_window(cfg: ModelConfig, shape: InputShape
                        ) -> Optional[int]:
    """The sliding window of the long_500k shape (DESIGN.md §5): the
    config's ``long_context_window``; None for every other shape and for
    the attention-free ssm family."""
    if shape.name != "long_500k":
        return None
    if cfg.family == "ssm":
        return None
    return cfg.long_context_window
