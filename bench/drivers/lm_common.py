"""What the language-model drivers share: the port's ``ModelConfig`` from
a configuration file's ``model``, and the reference's leaves as the
port's nested params tree."""
from __future__ import annotations

import dataclasses

import torch


def model_config(m, name: str):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in m.items() if k in fields and k != "ssm"}
    kw["block_pattern"] = tuple(m["block_pattern"])
    if "ssm" in m:
        sf = {f.name for f in dataclasses.fields(SSMConfig)}
        kw["ssm"] = SSMConfig(**{k: v for k, v in m["ssm"].items()
                                 if k in sf})
    kw.setdefault("family", "hybrid" if "ssm" in m else "dense")
    return ModelConfig(name=name, **kw)


def program_tree(weights):
    """{path: tensor} -> the port's tree: nested dicts, the pattern's
    blocks as a tuple."""
    tree = {}
    for path, t in weights.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    blocks = tree["blocks"]
    tree["blocks"] = tuple(blocks[i] for i in range(len(blocks)))
    return tree


def check_layout(cfg, specs) -> None:
    """The port's params (as meta tensors) have the reference's leaves in
    the same order, shapes and dtypes."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    got = [(tuple(x.shape), x.dtype) for x in tree_leaves(T.init_shapes(cfg))]
    want = [(tuple(s[1]), getattr(torch, s[2])) for s in specs]
    if got != want:
        raise ValueError("the port's params do not match the reference's "
                         "layout")
