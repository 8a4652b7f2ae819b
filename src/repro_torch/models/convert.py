"""Carry the JAX package's model weights across to the port.

The JAX parameter tree arrives as nested dicts of numpy arrays (each
``Param.value``; the converter itself imports no JAX):
``{"embed", "stack": {"head": [block], "groups": {"b<i>": block with a
leading group axis}, "tail": [block]}, "final_norm", ["unembed"]}``. The
port's tree is :func:`repro_torch.models.lm.init_model`'s: the scanned
groups unstacked into one ``"layers"`` list in execution order (head,
then each group's blocks, then tail), float32 masters kept as they are.
An MoE block's ``ffn`` (``router [D, E]``, ``w_gate``/``w_up`` ``[E, D,
F]``, ``w_down [E, F, D]`` and an optional ``shared`` MLP) carries
across leaf by leaf, like every other sub-tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_jax(tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The port's parameter tree from the JAX package's (numpy leaves)."""
    stack = tree["stack"]
    groups = stack["groups"]
    layers = [_tensors(b, device) for b in stack["head"]]
    for g in range(cfg.n_groups):
        for i in range(len(cfg.pattern)):
            layers.append(_tensors(_index(groups[f"b{i}"], g), device))
    layers += [_tensors(b, device) for b in stack["tail"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the JAX tree holds {len(layers)} "
                         f"layers, the config {cfg.n_layers}")
    out = {"embed": _tensors(tree["embed"], device), "layers": layers,
           "final_norm": _tensors(tree["final_norm"], device)}
    if "unembed" in tree:
        out["unembed"] = _tensors(tree["unembed"], device)
    return out


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]
