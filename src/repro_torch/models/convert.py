"""Carry the JAX package's model weights across to the port.

The JAX parameter tree arrives as nested dicts of numpy arrays (each
``Param.value``; the converter itself imports no JAX):
``{["embed"], "stack": {"head": [block], "groups": {"b<i>": block with a
leading group axis}, "tail": [block]}, "final_norm", ["unembed" |
"heads"]}``. The port's tree is :func:`repro_torch.models.lm.
init_model`'s: the scanned groups (``b0..b<n-1>`` of an n-block pattern)
unstacked into one ``"layers"`` list in execution order (head, then each
group's blocks, then tail), float32 masters kept as they are. Every
sub-tree carries across leaf by leaf: an MoE block's experts, MLA's
projections and norms, the RG-LRU's conv and Lambda, the mLSTM's and
sLSTM's projections, gates and recurrent matrix, LayerNorm biases, the
codes embedding ``[K, V, D]`` and heads ``[K, D, V]``.
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
    """The port's parameter tree from the JAX package's (numpy leaves);
    any tree shaped like the params (gradients, optimiser moments)
    carries across the same way."""
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
    out = {"layers": layers,
           "final_norm": _tensors(tree["final_norm"], device)}
    for k in ("embed", "unembed", "heads"):
        if k in tree:
            out[k] = _tensors(tree[k], device)
    return out


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def opt_state_from_jax(state, cfg: ArchConfig, device="cpu"):
    """The port's :class:`repro_torch.optim.AdamWState` from the JAX
    package's ``AdamWState`` with numpy leaves: ``m``, ``v`` and, under
    compression, ``err``, each shaped like the params."""
    from repro_torch.optim import AdamWState

    def tree(t):
        return None if t is None else params_from_jax(t, cfg, device)
    return AdamWState(m=tree(state.m), v=tree(state.v), err=tree(state.err))
