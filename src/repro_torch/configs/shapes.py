"""Assigned input shapes and per-(arch x shape) input specs.

Every cell is (architecture x shape); ``train_*`` runs the train step,
``prefill_*`` the prefill step, ``decode_*`` / ``long_*`` one decode step
(one new token against a ``seq_len`` KV cache). ``long_500k`` applies
only to sub-quadratic architectures (``cfg.subquadratic``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention at 512k context; skipped "
                       "per assignment (sub-quadratic archs only)")
    return True, ""


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors standing in for the model inputs of one cell (the
    JAX package's ``ShapeDtypeStruct`` s).

    For ``train``/``prefill``: the full batch. For ``decode``: the one-token
    step inputs (the KV cache comes from ``lm.make_decode_state``).
    """
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    i32 = torch.int32
    if cfg.inputs == "embeds":
        spec = {
            "embeds": _sds((b, s, cfg.d_model), torch.bfloat16),
            "positions": _sds((3, b, s), i32),
        }
        if shape.kind == "train":
            spec["labels"] = _sds((b, s), i32)
        return spec
    if cfg.inputs == "codes":
        spec = {"codes": _sds((b, cfg.codebooks, s), i32)}
        if shape.kind == "decode":
            spec["positions"] = _sds((b, s), i32)
        return spec
    spec = {"tokens": _sds((b, s), i32)}
    if shape.kind == "decode":
        spec["positions"] = _sds((b, s), i32)
    return spec
