"""Shapes and dtypes of the model's inputs and of its decode cache for
one (arch x shape) cell, without allocating (the reference's
``input_specs`` / ``cache_specs``, for the dense family)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import cache_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import TensorSpec


def input_specs(cfg: ModelConfig, shape: ShapeConfig, axes: MeshAxes):
    """prefill: tokens [B, S]; decode: tokens [B, 1] (positions and the
    cache are passed separately)."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind == "prefill" else 1
    if shape.kind not in ("prefill", "decode"):
        raise NotImplementedError(
            f"shape kind {shape.kind!r}: training arrives with the "
            f"trainer slice (ROADMAP.md queue 1)")
    return {"tokens": TensorSpec((B, S), torch.int64)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, axes: MeshAxes):
    """The decode KV cache of this cell: {k, v} [L, B, S, kv, hd]."""
    return cache_decls(cfg, axes, shape.global_batch, shape.seq_len)
