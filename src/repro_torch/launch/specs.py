"""Shapes and dtypes of the model's inputs and of its decode cache for
one (arch x shape) cell, without allocating (the reference's
``input_specs`` / ``cache_specs``; the serving engine adds the stubbed
frontends' inputs itself: ``serve/engine.py: _add_modality_stubs``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import cache_decls
from repro_torch.parallel.axes import MeshAxes
from repro_torch.parallel.params import TensorSpec


def input_specs(cfg: ModelConfig, shape: ShapeConfig, axes: MeshAxes):
    """train: tokens and labels [B, S]; prefill: tokens [B, S]; decode:
    tokens [B, 1] (positions and the cache are passed separately)."""
    B = shape.global_batch
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    S = 1 if shape.kind == "decode" else shape.seq_len
    specs = {"tokens": TensorSpec((B, S), torch.int64)}
    if shape.kind == "train":
        specs["labels"] = TensorSpec((B, S), torch.int64)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, axes: MeshAxes):
    """The decode cache of this cell: {k, v} [L, B, S, kv, hd], the SSM
    family's state {conv, ssm}, a hybrid's tree of both, one per sub of
    its superblock, or an encoder-decoder's {self, cross}, the cross K/V
    ``S`` rows long too (``models/model.py: cache_decls``)."""
    return cache_decls(cfg, axes, shape.global_batch, shape.seq_len)
