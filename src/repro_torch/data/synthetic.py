"""Synthetic datasets.

1. The paper's Gaussian-teacher dataset (§VI "Data and Hardware"): a
fixed standard-Gaussian W in R^{n x n}; samples (x, y) with
y = sigma(W sigma(x)), sigma = ReLU.

``gaussian_teacher`` is the reference's numpy draw, bit for bit.  The
reference draws ``x`` with ``jax.random``, which torch cannot reproduce;
here ``x`` comes from numpy, seeded by ``(17, step)``, so the CPU and the
card see the same batches.  They are not the reference's batches: parity
tests hand batches over explicitly.

2. Token streams for the LM trainer (``lm_token_batch``, ``LMDataset``):
the reference's construction, uniform categorical tokens with a copy of
the token 17 positions back at every 17th position, so the next-token
loss is learnable.  The tokens come from a ``torch.Generator`` on the
dataset's device, seeded per step; they are not the reference's
(``jax.random``), so parity tests hand its batches over as numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def gaussian_teacher(n: int, seed: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The paper's fixed teacher matrix W ~ N(0,1)^{n x n}, scaled by
    ``n ** -0.5`` unless told otherwise; float32 on the CPU."""
    rng = np.random.default_rng(seed)
    scale = scale if scale is not None else n ** -0.5
    return torch.from_numpy(
        (rng.standard_normal((n, n)) * scale).astype(np.float32))


def teacher_batch(W: torch.Tensor, batch: int, step: int):
    """(x, y) with y = relu(relu(x) @ W), on W's device — paper §VI."""
    rng = np.random.default_rng((17, step))
    x = torch.from_numpy(rng.standard_normal(
        (batch, W.shape[0]), dtype=np.float32)).to(W.device)
    return x, torch.relu(torch.relu(x) @ W)


class TeacherDataset:
    """Batches of the paper's dataset, deterministic per step."""

    def __init__(self, n: int, batch: int, seed: int = 0, device=None):
        self.W = gaussian_teacher(n, seed).to(device)
        self.batch = batch

    def __call__(self, step: int):
        return teacher_batch(self.W, self.batch, step)


PATTERN_PERIOD = 17


def lm_token_batch(vocab: int, batch: int, seq: int, seed: int,
                   device=None) -> torch.Tensor:
    """[batch, seq] int64 tokens on ``device``: uniform over the vocab,
    and at every ``PATTERN_PERIOD``-th position the uniform draw that
    many positions back (cyclically)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(
        (29 << 32) + seed)
    base = torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)
    copy = torch.arange(seq, device=device) % PATTERN_PERIOD == 0
    return torch.where(copy, base.roll(PATTERN_PERIOD, dims=1), base)


class LMDataset:
    """Next-token batches {"tokens", "labels"} [batch, seq - 1] of
    ``lm_token_batch``, deterministic per step, on ``device`` (the
    trainer's)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 device=None):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.device = seed, device

    def __call__(self, step: int):
        toks = lm_token_batch(self.vocab, self.batch, self.seq,
                              step + self.seed * 100003,
                              device=self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
