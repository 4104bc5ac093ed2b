"""Per-request token sampling: greedy (default), temperature, top-k and
top-p (nucleus), with a seeded PRNG per request.

Sampling happens on host, on the ``[V]`` logits row the engine already
pulls back each step — a few hundred floats for the smoke vocabularies,
so there is nothing to win by keeping it on device, and host numpy gives
us a per-request ``Generator`` stream: a request's samples depend only
on its own seed and its own logits, never on which slot it landed in or
what else shared the batch.  That is what makes sampled serving
reproducible under continuous batching.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.  ``temperature == 0`` is greedy
    (argmax) and ignores the other knobs."""
    temperature: float = 0.0
    top_k: int = 0              # 0 = no top-k cut
    top_p: float = 1.0          # 1.0 = no nucleus cut
    seed: Optional[int] = None  # None = seed 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


class Sampler:
    """One request's sampling state (its own PRNG stream)."""

    def __init__(self, params: SamplingParams = GREEDY,
                 vocab_size: int = 0):
        self.params = params
        self.vocab_size = vocab_size
        self._rng = None
        if not params.greedy:
            self._rng = np.random.default_rng(
                params.seed if params.seed is not None else 0)

    def __call__(self, logits: np.ndarray) -> int:
        """logits: ``[V_padded]`` float row -> sampled token id."""
        if self.vocab_size:
            logits = logits[:self.vocab_size]
        if self.params.greedy:
            return int(np.argmax(logits))
        return int(sample_token(logits, self.params, self._rng))


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Temperature -> top-k -> top-p -> categorical draw."""
    scores = logits.astype(np.float64) / max(params.temperature, 1e-6)
    if params.top_k and params.top_k < scores.size:
        kth = np.partition(scores, -params.top_k)[-params.top_k]
        scores = np.where(scores < kth, -np.inf, scores)
    probs = _softmax(scores)
    if params.top_p < 1.0:
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order])
        # keep the smallest prefix reaching top_p (always >= 1 token)
        cut = int(np.searchsorted(csum, params.top_p)) + 1
        mask = np.zeros_like(probs, dtype=bool)
        mask[order[:cut]] = True
        probs = np.where(mask, probs, 0.0)
        probs = probs / probs.sum()
    return int(rng.choice(probs.size, p=probs))


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - np.max(x[np.isfinite(x)], initial=-np.inf)
    e = np.where(np.isfinite(x), np.exp(x), 0.0)
    return e / e.sum()
