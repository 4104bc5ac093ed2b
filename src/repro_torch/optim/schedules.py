"""Learning-rate schedules: plain functions of the step counter, the
reference's ``optim/schedules.py`` in Python floats."""
from __future__ import annotations

import math


def _clip(v: float, lo: float, hi: float) -> float:
    return min(max(v, lo), hi)


def constant(lr: float):
    def sched(step):
        return float(lr)
    return sched


def warmup_linear(lr: float, warmup: int, total: int, floor: float = 0.0):
    def sched(step):
        step = float(step)
        if step < warmup:
            return lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = _clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return lr + (floor - lr) * frac
    return sched


def warmup_cosine(lr: float, warmup: int, total: int, floor_frac: float = 0.1):
    def sched(step):
        step = float(step)
        if step < warmup:
            return lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = _clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + math.cos(math.pi * frac)))
    return sched
