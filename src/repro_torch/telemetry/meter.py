"""Per-call timing of step functions.

``StepMeter`` times every call of a prefill or decode step and keeps the
samples; the first ``warmup`` calls are recorded but left out of the
summary.  On the card a call is timed with CUDA events around it on the
current stream, synchronised at the end, so asynchronous launches cannot
hide the device work; on the CPU with ``time.perf_counter``.

``measure(fn, *args)`` is the one-shot variant the benchmarks use: the
median of ``iters`` timed calls after ``warmup`` untimed ones.  The
reference's ``record_to`` (the serving engine's ledger export) comes
with the serving ledger.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch


class StepMeter:
    """Records per-call time (microseconds) for one step function."""

    def __init__(self, name: str, warmup: int = 1, device=None):
        self.name = name
        self.warmup = warmup
        self.device = torch.device(device or "cpu")
        self.times_us: list[float] = []

    def call(self, fn: Callable, *args, **kwargs):
        """Call ``fn``, wait for its device work, record the time."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            self.times_us.append(start.elapsed_time(end) * 1e3)
            return out
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.times_us.append((time.perf_counter() - t0) * 1e6)
        return out

    @property
    def calls(self) -> int:
        return len(self.times_us)

    @property
    def steady(self) -> list[float]:
        """Post-warmup samples."""
        return self.times_us[self.warmup:]

    def median_us(self) -> float:
        s = self.steady
        return float(np.median(s)) if s else 0.0

    def summary(self) -> dict:
        s = self.steady
        out = {"name": self.name, "calls": self.calls,
               "warmup": min(self.warmup, self.calls),
               "total_s": float(np.sum(self.times_us)) * 1e-6}
        if s:
            out.update({"wall_us_mean": float(np.mean(s)),
                        "wall_us_median": float(np.median(s)),
                        "wall_us_min": float(np.min(s)),
                        "wall_us_max": float(np.max(s))})
        return out

    def __repr__(self):
        return (f"StepMeter({self.name!r}, calls={self.calls}, "
                f"median={self.median_us():.1f}us)")


def measure(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            device=None, meter: Optional[StepMeter] = None) -> float:
    """Median time per call in microseconds, each call waited for on the
    card (CUDA events) or timed on the host clock on the CPU; optionally
    records every timed call into ``meter`` as well."""
    timer = StepMeter("measure", warmup=warmup, device=device)
    for _ in range(warmup + iters):
        timer.call(fn, *args)
    if meter is not None:
        meter.times_us.extend(timer.steady)
    return timer.median_us()
