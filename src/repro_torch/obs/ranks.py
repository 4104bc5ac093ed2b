"""Observability over ranks that are processes.

The reference traces one SPMD program in one process; the port runs a
mesh as one process per rank (``launch/mesh.py: RankPool``).  Each job
of a pool runs in every rank under ``observed``: a ``Tracer`` on the
parent's origin (when the parent traces) and a fresh
``MetricsRegistry``, whose events and raw state travel back with the
job's result.  ``merge`` puts them into the parent's: every rank's
events under ``pid = rank`` (``Tracer.add_rank``), rank 0's metrics
added to the parent's registry, which are then the reference's
single-process counts (one ``train_steps_total`` per step, not one per
rank).  The other ranks' metrics stay readable as ``RankPool.
rank_metrics`` (a ``dump`` each: ``MetricsRegistry().absorb(dump)``
reads one)."""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.obs.metrics import MetricsRegistry, get_metrics, set_metrics
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer


def rank_spec() -> dict:
    """What a job's ranks need from the parent: its tracer's origin, or
    None when it does not trace."""
    tracer = get_tracer()
    return {"origin": tracer.origin if tracer.enabled else None}


def observed(fn: Callable, spec: Optional[dict], *args):
    """In a rank: ``fn(*args)`` under its own tracer and registry;
    returns ``(result, seen)``, ``seen`` the rank's trace events and
    metrics ``dump``."""
    origin = (spec or {}).get("origin")
    tracer = Tracer(origin=origin) if origin is not None else None
    prev_t = set_tracer(tracer)
    prev_m = set_metrics(MetricsRegistry())
    try:
        out = fn(*args)
        seen = {"trace": (tracer.to_chrome()["traceEvents"]
                          if tracer is not None else []),
                "metrics": get_metrics().dump()}
        return out, seen
    finally:
        set_tracer(prev_t)
        set_metrics(prev_m)


def merge(seen: List[dict]):
    """In the parent: every rank's events into the current tracer, rank
    0's metrics into the current registry."""
    tracer = get_tracer()
    if tracer.enabled:
        for rank, s in enumerate(seen):
            tracer.add_rank(rank, s["trace"])
    get_metrics().absorb(seen[0]["metrics"])
