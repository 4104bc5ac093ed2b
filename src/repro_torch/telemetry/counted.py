"""Measured per-step costs, counted while the step runs: the port's
counterpart of the JAX package's ``telemetry/compiled.py``.

The reference reads the measured half of the ledger from the compiled
XLA program (``cost_analysis()`` and the HLO's collectives).  PyTorch
runs eagerly and compiles nothing, so ``count_step`` runs one step and
counts what it does:

  * flops: ``torch.utils.flop_counter.FlopCounterMode``, which sees every
    dispatched matrix product, the phantom kernels too: they are
    dispatcher operators with flop formulas
    (``kernels/phantom_fused.py``);
  * collectives: ``parallel/axes.py: record_collectives``, the log of
    every collective the rank's groups issued, priced on the logical
    collective with the same ring model the prediction uses
    (``telemetry/predict.py: event_wire_bytes``).  A logical collective
    that the backend runs as another (gloo's reduce-scatter is an
    all-reduce) keeps its logical wire bytes; ``issued_as`` says what ran.

XLA's HBM bytes (``hbm_bytes_per_device``) have no torch counterpart, so
the measured fields leave that key out; the prediction has no such key
either, so no ratio is lost.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.parallel.axes import record_collectives
from repro_torch.parallel.strategies.base import CommEvent
from repro_torch.telemetry.predict import event_wire_bytes


@dataclass
class MeasuredCosts:
    """Per-rank measured costs of one step."""
    flops: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_m_floats: float = 0.0   # paper Eqn. 26 message units
    collectives: dict = field(default_factory=dict)  # per-collective
    memory: dict = field(default_factory=dict)

    def measured_fields(self) -> dict:
        """The subset the ledger joins against predictions."""
        return {
            "flops_per_device": self.flops,
            "collective_wire_bytes_per_device": self.collective_wire_bytes,
            "collective_m_floats": self.collective_m_floats,
        }


def collective_costs(events) -> dict:
    """Per logical collective: count, message floats, ring wire bytes and
    the torch.distributed calls that ran it (``issued_as``: call ->
    count), from a ``CollectiveLog``'s events."""
    out = {}
    for ev in events:
        rec = out.setdefault(ev.collective, {
            "count": 0, "m_floats": 0.0, "wire_bytes": 0.0,
            "issued_as": {}})
        rec["count"] += 1
        rec["m_floats"] += ev.m_floats
        rec["wire_bytes"] += event_wire_bytes(
            CommEvent(ev.collective, ev.m_floats), ev.group)
        rec["issued_as"][ev.issued_as] = \
            rec["issued_as"].get(ev.issued_as, 0) + 1
    return out


def count_step(fn: Callable, *args,
               device=None) -> Tuple[MeasuredCosts, object]:
    """Run ``fn(*args)`` once, counting its flops and its collectives;
    returns ``(MeasuredCosts, fn's result)``.  With ``device`` the card,
    ``memory`` holds the peak bytes allocated during the step."""
    on_card = torch.device(device or "cpu").type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with record_collectives() as log, counter:
        out = fn(*args)
    memory = {}
    if on_card:
        torch.cuda.synchronize()
        memory["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    per_op = collective_costs(log.events)
    return MeasuredCosts(
        flops=float(counter.get_total_flops()),
        collective_wire_bytes=sum(r["wire_bytes"] for r in per_op.values()),
        collective_m_floats=sum(r["m_floats"] for r in per_op.values()),
        collectives=per_op, memory=memory), out
