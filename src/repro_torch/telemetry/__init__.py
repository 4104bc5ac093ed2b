"""Telemetry: the measured-vs-predicted energy ledger of the paper-FFN
step.

Three pieces, one join:

  * ``StepMeter`` / ``measure``      — time of executed steps
  * ``count_step``                   — flops (``FlopCounterMode``) and
    collective wire bytes (the groups' collective log) of the step that
    ran: the counterpart of the reference's compiled-HLO reading
  * ``strategy_prediction`` et al.   — the analytic account summed from
    the same ``ProjectionStrategy`` objects, priced by the paper's
    energy model

``Ledger`` records entries joining the views and writes the report to
the path its caller gives.  Serving, pipeline, KV-transfer and recovery
predictions are not ported yet (ROADMAP.md queue 1, item 4).
"""
from repro_torch.telemetry.counted import MeasuredCosts, count_step
from repro_torch.telemetry.ledger import (SCHEMA, Ledger, LedgerEntry,
                                          load_report)
from repro_torch.telemetry.meter import StepMeter, measure
from repro_torch.telemetry.predict import (event_wire_bytes, events_for,
                                           ffn_step_prediction,
                                           fused_ffn_step_prediction,
                                           fused_kernel_step_events,
                                           measured_energy_fields,
                                           strategy_prediction)
from repro_torch.telemetry.probe import make_ffn_probe_step, measure_ffn_step

__all__ = [
    "MeasuredCosts", "count_step", "SCHEMA", "Ledger",
    "LedgerEntry", "load_report", "StepMeter", "measure",
    "event_wire_bytes", "events_for", "ffn_step_prediction",
    "fused_ffn_step_prediction", "fused_kernel_step_events",
    "measured_energy_fields", "strategy_prediction",
    "make_ffn_probe_step", "measure_ffn_step",
]
