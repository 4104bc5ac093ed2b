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
the path its caller gives.  The pipelined step has its probe and
prediction too, and one serving step its prediction
(``serve_step_prediction``, which the router prices with) and the
fleet's KV-page transfer (``kv_transfer_prediction``), and the elastic
runtime's recovery account (``recovery_account``).
"""
from repro_torch.telemetry.counted import MeasuredCosts, count_step
from repro_torch.telemetry.ledger import (SCHEMA, Ledger, LedgerEntry,
                                          load_report)
from repro_torch.telemetry.meter import StepMeter, measure
from repro_torch.telemetry.predict import (CKPT_DISK_BW_BPS,
                                           event_wire_bytes, events_for,
                                           ffn_step_prediction,
                                           fused_ffn_step_prediction,
                                           fused_kernel_step_events,
                                           kv_cache_token_bytes,
                                           kv_transfer_prediction,
                                           measured_energy_fields,
                                           pipeline_ffn_step_events,
                                           pipeline_ffn_step_prediction,
                                           recovery_account,
                                           serve_overhead_events,
                                           serve_site_strategies,
                                           serve_step_events,
                                           serve_step_prediction,
                                           strategy_prediction)
from repro_torch.telemetry.probe import (make_ffn_pipeline_probe_step,
                                         make_ffn_probe_step,
                                         measure_ffn_pipeline_step,
                                         measure_ffn_step)

__all__ = [
    "MeasuredCosts", "count_step", "SCHEMA", "Ledger",
    "LedgerEntry", "load_report", "StepMeter", "measure",
    "event_wire_bytes", "events_for", "ffn_step_prediction",
    "fused_ffn_step_prediction", "fused_kernel_step_events",
    "kv_cache_token_bytes", "kv_transfer_prediction",
    "measured_energy_fields", "pipeline_ffn_step_events",
    "pipeline_ffn_step_prediction", "recovery_account",
    "CKPT_DISK_BW_BPS", "serve_overhead_events",
    "serve_site_strategies", "serve_step_events", "serve_step_prediction",
    "strategy_prediction",
    "make_ffn_pipeline_probe_step", "make_ffn_probe_step",
    "measure_ffn_pipeline_step", "measure_ffn_step",
]
