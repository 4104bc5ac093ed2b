"""Observability: tracing, metrics export, and the energy-drift
watchdog; the port's counterpart of the reference's ``obs/``.

Three pieces over the same runtime the energy ledger already prices:

  * ``Tracer``              — context-manager spans with stable ids,
    written as Chrome-trace-event JSON (Perfetto-loadable); spans
    cross-link the ``LedgerEntry`` they timed so the trace carries
    measured wall time AND predicted joules per span.
  * ``MetricsRegistry``     — counters/gauges/histograms exported as
    Prometheus text exposition format or JSONL snapshots.
  * ``EnergyDriftWatchdog`` — streams per-step measured/predicted
    ratios through windowed bands, records anomaly events to the
    ledger, and arms on-demand ``torch.profiler`` captures.

Every launcher takes ``--trace-out`` / ``--metrics-out``; ``python -m
repro_torch.launch.obs`` renders/inspects the artifacts.  The
module-level ``get_tracer()`` / ``get_metrics()`` defaults are free
no-ops / process-wide registries, so the deep wiring (trainer,
pipeline, elastic, serve, planner) costs nothing when observability is
off.  Ranks are processes in the port: ``obs/ranks.py`` carries each
rank's spans and metrics back to the parent and merges them.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, SNAPSHOT_SCHEMA,
                                     get_metrics, set_metrics)
from repro_torch.obs.trace import (NULL_TRACER, Span, TRACE_SCHEMA, Tracer,
                                   get_tracer, load_trace, set_tracer,
                                   span_events, use_tracer)
from repro_torch.obs.watchdog import EnergyDriftWatchdog, WatchdogEvent

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SNAPSHOT_SCHEMA", "get_metrics", "set_metrics",
    "NULL_TRACER", "Span", "TRACE_SCHEMA", "Tracer", "get_tracer",
    "load_trace", "set_tracer", "span_events", "use_tracer",
    "EnergyDriftWatchdog", "WatchdogEvent",
]
