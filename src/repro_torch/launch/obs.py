"""Observability artifact inspector: the port's counterpart of the
reference's ``python -m repro.launch.obs``.

  # per-category span summary of a --trace-out file (validates schema)
  PYTHONPATH=src python -m repro_torch.launch.obs summary \
      --trace build/trace.json

  # print a --metrics-out export (Prometheus text or JSONL snapshots)
  PYTHONPATH=src python -m repro_torch.launch.obs metrics build/m.prom

  # cross-check an elastic trace against the priced recovery account:
  # the recovery spans (replan/restore/compile) must sum to the
  # recovery-account/v1 seconds within --tol
  PYTHONPATH=src python -m repro_torch.launch.obs verify-recovery \
      --trace build/trace.json --report build/elastic_report.json

The trace files are Chrome-trace-event JSON: open them directly in
Perfetto (https://ui.perfetto.dev) or chrome://tracing.  A run over
ranks writes one document: each rank's spans under ``pid = rank``
(``process_name`` ``rank r``), rank 0's beside the parent's on pid 0,
all on one clock origin, so the ranks' steps line up in Perfetto.
"""
import argparse
import json
import sys
from contextlib import contextmanager

from repro_torch.telemetry.ledger import REPORT_DIR

# the recovery account's measured restart seconds and the span names
# that time the same code blocks (train/elastic.py)
RECOVERY_SPANS = {"elastic/replan": "replan_s",
                  "elastic/restore": "restore_s",
                  "elastic/compile": "compile_s"}


def add_obs_args(ap: argparse.ArgumentParser):
    """The shared launcher flags (train/serve/plan all take them)."""
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace-event "
                         "JSON of this run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="export metrics: Prometheus text, or one "
                         "snapshot line appended for .jsonl paths")
    return ap


@contextmanager
def obs_session(trace_out=None, metrics_out=None, meta=None):
    """Install a fresh Tracer / MetricsRegistry for one launcher run
    and write the requested artifacts on exit (crash included — a
    failing run still leaves its trace behind).  The ranks the run
    spawns trace on this tracer's origin; each job's spans are merged
    into it, and rank 0's metrics into the registry, as the job returns
    (``launch/mesh.py: RankPool``), so what is written holds them."""
    from repro_torch.obs import (MetricsRegistry, Tracer, get_metrics,
                                 set_metrics, set_tracer)
    tracer = Tracer(meta=dict(meta or {})) if trace_out else None
    prev_t = set_tracer(tracer) if tracer is not None else None
    prev_m = set_metrics(MetricsRegistry()) if metrics_out else None
    try:
        yield tracer
    finally:
        if metrics_out:
            get_metrics().write(metrics_out, meta=dict(meta or {}))
            set_metrics(prev_m)
            print(f"[obs] metrics -> {metrics_out}")
        if tracer is not None:
            tracer.write(trace_out)
            set_tracer(prev_t)
            print(f"[obs] trace -> {trace_out}")


def cmd_summary(args) -> int:
    from repro_torch.obs import load_trace, span_events
    doc = load_trace(args.trace)
    evs = doc.get("traceEvents", [])
    spans = span_events(doc)
    instants = [e for e in evs if e.get("ph") == "i"]
    print(f"# {args.trace}: {len(evs)} events "
          f"({len(spans)} spans, {len(instants)} instants)")
    by_cat = {}
    for ev in spans:
        rec = by_cat.setdefault(ev.get("cat", "misc"),
                                {"spans": 0, "total_s": 0.0, "names": {}})
        rec["spans"] += 1
        rec["total_s"] += ev.get("dur", 0.0) * 1e-6
        n = rec["names"]
        n[ev["name"]] = n.get(ev["name"], 0) + 1
    for cat in sorted(by_cat):
        rec = by_cat[cat]
        names = ", ".join(f"{k} x{v}" for k, v in
                          sorted(rec["names"].items()))
        print(f"{cat:<12} {rec['spans']:>6} spans "
              f"{rec['total_s']:>10.3f} s   {names}")
    linked = sum(1 for ev in spans
                 if (ev.get("args") or {}).get("ledger"))
    print(f"# ledger-linked spans: {linked}")
    print("# open in Perfetto: https://ui.perfetto.dev "
          "(Open trace file)")
    return 0


def cmd_metrics(args) -> int:
    path = args.path
    if path.endswith(".jsonl"):
        from repro_torch.obs import SNAPSHOT_SCHEMA
        with open(path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if not lines:
            print(f"{path}: empty", file=sys.stderr)
            return 1
        for snap in lines:
            if snap.get("schema") != SNAPSHOT_SCHEMA:
                print(f"{path}: unknown snapshot schema "
                      f"{snap.get('schema')!r}", file=sys.stderr)
                return 1
        snap = lines[-1]
        print(f"# {path}: {len(lines)} snapshot(s); latest:")
        for name, m in snap["metrics"].items():
            vals = m["values"]
            if m["kind"] == "histogram":
                for lk, h in vals.items():
                    print(f"{name}{lk} count={h['count']} "
                          f"sum={h['sum']:.6g}")
            else:
                for lk, v in vals.items():
                    print(f"{name}{lk} {v:.6g}")
        return 0
    with open(path) as f:
        text = f.read()
    n_series = sum(1 for ln in text.splitlines()
                   if ln and not ln.startswith("#"))
    print(text, end="")
    print(f"# {path}: {n_series} series", file=sys.stderr)
    return 0


def cmd_verify_recovery(args) -> int:
    from repro_torch.obs import load_trace, span_events
    doc = load_trace(args.trace)
    span_s = {}
    for ev in span_events(doc):
        if ev["name"] in RECOVERY_SPANS:
            span_s[ev["name"]] = (span_s.get(ev["name"], 0.0)
                                  + ev.get("dur", 0.0) * 1e-6)
    with open(args.report) as f:
        rep = json.load(f)
    accounts = [
        (e.get("extra") or {}).get("recovery")
        for e in rep.get("entries", [])
        if (e.get("extra") or {}).get("recovery", {}).get("schema")
        == "recovery-account/v1"]
    if not accounts:
        print(f"{args.report}: no recovery-account/v1 entry",
              file=sys.stderr)
        return 1
    acct = accounts[-1]
    acct_s = sum(float(acct.get(k, 0.0))
                 for k in RECOVERY_SPANS.values())
    trace_s = sum(span_s.values())
    print(f"recovery spans: "
          + ", ".join(f"{n}={span_s.get(n, 0.0):.3f}s"
                      for n in sorted(RECOVERY_SPANS)))
    print(f"trace recovery seconds {trace_s:.3f} vs account "
          f"{acct_s:.3f} (replan {acct.get('replan_s', 0):.3f} + "
          f"restore {acct.get('restore_s', 0):.3f} + "
          f"compile {acct.get('compile_s', 0):.3f})")
    if acct_s <= 0 and trace_s <= 0:
        print("no recovery occurred in either view: consistent")
        return 0
    denom = max(acct_s, 1e-9)
    rel = abs(trace_s - acct_s) / denom
    if rel > args.tol:
        print(f"FAIL: trace and account disagree by {rel:.1%} "
              f"(> {args.tol:.0%})", file=sys.stderr)
        return 1
    print(f"OK: within {rel:.1%} (tolerance {args.tol:.0%})")
    return 0


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.obs",
        description="inspect --trace-out / --metrics-out artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary",
                       help="per-category span summary of a trace")
    s.add_argument("--trace", required=True)
    s.set_defaults(fn=cmd_summary)

    m = sub.add_parser("metrics",
                       help="print a Prometheus/.jsonl metrics export")
    m.add_argument("path")
    m.set_defaults(fn=cmd_metrics)

    v = sub.add_parser("verify-recovery",
                       help="check elastic recovery spans against the "
                            "recovery-account/v1 seconds")
    v.add_argument("--trace", required=True)
    v.add_argument("--report",
                   default=str(REPORT_DIR / "elastic_report.json"))
    v.add_argument("--tol", type=float, default=0.35,
                   help="relative tolerance (default 0.35: span and "
                        "account timers bracket slightly different "
                        "code)")
    v.set_defaults(fn=cmd_verify_recovery)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
