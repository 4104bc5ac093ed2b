"""Shared benchmark utilities of the port (the counterpart of the JAX
package's ``benchmarks/common.py``).

``emit`` prints the reference's ``name,us,derived`` CSV line and records
a ``LedgerEntry`` into the ledger its caller gives.  The port's reports
go under ``build/`` at the root of the checkout (``telemetry/ledger.py:
REPORT_DIR``), never to the repo-root ``BENCH_report.json``, which
belongs to the JAX package (``Ledger.write_report`` refuses it).
"""
from __future__ import annotations

from repro_torch.telemetry import Ledger, LedgerEntry


def emit(ledger: Ledger, name: str, us: float, derived: str = "", *,
         suite: str = "", kind: str = "bench", arch: str = "",
         impl: str = "", p: int = 0, measured=None, predicted=None,
         extra=None) -> LedgerEntry:
    """Print the CSV line AND record a ledger entry.  ``us`` is a model
    value for analytic rows, and the wall median otherwise; rows without
    a ``measured`` dict get it as ``wall_us_median``."""
    print(f"{name},{us:.1f},{derived}", flush=True)
    ex = dict(extra or {})
    if derived:
        ex["derived"] = derived
    m = dict(measured or {})
    if us and measured is None and kind not in ("analytic", "derived",
                                                "skip"):
        m.setdefault("wall_us_median", us)
    return ledger.record(LedgerEntry(
        name=name, suite=suite, kind=kind, arch=arch, impl=impl, p=p,
        measured=m or None, predicted=dict(predicted) if predicted
        else None, extra=ex))

