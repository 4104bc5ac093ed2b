"""The plan report: the planner's single output artifact; the port's
copy of the reference's ``planner/report.py``, the same schema.

Schema ``plan-report/v1``: calibration (constants + provenance: fitted
from which ledger rows, or the documented paper-defaults fallback), the
enumerated/rejected/scored candidates, the Pareto frontier, the
iso-loss section (curves, pilots, the matched-loss comparison) and the
winning plan.  The report is plain JSON, so a report from either
package loads in the other.  The port writes its reports under
``build/`` (``DEFAULT_REPORT``); the repo-root ``PLAN_report.json`` is
the JAX package's and ``write_plan_report`` refuses it.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.planner.calibration import Calibration
from repro_torch.planner.constraints import Constraints, Rejection
from repro_torch.planner.isoloss import IsoLossResult
from repro_torch.planner.score import ScoredPlan
from repro_torch.telemetry.ledger import REPORT_DIR

PLAN_SCHEMA = "plan-report/v1"
DEFAULT_REPORT = REPORT_DIR / "PLAN_report.json"
_REFERENCE_REPORT = REPORT_DIR.parent / "PLAN_report.json"


def pick_winner(frontier: Sequence[ScoredPlan]) -> Optional[ScoredPlan]:
    """Lowest calibrated total energy; ties break toward fewer devices,
    then faster steps."""
    if not frontier:
        return None
    return min(frontier, key=lambda s: (s.energy_j_total,
                                        s.plan.devices, s.step_time_s))


def build_report(*, calibration: Calibration, constraints: Constraints,
                 scored: Sequence[ScoredPlan],
                 frontier: Sequence[ScoredPlan],
                 rejected: Sequence[Rejection] = (),
                 throughput_rejected: Sequence[tuple] = (),
                 iso: Optional[IsoLossResult] = None,
                 comparison: Optional[dict] = None,
                 meta: Optional[dict] = None) -> dict:
    winner = pick_winner(frontier)
    return {
        "schema": PLAN_SCHEMA,
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "meta": dict(meta or {}),
        "calibration": calibration.as_dict(),
        "constraints": constraints.as_dict(),
        "counts": {
            "scored": len(scored),
            "frontier": len(frontier),
            "rejected": len(rejected) + len(throughput_rejected),
        },
        "rejected": [r.as_dict() for r in rejected]
                    + [{"plan": s.plan.name, "reason": why}
                       for s, why in throughput_rejected],
        "plans": [s.as_dict() for s in scored],
        "frontier": [s.as_dict() for s in frontier],
        "iso_loss": iso.as_dict() if iso is not None else None,
        "comparison": comparison,
        "winner": winner.as_dict() if winner is not None else None,
    }


def write_plan_report(report: dict, path) -> str:
    """Write ``report`` to ``path`` (its directory made first); the JAX
    package's repo-root ``PLAN_report.json`` is refused."""
    path = Path(path).resolve()
    if path == _REFERENCE_REPORT:
        raise ValueError(f"{path} is the JAX package's plan report (repo "
                         f"root); the port writes its own under "
                         f"{REPORT_DIR}")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return str(path)


def load_plan_report(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    if rec.get("schema") != PLAN_SCHEMA:
        raise ValueError(f"{path}: unknown plan schema "
                         f"{rec.get('schema')!r} (want {PLAN_SCHEMA})")
    return rec


def record_frontier(ledger, frontier: Sequence[ScoredPlan],
                    calibration: Calibration,
                    suite: str = "plan_smoke") -> List:
    """Stream the frontier through the shared Ledger, one entry per
    frontier plan, tagged with the producing suite."""
    from repro_torch.telemetry import LedgerEntry
    out = []
    for s in frontier:
        out.append(ledger.record(LedgerEntry(
            name=f"plan_{s.plan.name}", suite=suite, kind="plan",
            arch=s.plan.name, impl=s.plan.strategy, p=s.plan.tp,
            predicted={
                "energy_j_total": s.energy_j_total,
                "energy_j_per_iter": s.energy_j_per_iter,
                "step_time_s": s.step_time_s,
                "iterations": s.iterations,
                "alpha_s": s.alpha_s, "beta_s": s.beta_s,
                "predicted_loss": s.predicted_loss,
            },
            extra={"devices": s.plan.devices, "dp": s.plan.dp,
                   "width": s.plan.width, "k": s.plan.k,
                   "calibration_source": calibration.source})))
    return out


def plan_summary_lines(report: dict) -> List[str]:
    """Human-readable frontier table (CLI output)."""
    lines = ["plan                                    devices  "
             "energy_J   step_s    loss",
             "-" * 72]
    for s in report.get("frontier", []):
        p = s["plan"]
        loss = s.get("predicted_loss")
        lines.append(f"{p['name']:<40}{p['devices']:>6}  "
                     f"{s['energy_j_total']:>9.3g}  {s['step_time_s']:>8.3g}"
                     f"  {loss if loss is None else format(loss, '.4f')}")
    comp = report.get("comparison") or {}
    if comp:
        lines.append("")
        lines.append(f"phantom-on-smaller-mesh dominates full-mesh TP: "
                     f"{comp.get('phantom_dominates')}")
        if comp.get("best_phantom_smaller"):
            bp, bt = comp["best_phantom_smaller"], comp["best_tensor_full"]
            lines.append(
                f"  best phantom: {bp['plan']} ({bp['devices']} dev, "
                f"{bp['energy_j']:.3g} J) vs best full-mesh TP: "
                f"{bt['plan']} ({bt['devices']} dev, "
                f"{bt['energy_j']:.3g} J)")
    w = report.get("winner")
    if w:
        lines.append(f"winner: {w['plan']['name']} "
                     f"({w['plan']['devices']} devices, "
                     f"{w['energy_j_total']:.3g} J to target)")
    return lines
