"""Audit orchestration: run every rule, apply the baseline, emit the
``audit-report/v1`` record (the port of the JAX package's
``analysis/engine.py``).

``run_audit`` is the library entry point ``repro_torch.launch.audit``
wraps; ``audit_plans`` is the planner's gate (``launch/plan.py`` drops
frontier candidates whose audit has active errors, and
``train/elastic.py: solve_plan`` walks its candidates until one passes).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import (Baseline, Finding, apply_baseline,
                                           severity_counts)
from repro_torch.analysis.rules import run_rules
from repro_torch.analysis.units import AuditUnit

AUDIT_SCHEMA = "audit-report/v1"


@dataclass
class AuditResult:
    findings: List[Finding] = field(default_factory=list)   # active
    suppressed: List[Finding] = field(default_factory=list)
    stale_suppressions: List[str] = field(default_factory=list)
    units: List[AuditUnit] = field(default_factory=list)
    baseline_path: Optional[str] = None

    @property
    def counts(self) -> Dict[str, int]:
        return severity_counts(self.findings)

    @property
    def ok(self) -> bool:
        """True when nothing ERROR-severity is active (warnings and
        info report but don't gate)."""
        return self.counts["error"] == 0

    def as_dict(self) -> dict:
        return {
            "schema": AUDIT_SCHEMA,
            "ok": self.ok,
            "counts": self.counts,
            "units": [{
                "name": u.name, "kind": u.kind, "axes": dict(u.axes),
                "strict": u.strict, "compute_dtype": u.compute_dtype,
                "collectives": {
                    f"{kind}@g{g}": dict(b)
                    for (kind, g), b in sorted(
                        u.measured_buckets().items())},
                "predicted": {
                    f"{kind}@g{g}": dict(b)
                    for (kind, g), b in sorted(
                        u.predicted_buckets().items())},
                "meta": {k: v for k, v in u.meta.items()
                         if isinstance(v, (str, int, float, bool))},
            } for u in self.units],
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
            "stale_suppressions": list(self.stale_suppressions),
            "baseline": self.baseline_path,
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)
            f.write("\n")

    def summary_lines(self) -> List[str]:
        c = self.counts
        lines = [f"# audit: {len(self.units)} units, "
                 f"{c['error']} errors / {c['warning']} warnings / "
                 f"{c['info']} info "
                 f"({len(self.suppressed)} baseline-suppressed)"]
        for f in self.findings:
            lines.append(f"{f.severity.upper():8s} {f.rule:24s} "
                         f"{f.unit}: {f.message}")
        for fp in self.stale_suppressions:
            lines.append(f"STALE    baseline suppression matches "
                         f"nothing: {fp}")
        return lines


def run_audit(units: Sequence[AuditUnit], *,
              baseline: Optional[Baseline] = None,
              source_root: Optional[str] = None) -> AuditResult:
    """Program rules over ``units``, plus (when ``source_root`` is
    given) the AST lint over the port's source, ratcheted by the
    baseline."""
    from repro_torch.analysis.lint import lint_sources
    findings: List[Finding] = []
    for unit in units:
        findings.extend(run_rules(unit))
    if source_root:
        findings.extend(lint_sources(source_root))
    baseline = baseline or Baseline()
    active, suppressed, stale = apply_baseline(findings, baseline)
    order = {"error": 0, "warning": 1, "info": 2}
    active.sort(key=lambda f: (order[f.severity], f.fingerprint))
    return AuditResult(findings=active, suppressed=suppressed,
                       stale_suppressions=stale, units=list(units),
                       baseline_path=baseline.path)


def audit_plans(plans: Sequence, *, pools,
                baseline: Optional[Baseline] = None,
                device=None) -> Dict[str, dict]:
    """Audit each planner candidate's executed probe step; returns
    ``{plan.name: {"ok": bool, "errors": [messages], "counts": ...}}``.
    Where the reference caches one mesh per (dp, tp, pp), the port runs
    each step on ``pools``' world of the plan's size (``units.py:
    RankPools``, the caller's), so a frontier does not start a world per
    plan.  A candidate whose parameters do not split over its mesh is an
    audit error (``units.py: plan_splits``, before any rank starts); a
    step that fails on its ranks raises."""
    from repro_torch.analysis.units import plan_splits, plan_unit
    from repro_torch.parallel.axes import resolve_device
    resolve_device(device)     # no card: raise, never audit nothing
    out: Dict[str, dict] = {}
    for plan in plans:
        try:
            plan_splits(plan)
        except ValueError as e:     # the candidate's own failure to split
            out[plan.name] = {"ok": False,
                              "errors": [f"audit could not run "
                                         f"{plan.name}: {e}"]}
            continue
        unit = plan_unit(plan, pool=pools.get(plan.devices), device=device)
        res = run_audit([unit], baseline=baseline)
        out[plan.name] = {
            "ok": res.ok,
            "errors": [f.message for f in res.findings
                       if f.severity == "error"],
            "counts": res.counts,
        }
    return out
