"""Findings, severities, and the checked-in suppression baseline: the
port's own copy of the JAX package's ``analysis/findings.py``.

A ``Finding`` is one rule violation at one location (an executed entry
point for program rules, a source file for AST rules).  Its
``fingerprint`` (``rule:unit:key``, with no volatile numbers) is the
unit of suppression: the baseline file (the port's
``analysis/AUDIT_baseline.json``) lists fingerprints with reasons, and
``apply_baseline`` splits an audit's findings into active and
suppressed.  New violations therefore fail the audit even when old
accepted ones exist: a ratchet.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)

AUDIT_BASELINE_SCHEMA = "audit-baseline/v1"


@dataclass
class Finding:
    """One rule violation.

    ``key`` must be stable across runs (collective kind, symbol name,
    relative path, never byte counts or wall times); everything
    volatile belongs in ``detail``.
    """

    rule: str                   # rule id, e.g. "collective-accounting"
    severity: str               # error | warning | info
    unit: str                   # entrypoint name or repo-relative path
    message: str                # human-readable, one line
    key: str = ""               # stable suppression key within the unit
    detail: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"want one of {SEVERITIES}")

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.unit}:{self.key}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "unit": self.unit,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "detail": dict(self.detail),
        }


@dataclass
class Baseline:
    """The checked-in suppression list."""

    suppressions: Dict[str, str] = field(default_factory=dict)
    path: Optional[str] = None

    def reason(self, fingerprint: str) -> Optional[str]:
        return self.suppressions.get(fingerprint)

    def as_dict(self) -> Dict[str, object]:
        return {
            "schema": AUDIT_BASELINE_SCHEMA,
            "suppressions": [
                {"fingerprint": fp, "reason": why}
                for fp, why in sorted(self.suppressions.items())
            ],
        }


def load_baseline(path: Optional[str]) -> Baseline:
    """Load a baseline file; a missing file is an empty baseline
    (nothing suppressed), not an error."""
    if path is None:
        return Baseline()
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return Baseline(path=path)
    if rec.get("schema") != AUDIT_BASELINE_SCHEMA:
        raise ValueError(f"{path}: unknown baseline schema "
                         f"{rec.get('schema')!r} "
                         f"(want {AUDIT_BASELINE_SCHEMA})")
    sup: Dict[str, str] = {}
    for entry in rec.get("suppressions", []):
        sup[str(entry["fingerprint"])] = str(entry.get("reason", ""))
    return Baseline(suppressions=sup, path=path)


def write_baseline(findings: Sequence[Finding], path: str,
                   reason: str = "accepted pre-existing finding") -> Baseline:
    """Snapshot the given findings as the new baseline (the deliberate
    ratchet reset: ``audit --update-baseline``)."""
    base = Baseline(
        suppressions={f.fingerprint: reason for f in findings}, path=path)
    with open(path, "w") as f:
        json.dump(base.as_dict(), f, indent=1)
        f.write("\n")
    return base


def apply_baseline(findings: Sequence[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (active, suppressed); the third element lists
    baseline fingerprints that matched nothing: stale suppressions the
    report surfaces, so the baseline shrinks as rules are fixed."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    seen = set()
    for f in findings:
        seen.add(f.fingerprint)
        if baseline.reason(f.fingerprint) is not None:
            suppressed.append(f)
        else:
            active.append(f)
    stale = [fp for fp in sorted(baseline.suppressions) if fp not in seen]
    return active, suppressed, stale


def severity_counts(findings: Sequence[Finding]) -> Dict[str, int]:
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] += 1
    return counts
