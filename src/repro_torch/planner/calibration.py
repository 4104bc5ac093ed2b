"""Calibrating the analytic energy model from the measured ledger: the
port of the reference's ``planner/calibration.py``, host-only
arithmetic, the same fits and the same precedence.

The paper prices a configuration with E = ν·p·(A·α + B·β) (Eqns. 1–2)
where α/β are summed from the executing ``ProjectionStrategy`` objects
and β's collective times come from the Table III (c1, c2) fits.  The
measured-vs-predicted ledger records how far those analytic
accounts drift from what the compiler lowered and the machine executed —
this module closes the loop by FITTING per-strategy correction constants
from ``BENCH_ledger.jsonl`` so the planner scores candidate plans with a
model calibrated to *this* machine:

  * ``alpha_scale[kind]`` — measured/predicted flops, least-squares
    through the origin over that strategy's joined rows (the documented
    3×-GEMM undercount of the phantom backward lands here);
  * ``beta_scale[kind]``  — measured/predicted collective wire bytes
    (ring model both sides, so this pins near 1.0 unless a strategy
    issues unmodeled collectives);
  * ``nu_scale[kind]``    — iterations-to-target relative to the tensor
    baseline, from the Table I reproduction rows (``table1_*_iters``);
  * ``collective_fits``   — the (c1, c2) Eqn. 26 constants per
    collective, taken from the ``comm_model`` suite's measured fits.

Documented fallbacks (recorded in ``provenance``): with no ledger — or
no usable rows for a given constant — scales default to 1.0 and the
comm constants fall back to the paper's Table III Frontier fits
(``core.energy.PAPER_COLLECTIVE_FITS``), i.e. the uncalibrated paper
model.  ``lowrank_distill`` shares ``phantom``'s cost structure and
inherits its fitted scales when it has no rows of its own.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.energy import PAPER_COLLECTIVE_FITS

# ledger `impl` values -> strategy kind the constant calibrates
_IMPL_TO_KIND = {
    "tensor_col": "tensor_col",
    "tensor_row": "tensor_row",
    "dense": "tensor_col",
    "phantom": "phantom",
    "lowrank_distill": "lowrank_distill",
}

# strategy kinds that inherit another kind's fit when they have no rows
_KIND_FALLBACK = {"lowrank_distill": "phantom"}

PAPER_SOURCE = "paper defaults (Table III constants, scales = 1.0)"
LEDGER_SOURCE = "ledger-fit"


def least_squares_scale(pairs: Sequence[Tuple[float, float]]) -> float:
    """The s minimizing Σ (measured − s·predicted)² — the one-parameter
    least-squares fit of measured = s·predicted through the origin."""
    num = sum(m * p for p, m in pairs)
    den = sum(p * p for p, _ in pairs)
    return num / den if den else 1.0


@dataclass
class Calibration:
    """Fitted (or default) constants the planner prices plans with."""

    alpha_scale: Dict[str, float] = field(default_factory=dict)
    beta_scale: Dict[str, float] = field(default_factory=dict)
    nu_scale: Dict[str, float] = field(default_factory=dict)
    collective_fits: Dict[str, tuple] = field(
        default_factory=lambda: dict(PAPER_COLLECTIVE_FITS))
    provenance: Dict[str, dict] = field(default_factory=dict)
    source: str = PAPER_SOURCE

    def scales_for(self, kind: str) -> Tuple[float, float, float]:
        """(alpha_scale, beta_scale, nu_scale) for one strategy kind,
        resolving the documented lowrank→phantom inheritance."""
        base = _KIND_FALLBACK.get(kind)
        def get(table, default=1.0):
            if kind in table:
                return table[kind]
            if base is not None and base in table:
                return table[base]
            return default
        return (get(self.alpha_scale), get(self.beta_scale),
                get(self.nu_scale))

    def as_dict(self) -> dict:
        return {
            "alpha_scale": dict(self.alpha_scale),
            "beta_scale": dict(self.beta_scale),
            "nu_scale": dict(self.nu_scale),
            "collective_fits": {k: list(v)
                                for k, v in self.collective_fits.items()},
            "provenance": self.provenance,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        """Rehydrate a serialized calibration (the ``calibration`` block
        of ``PLAN_report.json``) — how the serving router reuses the
        constants a planning pass already fitted."""
        return cls(
            alpha_scale=dict(d.get("alpha_scale") or {}),
            beta_scale=dict(d.get("beta_scale") or {}),
            nu_scale=dict(d.get("nu_scale") or {}),
            collective_fits={k: tuple(v) for k, v in
                             (d.get("collective_fits") or
                              PAPER_COLLECTIVE_FITS).items()},
            provenance=dict(d.get("provenance") or {}),
            source=d.get("source", PAPER_SOURCE))


def paper_default_calibration() -> Calibration:
    """The documented no-ledger fallback: the paper model verbatim."""
    return Calibration(provenance={"all": {"source": PAPER_SOURCE}})


def _load_rows(jsonl_path: Optional[str] = None,
               report: Optional[dict] = None) -> List[dict]:
    if report is not None:
        return list(report.get("entries", []))
    if jsonl_path and os.path.exists(jsonl_path):
        rows = []
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return rows
    return []


def _fit_scales(rows: List[dict], key: str) -> Tuple[Dict[str, float],
                                                     Dict[str, dict]]:
    """Per-strategy least-squares scale over rows joining `key`."""
    by_kind: Dict[str, list] = {}
    used: Dict[str, list] = {}
    for r in rows:
        kind = _IMPL_TO_KIND.get(r.get("impl", ""))
        m = (r.get("measured") or {}).get(key)
        p = (r.get("predicted") or {}).get(key)
        if kind is None or not isinstance(m, (int, float)) \
                or not isinstance(p, (int, float)) or not p:
            continue
        by_kind.setdefault(kind, []).append((float(p), float(m)))
        used.setdefault(kind, []).append(r.get("name", "?"))
    scales, prov = {}, {}
    for kind, pairs in by_kind.items():
        scales[kind] = least_squares_scale(pairs)
        prov[kind] = {"source": LEDGER_SOURCE, "key": key,
                      "rows": used[kind], "n_rows": len(pairs),
                      "fitted": scales[kind]}
    return scales, prov


def _fit_nu(rows: List[dict]) -> Tuple[Dict[str, float], Dict[str, dict]]:
    """Iterations-to-fixed-loss relative to the tensor baseline, from
    rows carrying ``measured.iterations`` at a shared target loss (the
    Table I reproduction).  The phantom scale is the BEST (fewest-
    iteration) phantom row over the baseline — matching how Table I
    picks its k.  Only ``kind == "train"`` rows qualify: the planner's
    own pilot rows (``kind == "pilot"``) also carry iteration counts,
    and fitting those back in would double-apply ν on the very runs
    the iso-loss pass already prices directly."""
    rows = [r for r in rows if r.get("kind") == "train"]
    base = [r for r in rows
            if _IMPL_TO_KIND.get(r.get("impl", "")) == "tensor_col"
            and isinstance((r.get("measured") or {}).get("iterations"),
                           (int, float))]
    if not base:
        return {}, {}
    targets = {}
    for r in base:
        t = (r.get("extra") or {}).get("target_loss")
        targets.setdefault(t, r)
    scales: Dict[str, float] = {}
    prov: Dict[str, dict] = {}
    for r in rows:
        kind = _IMPL_TO_KIND.get(r.get("impl", ""))
        if kind in (None, "tensor_col"):
            continue
        it = (r.get("measured") or {}).get("iterations")
        t = (r.get("extra") or {}).get("target_loss")
        if not isinstance(it, (int, float)) or t not in targets:
            continue
        base_it = targets[t]["measured"]["iterations"]
        ratio = float(it) / max(float(base_it), 1.0)
        if kind not in scales or ratio < scales[kind]:
            scales[kind] = ratio
            prov[kind] = {"source": LEDGER_SOURCE, "key": "iterations",
                          "rows": [targets[t].get("name", "?"),
                                   r.get("name", "?")],
                          "baseline_iterations": base_it,
                          "iterations": it, "fitted": ratio}
    return scales, prov


def _fit_collectives(rows: List[dict]) -> Tuple[Dict[str, tuple],
                                                Dict[str, dict]]:
    """(c1, c2) per collective from the comm_model suite's measured
    fits (kind == "collective", impl = collective name)."""
    fits, prov = {}, {}
    for r in rows:
        if r.get("kind") != "collective":
            continue
        name = r.get("impl", "")
        m = r.get("measured") or {}
        c1, c2 = m.get("c1_us"), m.get("c2_us_per_float")
        if name in PAPER_COLLECTIVE_FITS and \
                isinstance(c1, (int, float)) and isinstance(c2, (int, float)):
            fits[name] = (float(c1), float(c2))
            prov[name] = {"source": LEDGER_SOURCE,
                          "rows": [r.get("name", "?")],
                          "c1_us": c1, "c2_us_per_float": c2}
    return fits, prov


def calibrate_from_rows(rows: List[dict]) -> Calibration:
    """Fit every constant the rows support; paper defaults elsewhere."""
    if not rows:
        return paper_default_calibration()
    alpha, prov_a = _fit_scales(rows, "flops_per_device")
    beta, prov_b = _fit_scales(rows, "collective_wire_bytes_per_device")
    nu, prov_n = _fit_nu(rows)
    coll, prov_c = _fit_collectives(rows)
    prov: Dict[str, dict] = {}
    prov.update({f"alpha_scale.{k}": v for k, v in prov_a.items()})
    prov.update({f"beta_scale.{k}": v for k, v in prov_b.items()})
    prov.update({f"nu_scale.{k}": v for k, v in prov_n.items()})
    prov.update({f"collective_fits.{k}": v for k, v in prov_c.items()})
    fits = dict(PAPER_COLLECTIVE_FITS)
    for k in fits:
        if k not in coll:
            prov[f"collective_fits.{k}"] = {"source": PAPER_SOURCE}
    fits.update(coll)
    fitted_any = bool(alpha or beta or nu or coll)
    return Calibration(
        alpha_scale=alpha, beta_scale=beta, nu_scale=nu,
        collective_fits=fits, provenance=prov,
        source=(LEDGER_SOURCE if fitted_any else PAPER_SOURCE))


def calibrate_from_ledger(jsonl_path: Optional[str] = None,
                          report: Optional[dict] = None) -> Calibration:
    """The planner's calibration entry point.

    Reads joined rows from a ``BENCH_ledger.jsonl`` stream (or an
    already-loaded ``BENCH_report.json`` dict) and fits what it can;
    with neither, returns the documented paper-defaults calibration."""
    rows = _load_rows(jsonl_path, report)
    return calibrate_from_rows(rows)


def load_calibration(plan_report_path: Optional[str] = None,
                     ledger_path: Optional[str] = None) -> Calibration:
    """The SERVING-side calibration entry point (docs/serving.md).

    Preference order: the constants a planning pass already fitted and
    serialized into ``PLAN_report.json`` > a fresh fit from
    ``BENCH_ledger.jsonl`` > the documented paper defaults.  Missing or
    unreadable files fall through rather than raise — serving must come
    up on a blank checkout."""
    if plan_report_path and os.path.exists(plan_report_path):
        try:
            with open(plan_report_path) as f:
                rec = json.load(f)
            block = rec.get("calibration")
            if block:
                return Calibration.from_dict(block)
        except (OSError, ValueError):
            pass
    if ledger_path and os.path.exists(ledger_path):
        return calibrate_from_ledger(jsonl_path=ledger_path)
    return paper_default_calibration()
