"""The sharding and energy audit of the PyTorch port: the port of the
JAX package's ``analysis``.

A rule engine that shows, for each entry point, that every collective
one executed step issues (``parallel/axes.py: record_collectives``) is
priced by a predicted ``CommEvent`` from the executing
``ProjectionStrategy`` / pipeline / serving account, and the reverse;
plus sharding-hygiene, dtype-drift, recompilation-hazard and
kernel-smem program rules and the repo-idiom (AST) source rules.  The
reference lowers each entry point to HLO without running it; PyTorch
compiles nothing, so the port runs one step and counts what it does
(``units.py``).

Entry point: ``python -m repro_torch.launch.audit --all`` ->
``build/AUDIT_report.json`` (schema ``audit-report/v1``).
"""
from repro_torch.analysis.findings import (AUDIT_BASELINE_SCHEMA, ERROR,
                                           INFO, WARNING, Baseline,
                                           Finding, apply_baseline,
                                           load_baseline)
from repro_torch.analysis.engine import (AUDIT_SCHEMA, AuditResult,
                                         audit_plans, run_audit)
from repro_torch.analysis.rules import (PROGRAM_RULES, rule_catalog,
                                        run_rules)
from repro_torch.analysis.units import (AuditUnit, PricedCollective,
                                        build_default_units,
                                        ffn_train_unit, kernel_unit,
                                        pipeline_unit, plan_unit,
                                        serve_units)

__all__ = [
    "AUDIT_BASELINE_SCHEMA", "AUDIT_SCHEMA", "ERROR", "INFO", "WARNING",
    "AuditResult", "AuditUnit", "Baseline", "Finding", "PROGRAM_RULES",
    "PricedCollective", "apply_baseline", "audit_plans",
    "build_default_units", "ffn_train_unit", "kernel_unit",
    "load_baseline", "pipeline_unit", "plan_unit", "rule_catalog",
    "run_audit", "run_rules", "serve_units",
]
