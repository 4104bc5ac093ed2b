"""The energy-aware configuration planner: calibrate the analytic
energy model from the ledger (``calibration``), enumerate mesh x
strategy x ghost-width candidates (``space``), filter them for resource
feasibility (``constraints``), price them with the calibrated
E = ν·p·(A·α + B·β) (``score``), normalize them to a target loss with
pilot runs (``isoloss``) and report the Pareto frontier and the winning
plan (``report``).  CLI: ``python -m repro_torch.launch.plan``; the
training launcher's ``--plan`` applies the winner.  The elastic runtime
re-plans with them (``train/elastic.py: solve_plan``), the serving
router prices with the calibration.
"""
from repro_torch.planner.calibration import (Calibration,
                                             calibrate_from_ledger,
                                             calibrate_from_rows,
                                             least_squares_scale,
                                             load_calibration,
                                             paper_default_calibration)
from repro_torch.planner.constraints import (DEFAULT_HBM_BYTES, Constraints,
                                             Rejection, filter_feasible,
                                             hbm_bytes_estimate,
                                             hbm_readings,
                                             measured_hbm_bytes)
from repro_torch.planner.isoloss import (IsoLossResult, LossCurve,
                                         apply_iso_loss, fit_loss_curve,
                                         matched_loss_comparison,
                                         run_pilots)
from repro_torch.planner.report import (PLAN_SCHEMA, build_report,
                                        load_plan_report, pick_winner,
                                        plan_summary_lines, record_frontier,
                                        write_plan_report)
from repro_torch.planner.score import (ScoredPlan, apply_throughput_floor,
                                       pareto_frontier, score_plan,
                                       score_plans)
from repro_torch.planner.space import (PlanCandidate, enumerate_plans,
                                       mesh_shapes)

__all__ = [
    "Calibration", "calibrate_from_ledger", "calibrate_from_rows",
    "least_squares_scale", "load_calibration", "paper_default_calibration",
    "DEFAULT_HBM_BYTES", "Constraints", "Rejection", "filter_feasible",
    "hbm_bytes_estimate", "hbm_readings", "measured_hbm_bytes",
    "IsoLossResult", "LossCurve", "apply_iso_loss", "fit_loss_curve",
    "matched_loss_comparison", "run_pilots",
    "PLAN_SCHEMA", "build_report", "load_plan_report", "pick_winner",
    "plan_summary_lines", "record_frontier", "write_plan_report",
    "ScoredPlan", "apply_throughput_floor", "pareto_frontier",
    "score_plan", "score_plans",
    "PlanCandidate", "enumerate_plans", "mesh_shapes",
]
