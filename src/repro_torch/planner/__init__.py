"""The energy-aware configuration planner: calibrate the analytic
energy model from the ledger (``calibration``), enumerate mesh x
strategy x ghost-width candidates (``space``), filter them for resource
feasibility (``constraints``) and price them with the calibrated
E = ν·p·(A·α + B·β) (``score``).  The elastic runtime re-plans with
them (``train/elastic.py: solve_plan``), the serving router prices with
the calibration.  The reference's iso-loss pilots, its plan report and
``launch/plan.py`` are ROADMAP.md queue 1, item 8 part 2.
"""
from repro_torch.planner.calibration import (Calibration,
                                             calibrate_from_ledger,
                                             calibrate_from_rows,
                                             least_squares_scale,
                                             load_calibration,
                                             paper_default_calibration)
from repro_torch.planner.constraints import (DEFAULT_HBM_BYTES, Constraints,
                                             Rejection, filter_feasible,
                                             hbm_bytes_estimate)
from repro_torch.planner.score import (ScoredPlan, apply_throughput_floor,
                                       pareto_frontier, score_plan,
                                       score_plans)
from repro_torch.planner.space import (PlanCandidate, enumerate_plans,
                                       mesh_shapes)

__all__ = [
    "Calibration", "calibrate_from_ledger", "calibrate_from_rows",
    "least_squares_scale", "load_calibration", "paper_default_calibration",
    "DEFAULT_HBM_BYTES", "Constraints", "Rejection", "filter_feasible",
    "hbm_bytes_estimate",
    "ScoredPlan", "apply_throughput_floor", "pareto_frontier",
    "score_plan", "score_plans",
    "PlanCandidate", "enumerate_plans", "mesh_shapes",
]
