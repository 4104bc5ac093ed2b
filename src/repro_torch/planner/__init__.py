"""The planner's calibration: the constants the serving router prices
candidate configurations with (``calibration``).  The rest of the
reference's planner (the plan space, constraints, scoring, iso-loss
pilots and the report) is not ported (ROADMAP.md queue 1, item 8).
"""
from repro_torch.planner.calibration import (Calibration,
                                             calibrate_from_ledger,
                                             calibrate_from_rows,
                                             least_squares_scale,
                                             load_calibration,
                                             paper_default_calibration)

__all__ = [
    "Calibration", "calibrate_from_ledger", "calibrate_from_rows",
    "least_squares_scale", "load_calibration", "paper_default_calibration",
]
