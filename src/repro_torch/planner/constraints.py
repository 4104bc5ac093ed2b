"""Resource feasibility for candidate plans: the port's copy of the
reference's ``planner/constraints.py``.

``hbm_bytes_estimate`` is the analytic tier (parameters + AdamW moments
+ gradients + saved activations), cheap enough to filter the whole
enumeration.  ``DEFAULT_HBM_BYTES`` is the H100's 80 GB (the
reference's 16 GiB is a TPU v5e's).  The reference's second tier,
``compiled_hbm_bytes``, reads the memory analysis of a lowered XLA
program and has no counterpart here (ROADMAP.md, "nothing to port").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.planner.space import PlanCandidate

FLOAT_BYTES = 4.0
DEFAULT_HBM_BYTES = 80e9     # one H100 SXM's HBM3
# AdamW: params + m + v + grads, all fp32 in the FFN's decls
_OPT_STATE_COPIES = 4.0


@dataclass
class Constraints:
    max_devices: int
    hbm_bytes_per_device: float = DEFAULT_HBM_BYTES
    min_throughput_rows_s: float = 0.0     # global rows/second floor

    def as_dict(self) -> dict:
        return {"max_devices": self.max_devices,
                "hbm_bytes_per_device": self.hbm_bytes_per_device,
                "min_throughput_rows_s": self.min_throughput_rows_s}


def hbm_bytes_estimate(plan: PlanCandidate) -> float:
    """Analytic bytes a device holds for the training step:
    params/(tp·pp) · 4 copies (AdamW) + saved activations (one
    [rows_local, n/tp] tensor per stage-local layer plus the x/y batch,
    times the 1F1B in-flight bound for pipelined plans).  A slight
    over-estimate for flat plans, so the filter never passes a plan that
    would not fit."""
    from repro_torch.parallel.strategies import make_strategy
    from repro_torch.train.pipeline import PipelineSchedule
    st = make_strategy(plan.spec(), plan.width, plan.width, plan.tp)
    pp = max(plan.pp, 1)
    params_local = plan.depth * st.param_count() / plan.tp / pp
    state = params_local * _OPT_STATE_COPIES * FLOAT_BYTES
    rows_local = plan.batch / (plan.dp * plan.microbatches)
    feat_local = plan.width / plan.tp
    in_flight = 1
    if pp > 1:
        sched = PipelineSchedule(stages=pp, microbatches=plan.microbatches)
        in_flight = sched.max_in_flight(0)
    acts = (rows_local * feat_local * (plan.depth / pp + 2)
            * in_flight * FLOAT_BYTES)
    return state + acts


@dataclass
class Rejection:
    plan: PlanCandidate
    reason: str

    def as_dict(self) -> dict:
        return {"plan": self.plan.name, "reason": self.reason}


def filter_feasible(plans: List[PlanCandidate], constraints: Constraints
                    ) -> Tuple[List[PlanCandidate], List[Rejection]]:
    """Device-count and analytic-HBM filtering with recorded reasons
    (the throughput floor needs a priced step time:
    ``planner/score.py: apply_throughput_floor``)."""
    kept: List[PlanCandidate] = []
    rejected: List[Rejection] = []
    for plan in plans:
        if plan.devices > constraints.max_devices:
            rejected.append(Rejection(
                plan, f"devices {plan.devices} > "
                      f"{constraints.max_devices} available"))
            continue
        est = hbm_bytes_estimate(plan)
        if est > constraints.hbm_bytes_per_device:
            rejected.append(Rejection(
                plan, f"HBM estimate {est/2**30:.2f} GiB > "
                      f"{constraints.hbm_bytes_per_device/2**30:.2f} "
                      f"GiB budget"))
            continue
        kept.append(plan)
    return kept, rejected
