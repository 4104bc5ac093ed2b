"""Scoring candidate plans with the calibrated energy model, and the
Pareto frontier over (predicted energy, step time, memory): the port's
copy of the reference's ``planner/score.py``, the same formulas.

The objective is the paper's E = ν·p·(A·α + B·β), with the calibration's
hooks (``planner/calibration.py``): α scaled by the strategy's fitted
``alpha_scale``, β by ``beta_scale`` and priced with the calibrated
(c1, c2) Eqn. 26 constants, ν = iterations · ``nu_scale[kind]``.  The
compute term's ``peak_flops`` defaults to the H100's float32 peak on
its CUDA cores (``core/energy.py: H100_PEAK_FLOPS_FP32``), where the
reference prices a TPU's.

Microbatching repeats each layer collective once per microbatch at 1/mb
the message size; pipelined plans (pp > 1) price the ideal 1F1B
deployment: each device computes its own L/pp layers, pays the stage
boundary hops (``PipelineSchedule.p2p_events``) and idles through the
bubble at static power B.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.energy import (FRONTIER_A_W, FRONTIER_B_W,
                                     H100_PEAK_FLOPS_FP32)
from repro_torch.planner.calibration import Calibration
from repro_torch.planner.space import PlanCandidate


@dataclass
class ScoredPlan:
    plan: PlanCandidate
    alpha_s: float                 # calibrated compute seconds / iter
    beta_s: float                  # calibrated comm seconds / iter
    step_time_s: float
    energy_j_per_iter: float
    iterations: float              # ν to the target loss
    energy_j_total: float
    throughput_rows_s: float
    param_count: int               # model size (the capacity proxy)
    hbm_bytes_per_device: float = 0.0   # analytic estimate
    predicted_loss: Optional[float] = None
    quality: Optional[float] = None   # lower is better (loss proxy)
    notes: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = {"plan": self.plan.as_dict(),
             "alpha_s": self.alpha_s, "beta_s": self.beta_s,
             "step_time_s": self.step_time_s,
             "energy_j_per_iter": self.energy_j_per_iter,
             "iterations": self.iterations,
             "energy_j_total": self.energy_j_total,
             "throughput_rows_s": self.throughput_rows_s,
             "param_count": self.param_count,
             "hbm_bytes_per_device": self.hbm_bytes_per_device}
        if self.predicted_loss is not None:
            d["predicted_loss"] = self.predicted_loss
        if self.quality is not None:
            d["quality"] = self.quality
        if self.notes:
            d["notes"] = self.notes
        return d


def score_plan(plan: PlanCandidate, calib: Calibration, *,
               iterations: float = 1.0,
               peak_flops: float = H100_PEAK_FLOPS_FP32,
               A: float = FRONTIER_A_W, B: float = FRONTIER_B_W,
               training: bool = True,
               apply_nu_scale: bool = True) -> ScoredPlan:
    """Price one candidate with the calibrated model.
    ``apply_nu_scale=False`` when ``iterations`` is already a MEASURED
    iterations-to-target: the fitted ν scale corrects predicted counts
    only."""
    from repro_torch.core.energy import (comm_time_us,
                                         costs_from_strategies,
                                         pipeline_p2p_time_us)
    from repro_torch.parallel.strategies import make_strategy
    from repro_torch.planner.constraints import hbm_bytes_estimate
    from repro_torch.train.pipeline import PipelineSchedule

    st = make_strategy(plan.spec(), plan.width, plan.width, plan.tp,
                       dp=plan.dp)
    s_a, s_b, s_nu = calib.scales_for(plan.strategy)
    mb = plan.microbatches
    pp = max(plan.pp, 1)
    rows_per_pass = plan.batch / (plan.dp * mb)
    alpha, beta = costs_from_strategies(
        [st], plan.tp, plan.depth, rows_per_pass, peak_flops,
        fits=calib.collective_fits, training=training)
    # each pipeline stage computes only its own depth/pp layers
    alpha = alpha * mb * s_a / pp
    beta = beta * mb * s_b / pp
    if pp > 1:
        # the carried feature shard crosses each boundary once per
        # microbatch per direction
        sched = PipelineSchedule(stages=pp, microbatches=mb)
        m_boundary = rows_per_pass * plan.width / plan.tp
        beta += pipeline_p2p_time_us(
            sched, m_boundary, calib.collective_fits) * 1e-6 * s_b
    if training and plan.dp > 1:
        # the dp all-reduce of each layer's local parameter gradients,
        # once a step (not per microbatch)
        m_grads = st.param_count() / plan.tp
        us = comm_time_us("all_reduce", m_grads, plan.dp,
                          calib.collective_fits)
        beta += us * (plan.depth / pp) * 1e-6 * s_b
    work_s = alpha + beta
    # 1F1B warmup/drain: the timeline stretches by (mb+pp-1)/mb, the
    # devices idling through the stretch at static power B
    bubble_s = work_s * (pp - 1) / mb if pp > 1 else 0.0
    step_s = work_s + bubble_s
    e_iter = plan.devices * (A * alpha + B * (beta + bubble_s))
    nu = iterations * (s_nu if apply_nu_scale else 1.0)
    notes = {"alpha_scale": s_a, "beta_scale": s_b, "nu_scale": s_nu,
             "A_w": A, "B_w": B, "peak_flops": peak_flops}
    if pp > 1:
        notes["pp"] = pp
        notes["bubble_s"] = bubble_s
        notes["bubble_fraction"] = (pp - 1) / (mb + pp - 1)
    return ScoredPlan(
        plan=plan, alpha_s=alpha, beta_s=beta, step_time_s=step_s,
        energy_j_per_iter=e_iter, iterations=nu,
        energy_j_total=nu * e_iter,
        throughput_rows_s=(plan.batch / step_s) if step_s else 0.0,
        param_count=plan.depth * st.param_count(),
        hbm_bytes_per_device=hbm_bytes_estimate(plan),
        notes=notes)


def score_plans(plans: Sequence[PlanCandidate], calib: Calibration,
                **kw) -> List[ScoredPlan]:
    return [score_plan(p, calib, **kw) for p in plans]


def apply_throughput_floor(scored: Sequence[ScoredPlan],
                           min_rows_s: float):
    """Split scored plans on the throughput constraint."""
    if min_rows_s <= 0:
        return list(scored), []
    kept, rejected = [], []
    for s in scored:
        if s.throughput_rows_s >= min_rows_s:
            kept.append(s)
        else:
            rejected.append((s, f"throughput {s.throughput_rows_s:.1f} "
                                f"rows/s < {min_rows_s:.1f} floor"))
    return kept, rejected


def pareto_frontier(scored: Sequence[ScoredPlan],
                    keys: Sequence[str] = ("energy_j_total",
                                           "step_time_s",
                                           "hbm_bytes_per_device")
                    ) -> List[ScoredPlan]:
    """The non-dominated set, minimising every key, sorted by the first;
    exact duplicates in objective space keep their first.  Restricting
    ``keys`` to (energy, step time) gives the classic 2-D curve."""
    def vec(s: ScoredPlan):
        return tuple(getattr(s, k) for k in keys)

    def dominates(a, b):
        return all(x <= y for x, y in zip(a, b)) and a != b

    front = []
    for s in scored:
        v = vec(s)
        if any(dominates(vec(o), v) for o in scored if o is not s):
            continue
        front.append(s)
    seen: Dict[tuple, bool] = {}
    uniq = []
    for s in sorted(front, key=vec):
        if vec(s) in seen:
            continue
        seen[vec(s)] = True
        uniq.append(s)
    return uniq
