"""Resource feasibility for candidate plans: the port's copy of the
reference's ``planner/constraints.py``.

``hbm_bytes_estimate`` is the analytic tier (parameters + AdamW moments
+ gradients + saved activations), cheap enough to filter the whole
enumeration.  ``DEFAULT_HBM_BYTES`` is the H100's 80 GB (the
reference's 16 GiB is a TPU v5e's).  The second tier,
``measured_hbm_bytes``, takes the place of the reference's
``compiled_hbm_bytes`` (the memory analysis of a lowered XLA program):
the peak card memory of one real train step of the plan on its ranks;
``hbm_readings`` breaks it down by rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

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


def _hbm_rank(axes, device, plan: PlanCandidate) -> dict:
    """A rank of ``hbm_readings``: one AdamW step of the plan's FFN from
    its initial draw.  Card bytes allocated through PyTorch's allocator,
    each counted from what the rank held on entry (a pool's rank may
    still hold an earlier job's tensors): ``library`` after one small
    matmul (cuBLAS's workspace, which the allocator holds), ``state``
    after the parameters' and optimizer state's draw, ``peak`` the
    step's largest, ``retained`` after it.  The batch (its values do not
    matter here) is drawn on the host."""
    import torch
    from repro_torch.core.ffn import (init_ffn, local_batch,
                                      make_ffn_train_step)
    from repro_torch.optim import AdamW
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)

    def held():
        torch.cuda.synchronize(device)
        return int(torch.cuda.memory_allocated(device)) - base
    a = torch.ones(64, 64, device=device)
    float((a @ a)[0, 0])
    del a
    out = {"library": held()}
    cfg = plan.model_config()
    opt = AdamW(3e-3, weight_decay=0.0)
    step_fn, _, _ = make_ffn_train_step(cfg, axes, opt, plan.batch)
    params, state = init_ffn(cfg, axes, opt, 0, device)
    out["state"] = held()
    x = torch.randn(plan.batch, plan.width,
                    generator=torch.Generator().manual_seed(0))
    x, y = (local_batch(t, axes).to(device) for t in (x, torch.relu(x)))
    params, state, loss = step_fn(params, state, 0, x, y)
    float(loss)
    out["retained"] = held()
    out["peak"] = int(torch.cuda.max_memory_allocated(device)) - base
    return out


def hbm_readings(plan: PlanCandidate, device=None,
                 pool=None) -> Optional[List[dict]]:
    """Each of ``plan``'s ``pp x dp x tp`` ranks' card bytes over one
    train step of its FFN (``_hbm_rank``'s readings), on new ranks, or
    on ``pool`` when it has that many, on ``device`` (the card unless the
    caller asks for the CPU).  None on the CPU, which has no card memory
    to measure."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.axes import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    pp = max(plan.pp, 1)
    if pool is not None and pool.world == plan.devices:
        return pool.run(_hbm_rank, plan.dp, plan.tp, (plan,), pp=pp)
    return spawn(_hbm_rank, plan.dp, plan.tp, dev, args=(plan,), pp=pp)


def measured_hbm_bytes(plan: PlanCandidate, device=None,
                       pool=None) -> Optional[float]:
    """The largest rank's peak card bytes over one train step of
    ``plan``'s FFN (``hbm_readings``).  None on the CPU: the reference's
    answer where XLA reports no memory analysis, and a None keeps the
    plan."""
    readings = hbm_readings(plan, device, pool)
    return (None if readings is None
            else float(max(r["peak"] for r in readings)))


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
