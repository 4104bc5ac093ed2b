"""The iso-loss frontier: pilot runs -> loss-vs-phantom-width curves ->
the paper-style matched-loss comparison; the port's copy of the
reference's ``planner/isoloss.py``, the same arithmetic.

The paper's final claim is that a *smaller phantom model on fewer GPUs*
reaches the same loss as a larger tensor-parallel model on more GPUs.
That is a statement about measured objects, all produced here:

  1. **Pilots**: small real training runs (``train/trainer.py:
     pilot_ffn_run`` on ``data/synthetic.py: TeacherDataset``), all at
     the SAME model width n (same teacher, same task): one for each
     tensor-family strategy, one per ghost width k for the phantom
     family, each a job of a ``RankPool`` of ``pilot_tp`` ranks.  Each
     runs a fixed step budget and records the first step the target
     loss was crossed (the measured ν) plus the final loss.
  2. **Loss curves**: a power law ``loss(k) = exp(a)·k^b`` fitted per
     phantom-family strategy over the ghost-width grid (log-log least
     squares).
  3. **The comparison**: candidate plans priced with the calibrated
     model at their pilot-measured ν; plans whose pilot (or curve)
     reached the target carry ``predicted_loss == target``, the
     matched-loss pool, and the verdict checks whether some phantom plan
     on a strictly smaller mesh undercuts every full-mesh tensor plan's
     energy.

The pilots run the plain torch core (a ``PlanCandidate``'s
``kernel_backend`` is ``"xla"``), on the card as on the CPU.  Documented
approximations, the reference's: pilots run at one mesh (``pilot_tp``)
while plans span many, so ν is strategy-intrinsic under this
approximation (exact for TP, whose model class is p-independent; the
phantom class is not, and the report flags ν as pilot-mesh-measured).  A
plan whose k was never piloted gets its loss from the fitted curve and
the ν of the nearest piloted k, flagged ``nu_interpolated_from_k``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import PHANTOM_KINDS
from repro_torch.planner.calibration import Calibration
from repro_torch.planner.score import ScoredPlan, score_plan
from repro_torch.planner.space import PlanCandidate

PILOT_TIMEOUT_S = 3600.0     # one pilot's job on the pool


def _key(strategy: str, k: int) -> str:
    return f"{strategy}:k{k}"


@dataclass
class LossCurve:
    """Power-law fit loss(k) = exp(a) · k^b over a ghost-width grid."""
    strategy: str
    a: float
    b: float
    ks: List[int]
    losses: List[float]
    width: int
    pilot_tp: int

    def loss_at(self, k: float) -> float:
        return math.exp(self.a) * max(k, 1e-9) ** self.b

    def k_for(self, target_loss: float,
              max_extrapolation: float = 4.0) -> Optional[int]:
        """Smallest ghost width predicted to reach ``target_loss``;
        None when the curve is non-increasing in capacity (b >= 0 means
        more ghosts do not help on this grid) or the answer would
        extrapolate more than ``max_extrapolation``× past the grid."""
        if self.b >= 0 or target_loss <= 0:
            return None
        k = (target_loss / math.exp(self.a)) ** (1.0 / self.b)
        if not (min(self.ks) / max_extrapolation
                <= k <= max(self.ks) * max_extrapolation):
            return None
        return max(1, int(math.ceil(k)))

    def as_dict(self) -> dict:
        return {"strategy": self.strategy, "a": self.a, "b": self.b,
                "ks": self.ks, "losses": self.losses,
                "width": self.width, "pilot_tp": self.pilot_tp,
                "model": "loss(k) = exp(a) * k^b"}


def fit_loss_curve(strategy: str, ks: Sequence[int],
                   losses: Sequence[float], width: int,
                   pilot_tp: int) -> LossCurve:
    """Log-log least squares (closed form; the grids are tiny)."""
    xs = [math.log(k) for k in ks]
    ys = [math.log(max(l, 1e-12)) for l in losses]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
         if den else 0.0)
    a = my - b * mx
    return LossCurve(strategy=strategy, a=a, b=b, ks=list(ks),
                     losses=list(losses), width=width, pilot_tp=pilot_tp)


@dataclass
class IsoLossResult:
    """Everything the planner learned from the pilot phase."""
    target_loss: float
    width: int
    pilot_tp: int
    steps_budget: int
    curves: Dict[str, LossCurve] = field(default_factory=dict)
    pilots: List = field(default_factory=list)         # PilotResult
    nu: Dict[str, Optional[int]] = field(default_factory=dict)
    final_loss: Dict[str, float] = field(default_factory=dict)

    def lookup(self, strategy: str, k: int
               ) -> Tuple[Optional[int], Optional[float], bool]:
        """(nu, final_loss, piloted) for one (strategy, ghost width)."""
        key = _key(strategy, k)
        if key in self.nu:
            return self.nu[key], self.final_loss.get(key), True
        return None, None, False

    def as_dict(self) -> dict:
        return {
            "target_loss": self.target_loss, "width": self.width,
            "pilot_tp": self.pilot_tp, "steps_budget": self.steps_budget,
            "curves": {k: c.as_dict() for k, c in self.curves.items()},
            "pilots": [p.as_dict() for p in self.pilots],
            "nu": dict(self.nu),
            "final_loss": dict(self.final_loss),
        }


def _pilot_rank(axes, device, cfg, kw):
    """A ``RankPool`` job: one rank's ``pilot_ffn_run``."""
    from repro_torch.train.trainer import pilot_ffn_run
    return pilot_ffn_run(cfg, axes, device, **kw)


def run_pilots(strategies: Sequence[str], pilot_tp: int, *, width: int,
               depth: int, batch: int, steps: int, target_loss: float,
               ks: Sequence[int] = (4, 8, 16), seed: int = 0,
               ledger=None, device=None, pool=None) -> IsoLossResult:
    """The pilot phase: same width (same teacher/task) for every run;
    tensor-family strategies get one run, phantom-family one per k.
    Each pilot is one job of a ``RankPool`` of ``pilot_tp`` ranks on
    ``device`` (the card unless the caller asks for the CPU): ``pool``
    when the caller holds one of that size, else one started here for
    the whole phase.  Each pilot's ledger row (suite ``planner``, kind
    ``pilot``, rank 0's meter) is recorded here, in the parent."""
    from repro_torch.launch.mesh import RankPool
    from repro_torch.telemetry import LedgerEntry

    if pool is None:
        with RankPool(1, pilot_tp, device,
                      timeout_s=PILOT_TIMEOUT_S) as pool:
            return run_pilots(strategies, pilot_tp, width=width,
                              depth=depth, batch=batch, steps=steps,
                              target_loss=target_loss, ks=ks, seed=seed,
                              ledger=ledger, device=device, pool=pool)
    res = IsoLossResult(target_loss=target_loss, width=width,
                        pilot_tp=pilot_tp, steps_budget=steps)
    for strat in strategies:
        phantom = strat in PHANTOM_KINDS
        k_grid = [k for k in ks if k < width // pilot_tp] if phantom \
            else [0]
        grid_losses = []
        for k in k_grid:
            plan = PlanCandidate(dp=1, tp=pilot_tp, strategy=strat,
                                 width=width, depth=depth, batch=batch,
                                 k=k)
            cfg = plan.model_config()
            pilot, summary = pool.run(
                _pilot_rank, 1, pilot_tp,
                (cfg, dict(steps=steps, batch=batch,
                           target_loss=target_loss, seed=seed)),
                timeout_s=PILOT_TIMEOUT_S)[0]
            if ledger is not None:
                ledger.record(LedgerEntry(
                    name=pilot.name, suite="planner", kind="pilot",
                    arch=cfg.name, impl=pilot.strategy, p=pilot_tp,
                    measured=dict(summary, final_loss=pilot.final_loss,
                                  iterations=pilot.iters_to_target
                                  or pilot.steps_run),
                    extra={"width": pilot.width, "k": pilot.k,
                           "target_loss": target_loss,
                           "censored": pilot.iters_to_target is None}))
            res.pilots.append(pilot)
            res.nu[_key(strat, k)] = pilot.iters_to_target
            res.final_loss[_key(strat, k)] = pilot.final_loss
            grid_losses.append(max(pilot.final_loss, 1e-12))
        if phantom and len(k_grid) >= 2:
            res.curves[strat] = fit_loss_curve(strat, k_grid,
                                               grid_losses, width,
                                               pilot_tp)
    return res


def apply_iso_loss(plans: Sequence[PlanCandidate], iso: IsoLossResult,
                   calib: Calibration, **score_kw) -> List[ScoredPlan]:
    """Score each plan at its pilot-measured ν.  Plans whose pilot (or
    fitted curve) reached the target carry predicted_loss == target —
    the matched-loss pool ``matched_loss_comparison`` quantifies over;
    censored plans keep their observed final loss and are flagged."""
    scored = []
    for plan in plans:
        k = plan.k if plan.strategy in PHANTOM_KINDS else 0
        nu, final_loss, piloted = iso.lookup(plan.strategy, k)
        notes = {"iso_loss": True, "pilot_width": iso.width,
                 "pilot_tp": iso.pilot_tp}
        if piloted:
            reached = nu is not None
            loss = iso.target_loss if reached else final_loss
            nu_val = float(nu) if reached else float(iso.steps_budget)
        else:
            curve = iso.curves.get(plan.strategy)
            if curve is None:
                continue            # nothing measured for this strategy
            # nearest piloted k's ν, flagged; a censored neighbour
            # (never reached the target) cannot vouch for this k either
            near = min(curve.ks, key=lambda kk: abs(kk - k))
            nu_near, _, _ = iso.lookup(plan.strategy, near)
            curve_loss = curve.loss_at(k)
            if nu_near is None:
                reached = False
                nu_val = float(iso.steps_budget)
            else:
                reached = curve_loss <= iso.target_loss
                nu_val = float(nu_near)
            loss = iso.target_loss if reached else curve_loss
            notes["nu_interpolated_from_k"] = near
        if plan.width != iso.width:
            notes["width_mismatch_vs_pilot"] = plan.width
        notes["reached_target"] = bool(reached)
        notes["nu_censored"] = piloted and nu is None
        # ν is a measurement here — the calibration's nu_scale corrects
        # predicted iteration counts and must not double-apply
        s = score_plan(plan, calib, iterations=nu_val,
                       apply_nu_scale=False, **score_kw)
        s.predicted_loss = loss
        s.quality = loss
        s.notes.update(notes)
        scored.append(s)
    return scored


def matched_loss_comparison(scored: Sequence[ScoredPlan],
                            full_devices: int) -> dict:
    """The acceptance verdict: does some phantom plan on a strictly
    smaller mesh predict lower calibrated energy than EVERY
    tensor-parallel plan on the full mesh, at matched predicted loss?

    Quantifies over the matched pool — plans whose predicted loss IS
    the target (``notes.reached_target``, or every plan when scoring
    ran without pilots and all plans share the calibrated-ν target)."""
    matched = [s for s in scored
               if s.notes.get("reached_target", True)]
    tp_full = [s for s in matched
               if s.plan.strategy not in PHANTOM_KINDS
               and s.plan.devices == full_devices]
    ph_small = [s for s in matched
                if s.plan.strategy in PHANTOM_KINDS
                and s.plan.devices < full_devices]
    out = {"full_devices": full_devices,
           "matched_plans": len(matched),
           "tensor_full_mesh_plans": len(tp_full),
           "phantom_smaller_mesh_plans": len(ph_small),
           "phantom_dominates": False}
    if not tp_full or not ph_small:
        return out
    best_tp = min(tp_full, key=lambda s: s.energy_j_total)
    best_ph = min(ph_small, key=lambda s: s.energy_j_total)
    worst_tp = max(tp_full, key=lambda s: s.energy_j_total)
    out.update({
        "best_tensor_full": {"plan": best_tp.plan.name,
                             "energy_j": best_tp.energy_j_total,
                             "step_time_s": best_tp.step_time_s,
                             "iterations": best_tp.iterations,
                             "param_count": best_tp.param_count,
                             "devices": best_tp.plan.devices},
        "worst_tensor_full": {"plan": worst_tp.plan.name,
                              "energy_j": worst_tp.energy_j_total},
        "best_phantom_smaller": {"plan": best_ph.plan.name,
                                 "energy_j": best_ph.energy_j_total,
                                 "step_time_s": best_ph.step_time_s,
                                 "iterations": best_ph.iterations,
                                 "param_count": best_ph.param_count,
                                 "devices": best_ph.plan.devices},
        "energy_saving_vs_best_tensor":
            1.0 - best_ph.energy_j_total / best_tp.energy_j_total
            if best_tp.energy_j_total else 0.0,
        "model_size_ratio":
            best_ph.param_count / best_tp.param_count
            if best_tp.param_count else None,
        "phantom_dominates":
            best_ph.energy_j_total < best_tp.energy_j_total,
    })
    return out
