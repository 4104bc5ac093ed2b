"""The port's iso-loss arithmetic and plan report
(``planner/{isoloss,report}.py``) against the reference's, host only, on
the same inputs: the loss-curve fit and its inversion on the same grids
(the reference test's exact power law and flat curve among them);
``apply_iso_loss`` and ``matched_loss_comparison`` over the same plans,
the same calibration and identical pilot results built in both packages
(piloted, censored and curve-interpolated plans), every scored field and
the comparison held to 1e-9 at the reference's TPU peak, passed
explicitly; ``build_report`` (but its time stamp), ``pick_winner``,
``plan_summary_lines`` and ``record_frontier``; the report's schema check
and each package loading the other's report; ``RunConfig``, ``SHAPES``
and ``applicable_shapes`` for every arch."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.core.energy import TPU_PEAK_FLOPS
from repro.planner import calibration as jcal
from repro.planner import constraints as jcons
from repro.planner import isoloss as jiso
from repro.planner import report as jreport
from repro.planner import space as jspace
from repro.planner.score import pareto_frontier as jpareto
from repro.telemetry import Ledger as JLedger
from repro.train.trainer import PilotResult as JPilotResult
from repro_torch.configs import base
from repro_torch.planner import isoloss
from repro_torch.planner import (PLAN_SCHEMA, Calibration, Constraints,
                                 apply_iso_loss, build_report,
                                 enumerate_plans,
                                 filter_feasible, fit_loss_curve,
                                 load_plan_report, matched_loss_comparison,
                                 pareto_frontier, paper_default_calibration,
                                 pick_winner, plan_summary_lines,
                                 record_frontier, write_plan_report)
from repro_torch.planner.report import DEFAULT_REPORT
from repro_torch.telemetry import Ledger
from repro_torch.train.trainer import PilotResult

TOL = 1e-9
WIDTH, PILOT_TP, BUDGET, TARGET = 512, 4, 80, 0.25
_CAL = dict(alpha_scale={"phantom": 1.17, "tensor_col": 1.02},
            beta_scale={"phantom": 0.93}, nu_scale={"phantom": 1.1},
            collective_fits={"all_gather": (2.0, 0.003),
                             "reduce_scatter": (1.5, 0.004),
                             "all_reduce": (3.0, 0.002),
                             "collective_permute": (1.0, 0.001)})
CALIBRATIONS = {"paper": None, "fitted": _CAL}
# (strategy, k): (iters_to_target, final_loss); None = censored
PILOTS = {
    # every k piloted, all reached
    "reached": {("tensor_col", 0): (12, 0.21), ("phantom", 4): (30, 0.24),
                ("phantom", 8): (25, 0.23), ("phantom", 16): (22, 0.22)},
    # k 8 censored, k 16 never piloted (its curve's neighbour k 8 is the
    # censored one: it cannot vouch for k 16)
    "censored": {("tensor_col", 0): (12, 0.21),
                 ("phantom", 4): (30, 0.245),
                 ("phantom", 8): (None, 0.27)},
    # k 8 never piloted: loss from the fitted curve, ν from k 4 or 16
    "interpolated": {("tensor_col", 0): (None, 0.3),
                     ("phantom", 4): (40, 0.26), ("phantom", 16): (35, 0.2)},
    # no phantom pilot reached, tensor did
    "tensor_only": {("tensor_col", 0): (20, 0.2),
                    ("phantom", 4): (None, 0.4), ("phantom", 8): (None, 0.35)},
}


def _close(got, want, path="", rel=TOL):
    """Recursive equality, floats to ``rel`` relative (and ``rel``
    absolute near 0)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}", rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", rel)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=rel, abs=rel), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _calibs(name):
    kw = CALIBRATIONS[name]
    if kw is None:
        return paper_default_calibration(), jcal.paper_default_calibration()
    return Calibration(**kw), jcal.Calibration(**kw)


def _pilot(cls, strat, k, nu, final):
    return cls(name=f"pilot_{strat}_k{k}", strategy=strat, width=WIDTH,
               tp=PILOT_TP, k=k, steps_run=BUDGET, final_loss=final,
               losses=[1.0, final], target_loss=TARGET, iters_to_target=nu,
               wall_us_median=123.0)


def _iso(mod, fit, pilot_cls, case):
    """The same ``IsoLossResult`` in one package: pilots, ν, final losses
    and the phantom curve fitted as ``run_pilots`` fits it."""
    res = mod.IsoLossResult(target_loss=TARGET, width=WIDTH,
                            pilot_tp=PILOT_TP, steps_budget=BUDGET)
    ks, losses = [], []
    for (strat, k), (nu, final) in PILOTS[case].items():
        res.pilots.append(_pilot(pilot_cls, strat, k, nu, final))
        res.nu[f"{strat}:k{k}"] = nu
        res.final_loss[f"{strat}:k{k}"] = final
        if strat == "phantom":
            ks.append(k)
            losses.append(max(final, 1e-12))
    if len(ks) >= 2:
        res.curves["phantom"] = fit("phantom", ks, losses, WIDTH, PILOT_TP)
    return res


def _plans():
    kw = dict(width=WIDTH, depth=2, batch=64, ks=(4, 8, 16), pps=(1, 2))
    return enumerate_plans(8, **kw), jspace.enumerate_plans(8, **kw)


def _scored(case, calib):
    plans, jplans = _plans()
    cal, jc = _calibs(calib)
    got = apply_iso_loss(plans, _iso(isoloss, fit_loss_curve, PilotResult,
                                     case),
                         cal, peak_flops=TPU_PEAK_FLOPS)
    want = jiso.apply_iso_loss(jplans, _iso(jiso, jiso.fit_loss_curve,
                                            JPilotResult, case), jc,
                               peak_flops=TPU_PEAK_FLOPS)
    return got, want


# ---------------------------------------------------------------------------
# loss curves
# ---------------------------------------------------------------------------

GRIDS = [
    ([4, 8, 16], [0.4 * (k / 4.0) ** -0.5 for k in (4, 8, 16)]),   # exact
    ([4, 8], [0.3, 0.3]),                                           # flat
    ([4, 8, 16], [0.2005, 0.2014, 0.1978]),
    ([2, 4, 8, 16, 32], [0.9, 0.5, 0.31, 0.22, 0.2]),
    ([4], [0.25]),
    ([4, 8], [0.0, 0.1]),                                           # clamped
]


@pytest.mark.parametrize("ks,losses", GRIDS)
def test_fit_loss_curve_matches_the_reference(ks, losses):
    got = fit_loss_curve("phantom", ks, losses, WIDTH, PILOT_TP)
    want = jiso.fit_loss_curve("phantom", ks, losses, WIDTH, PILOT_TP)
    _close(got.as_dict(), want.as_dict())
    for k in (1, 3, 4, 6.5, 8, 64):
        assert got.loss_at(k) == pytest.approx(want.loss_at(k), rel=TOL)
    for target in (0.05, 0.15, 0.2, 0.25, 0.35, 1.0, 0.0):
        for extra in (4.0, 1.0, 100.0):
            assert got.k_for(target, extra) == want.k_for(target, extra)


def test_loss_curve_fit_and_inversion():
    """The reference test's own cases (``tests/test_planner.py``)."""
    curve = fit_loss_curve("phantom", [4, 8, 16],
                           [0.4 * (k / 4.0) ** -0.5 for k in (4, 8, 16)],
                           width=512, pilot_tp=4)
    assert curve.b == pytest.approx(-0.5, rel=1e-6)
    assert curve.loss_at(8) == pytest.approx(0.4 / 2 ** 0.5, rel=1e-6)
    assert curve.k_for(0.2) is not None
    flat = fit_loss_curve("phantom", [4, 8], [0.3, 0.3], 512, 4)
    assert flat.k_for(0.2) is None


# ---------------------------------------------------------------------------
# iso-loss scoring and the verdict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calib", list(CALIBRATIONS))
@pytest.mark.parametrize("case", list(PILOTS))
def test_apply_iso_loss_matches_the_reference(case, calib):
    got, want = _scored(case, calib)
    assert [s.plan.name for s in got] == [s.plan.name for s in want]
    for g, w in zip(got, want):
        _close(g.as_dict(), w.as_dict(), g.plan.name)
    if case == "interpolated":
        assert any("nu_interpolated_from_k" in s.notes for s in got)
    if case == "censored":
        assert any(s.notes["nu_censored"] for s in got)
        assert any(not s.notes["reached_target"] for s in got)


@pytest.mark.parametrize("devices", [8, 4, 2])
@pytest.mark.parametrize("case", list(PILOTS))
def test_matched_loss_comparison_matches_the_reference(case, devices):
    got, want = _scored(case, "fitted")
    _close(matched_loss_comparison(got, devices),
           jiso.matched_loss_comparison(want, devices))


def test_iso_loss_result_lookup_and_record():
    got = _iso(isoloss, fit_loss_curve, PilotResult, "interpolated")
    want = _iso(jiso, jiso.fit_loss_curve, JPilotResult, "interpolated")
    _close(got.as_dict(), want.as_dict())
    for key in (("phantom", 4), ("phantom", 8), ("tensor_col", 0),
                ("lowrank_distill", 4)):
        assert got.lookup(*key) == want.lookup(*key)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _reports(case):
    """``build_report`` in both packages over the same inputs, and the
    frontiers and calibrations they drew from."""
    got, want = _scored(case, "fitted")
    plans, jplans = _plans()
    cons = Constraints(max_devices=8, hbm_bytes_per_device=2 ** 26)
    jcons_ = jcons.Constraints(max_devices=8, hbm_bytes_per_device=2 ** 26)
    _, rej = filter_feasible(plans, cons)
    _, jrej = jcons.filter_feasible(jplans, jcons_)
    front = pareto_frontier([s for s in got
                             if s.notes.get("reached_target", True)] or got)
    jfront = jpareto([s for s in want
                      if s.notes.get("reached_target", True)] or want)
    iso = _iso(isoloss, fit_loss_curve, PilotResult, case)
    jiso_ = _iso(jiso, jiso.fit_loss_curve, JPilotResult, case)
    cal, jc = _calibs("fitted")
    thr = [(got[0], "floor")]
    jthr = [(want[0], "floor")]
    meta = {"argv": {"devices": 8}, "target_loss": TARGET, "devices": 8}
    rep = build_report(calibration=cal, constraints=cons, scored=got,
                       frontier=front, rejected=rej,
                       throughput_rejected=thr, iso=iso,
                       comparison=matched_loss_comparison(got, 8), meta=meta)
    jrep = jreport.build_report(
        calibration=jc, constraints=jcons_, scored=want, frontier=jfront,
        rejected=jrej, throughput_rejected=jthr, iso=jiso_,
        comparison=jiso.matched_loss_comparison(want, 8), meta=meta)
    return rep, jrep, (front, jfront), (cal, jc)


@pytest.mark.parametrize("case", list(PILOTS))
def test_build_report_matches_the_reference(case):
    rep, jrep, (front, jfront), _ = _reports(case)
    assert rep["schema"] == jrep["schema"] == PLAN_SCHEMA
    for r in (rep, jrep):
        r.pop("generated_at")
    _close(rep, jrep)
    w, jw = pick_winner(front), jreport.pick_winner(jfront)
    assert w.plan.name == jw.plan.name
    assert plan_summary_lines(rep) == jreport.plan_summary_lines(jrep)


def test_pick_winner_of_nothing_and_summary_without_comparison():
    assert pick_winner([]) is None and jreport.pick_winner([]) is None
    rep = {"frontier": [], "comparison": None, "winner": None}
    assert plan_summary_lines(rep) == jreport.plan_summary_lines(rep)


def test_record_frontier_matches_the_reference():
    _, _, (front, jfront), (cal, jc) = _reports("reached")
    led, jled = Ledger(run="t"), JLedger(run="t")
    got = record_frontier(led, front, cal, suite="plan_test")
    want = jreport.record_frontier(jled, jfront, jc, suite="plan_test")
    _close([e.as_dict() for e in got], [e.as_dict() for e in want])


def test_each_package_loads_the_others_report(tmp_path):
    rep, jrep, _, _ = _reports("censored")
    mine = write_plan_report(rep, tmp_path / "port.json")
    theirs = jreport.write_plan_report(jrep, str(tmp_path / "ref.json"))
    _close(jreport.load_plan_report(mine), rep)
    _close(load_plan_report(theirs), jrep)
    rep_bad = dict(rep, schema="plan-report/v0")
    bad = write_plan_report(rep_bad, tmp_path / "bad.json")
    for load in (load_plan_report, jreport.load_plan_report):
        with pytest.raises(ValueError, match="unknown plan schema"):
            load(bad)


def test_write_plan_report_refuses_the_reference_report(tmp_path):
    assert DEFAULT_REPORT.parent.name == "build"
    with pytest.raises(ValueError, match="JAX package"):
        write_plan_report({"schema": PLAN_SCHEMA},
                          DEFAULT_REPORT.parent.parent / "PLAN_report.json")
    nested = tmp_path / "a" / "b" / "r.json"
    assert write_plan_report({"schema": PLAN_SCHEMA}, nested) == str(nested)


# ---------------------------------------------------------------------------
# RunConfig, SHAPES, applicable_shapes
# ---------------------------------------------------------------------------

def test_run_config_and_shapes_match_the_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(base.RunConfig) == fields(jbase.RunConfig)
    assert base.RunConfig.__dataclass_params__.frozen
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    rc = base.RunConfig(model=base.get_config("phi3-mini-3.8b", smoke=True),
                        shape=base.SHAPES["train_4k"])
    jrc = jbase.RunConfig(model=jbase.get_config("phi3-mini-3.8b",
                                                 smoke=True),
                          shape=jbase.SHAPES["train_4k"])
    for f in dataclasses.fields(jbase.RunConfig):
        if f.name not in ("model", "shape"):
            assert getattr(rc, f.name) == getattr(jrc, f.name)
    assert dataclasses.asdict(rc.shape) == dataclasses.asdict(jrc.shape)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS + ["paper-ffn-16k"])
@pytest.mark.parametrize("smoke", [False, True])
def test_applicable_shapes_match_the_reference(arch, smoke):
    got = base.applicable_shapes(base.get_config(arch, smoke=smoke))
    assert got == jbase.applicable_shapes(jbase.get_config(arch,
                                                           smoke=smoke))
    assert all(name in base.SHAPES for name in got)
