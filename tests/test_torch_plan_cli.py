"""The port's planner CLI (``python -m repro_torch.launch.plan``) and the
training launcher's ``--plan`` on the CPU.

* The reference test's run (``tests/test_planner.py:
  test_plan_cli_writes_schema_valid_report``: devices 8, target 0.25,
  width 512, ks 4,8, 80 pilot steps, pilot tp 4), with ``--device cpu``
  and the report in a temporary directory, under the reference test's
  assertions: the schema, a frontier, the paper-defaults provenance, the
  pilots, the acceptance inequality with ``phantom_dominates``, a winner
  that carries its projection spec.  The pilots draw the port's own
  weights and batches; ``tests/test_torch_planner_pilots.py`` holds the
  pilots' arithmetic to the reference's on the reference's draws.
* ``--compiled-hbm-check`` on the CPU (with ``--no-pilots``): every
  frontier plan notes a measured peak of None and the frontier is the
  unchecked one; ``hbm_readings`` is None there.  ``--ledger``
  calibrates from a ledger JSONL, a missing one raises, and so does a
  repo-root ``--out``.  ``plan(args, iso=...)`` takes the caller's
  pilots and gives ``plan(args)``'s report.
* ``_apply_plan`` against the reference's on the same report files
  (phantom and tensor winners, a budget too small for the winner), and
  ``--plan auto`` planning without pilots when there is no report.
* ``launch/train.py main --plan REPORT`` trains phi3-smoke 2 steps on the
  winner's mesh (2 gloo ranks), losses finite."""
import contextlib
import dataclasses
import io
import json
import math
import re
from argparse import Namespace
from pathlib import Path

import pytest

import repro.launch.train as jax_train
from repro.configs.base import get_config as jax_get_config
from repro_torch.configs.base import PROJECTION_SITES, get_config
from repro_torch.launch import plan as plan_cli
from repro_torch.launch import train as torch_train
from repro_torch.planner import (PlanCandidate, hbm_readings,
                                 load_plan_report, measured_hbm_bytes)

REF_ARGV = ["--devices", "8", "--target-loss", "0.25", "--width", "512",
            "--batch", "64", "--ks", "4,8", "--pilot-steps", "80",
            "--pilot-tp", "4"]
ROOT = Path(__file__).resolve().parents[1]


def _plan(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = plan_cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("plan") / "PLAN_report.json"
    rc, log = _plan(REF_ARGV + ["--device", "cpu", "--out", str(out)])
    return rc, log, out


def test_plan_cli_writes_schema_valid_report(cli):
    rc, log, out = cli
    assert rc == 0, log
    report = load_plan_report(str(out))      # validates the schema tag
    assert report["schema"] == "plan-report/v1"
    assert report["frontier"], "frontier must be non-empty"
    # calibration provenance is recorded (paper-defaults fallback here)
    assert "paper defaults" in report["calibration"]["source"]
    assert report["calibration"]["provenance"]
    # pilots ran and the iso-loss section is populated
    assert report["iso_loss"]["pilots"]
    assert report["iso_loss"]["target_loss"] == 0.25
    # the acceptance inequality: some phantom plan on a smaller mesh
    # beats EVERY full-mesh tensor plan at matched predicted loss
    matched = [s for s in report["plans"]
               if s.get("notes", {}).get("reached_target")]
    tensor_full = [s for s in matched
                   if s["plan"]["strategy"] == "tensor_col"
                   and s["plan"]["devices"] == 8]
    phantom_small = [s for s in matched
                     if s["plan"]["strategy"] == "phantom"
                     and s["plan"]["devices"] < 8]
    assert tensor_full and phantom_small
    best_ph = min(s["energy_j_total"] for s in phantom_small)
    assert all(best_ph < s["energy_j_total"] for s in tensor_full)
    assert report["comparison"]["phantom_dominates"] is True
    # the winner is applied-ready: it carries a projection spec
    assert report["winner"]["plan"]["projection_spec"]["kind"]
    # the port's differences: no audit, the H100's budget
    assert "audit" not in report
    assert "# audit: not ported (ROADMAP.md queue 1, item 8 part 4)" in log
    assert report["constraints"]["hbm_bytes_per_device"] == 80e9
    assert report["meta"]["argv"]["device"] == "cpu"


def test_serve_calibration_reads_the_report(cli):
    """The serve launcher's ``--calibration`` takes the report's
    constants (``planner/calibration.py: load_calibration``)."""
    from repro_torch.planner import load_calibration
    block = load_plan_report(str(cli[2]))["calibration"]
    assert load_calibration(plan_report_path=str(cli[2])).as_dict() == block


def test_parser_defaults():
    args = plan_cli.build_parser().parse_args([])
    assert (args.devices, args.width, args.depth, args.batch, args.ks,
            args.strategies, args.pilot_steps, args.pilot_tp,
            args.target_loss) == (8, 1024, 2, 64, "4,8,16",
                                  "tensor_col,phantom", 300, 4, 0.2)
    assert args.hbm_gb == 80.0 and args.ledger is None
    assert args.device is None and args.audit
    assert Path(args.out) == ROOT / "build" / "PLAN_report.json"
    assert not plan_cli.build_parser().parse_args(["--no-audit"]).audit
    # the observability flags (ROADMAP.md queue 1 item 8 part 3, which
    # the parser refused until it was ported)
    assert (args.trace_out, args.metrics_out) == (None, None)
    for flag in ("--trace-out", "--metrics-out"):
        got = plan_cli.build_parser().parse_args([flag, "x"])
        assert getattr(got, flag[2:].replace("-", "_")) == "x"


def test_compiled_hbm_check_on_the_cpu_keeps_the_frontier(tmp_path):
    base = REF_ARGV + ["--no-pilots", "--device", "cpu"]
    rc, _ = _plan(base + ["--out", str(tmp_path / "a.json")])
    rc2, log = _plan(base + ["--compiled-hbm-check", "--no-audit",
                             "--out", str(tmp_path / "b.json")])
    assert rc == rc2 == 0
    assert "# audit" not in log
    plain = load_plan_report(str(tmp_path / "a.json"))
    checked = load_plan_report(str(tmp_path / "b.json"))
    assert [s["plan"]["name"] for s in checked["frontier"]] == \
        [s["plan"]["name"] for s in plain["frontier"]]
    assert checked["frontier"]
    for s in checked["frontier"]:
        assert "measured_hbm_bytes" in s["notes"]
        assert s["notes"]["measured_hbm_bytes"] is None
    assert checked["counts"] == plain["counts"]
    assert checked["winner"]["plan"] == plain["winner"]["plan"]


def test_ledger_calibration_and_repo_root_out(tmp_path):
    rows = []
    for i, pred in enumerate((1e6, 2e6, 4e6)):
        rows.append({"name": f"r{i}", "suite": "s", "kind": "train",
                     "impl": "phantom",
                     "measured": {"flops_per_device": 1.2 * pred},
                     "predicted": {"flops_per_device": pred}})
    ledger = tmp_path / "ledger.jsonl"
    ledger.write_text("".join(json.dumps(r) + "\n" for r in rows))
    rc, log = _plan(REF_ARGV + ["--no-pilots", "--device", "cpu",
                                "--ledger", str(ledger),
                                "--out", str(tmp_path / "r.json")])
    assert rc == 0 and f"ledger-fit ({ledger})" in log
    calib = load_plan_report(str(tmp_path / "r.json"))["calibration"]
    assert calib["source"] == "ledger-fit"
    assert calib["alpha_scale"]["phantom"] == pytest.approx(1.2)
    with pytest.raises(ValueError, match="repo root"):
        plan_cli.main(REF_ARGV + ["--no-pilots", "--out",
                                  str(ROOT / "PLAN_report.json")])


def test_missing_ledger_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="--ledger"):
        plan_cli.main(REF_ARGV + ["--no-pilots", "--device", "cpu",
                                  "--ledger", str(tmp_path / "no.jsonl"),
                                  "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_hbm_readings_on_the_cpu_are_none():
    plan = PlanCandidate(dp=1, tp=2, strategy="phantom", width=64, depth=2,
                         batch=8, k=4)
    assert hbm_readings(plan, "cpu") is None
    assert measured_hbm_bytes(plan, "cpu") is None


def test_plan_takes_the_callers_pilots(cli, tmp_path):
    """``plan(args, iso=pilots(args))``, as ``chip_smoke.py`` runs it,
    gives the report that ``plan(args)`` gives (the pilots are seeded)."""
    args = plan_cli.build_parser().parse_args(
        REF_ARGV + ["--device", "cpu", "--out", str(tmp_path / "r.json")])
    iso = plan_cli.pilots(args)
    with contextlib.redirect_stdout(io.StringIO()):
        got = plan_cli.plan(args, iso=iso)
    want = load_plan_report(str(cli[2]))
    for key in ("nu", "final_loss", "curves"):
        assert got["iso_loss"][key] == want["iso_loss"][key]
    assert iso.as_dict()["nu"] == want["iso_loss"]["nu"]
    assert got["comparison"] == want["comparison"]
    assert got["winner"]["plan"] == want["winner"]["plan"]


def _spec_fields(spec):
    return {f.name: getattr(spec, f.name)
            for f in dataclasses.fields(spec)}


def _both_applied(path, dp, tp, pp=1):
    args = torch_train.build_parser().parse_args(
        ["--plan", str(path), "--dp", str(dp), "--tp", str(tp), "--pp",
         str(pp)])
    jargs = Namespace(plan=str(path), dp=dp, tp=tp, pp=pp)
    with contextlib.redirect_stdout(io.StringIO()):
        got = torch_train._apply_plan(
            args, get_config("phi3-mini-3.8b", smoke=True))
        want = jax_train._apply_plan(
            jargs, jax_get_config("phi3-mini-3.8b", smoke=True))
    return got, want


@pytest.mark.parametrize("winner", ["phantom", "tensor_col"])
def test_apply_plan_matches_the_reference(cli, tmp_path, winner):
    report = json.loads(cli[2].read_text())
    if winner != report["winner"]["plan"]["strategy"]:
        report["winner"] = next(s for s in report["plans"]
                                if s["plan"]["strategy"] == winner)
    path = tmp_path / "report.json"
    path.write_text(json.dumps(report))
    (cfg, *mesh), (jcfg, *jmesh) = _both_applied(path, 2, 4)
    assert mesh == jmesh
    assert tuple(mesh) == (report["winner"]["plan"]["dp"],
                           report["winner"]["plan"]["tp"],
                           report["winner"]["plan"]["pp"])
    for site in PROJECTION_SITES:
        got = _spec_fields(cfg.projection_spec(site))
        want = jcfg.projection_spec(site)
        assert got == {k: getattr(want, k) for k in got}, site
    assert cfg.projections.default.kind == (
        "phantom" if winner == "phantom" else "tensor")


def test_apply_plan_refuses_a_budget_below_the_winner(cli):
    for apply, args, cfg in (
            (torch_train._apply_plan,
             torch_train.build_parser().parse_args(["--plan",
                                                    str(cli[2])]),
             get_config("phi3-mini-3.8b", smoke=True)),
            (jax_train._apply_plan,
             Namespace(plan=str(cli[2]), dp=1, tp=1, pp=1),
             jax_get_config("phi3-mini-3.8b", smoke=True))):
        with pytest.raises(ValueError, match="needs 2 devices"), \
                contextlib.redirect_stdout(io.StringIO()):
            apply(args, cfg)
    with pytest.raises(FileNotFoundError, match="no such report"):
        torch_train._apply_plan(Namespace(plan="/nonexistent.json", dp=1,
                                          tp=1, pp=1), None)


def test_plan_auto_plans_without_pilots(tmp_path, monkeypatch):
    out = tmp_path / "build" / "PLAN_report.json"
    monkeypatch.setattr(plan_cli, "DEFAULT_OUT", str(out))
    args = torch_train.build_parser().parse_args(
        ["--plan", "auto", "--tp", "2", "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cfg, dp, tp, pp = torch_train._apply_plan(
            args, get_config("phi3-mini-3.8b", smoke=True))
    assert "no-pilot planning pass" in buf.getvalue()
    report = load_plan_report(str(out))
    assert report["iso_loss"] is None
    assert report["meta"]["devices"] == 2
    w = report["winner"]["plan"]
    assert (dp, tp, pp) == (w["dp"], w["tp"], w["pp"]) and dp * tp * pp <= 2


def test_train_main_applies_the_plan(cli, capfd, tmp_path):
    """``--plan`` on the LM path, traced: ``--trace-out`` holds each of
    the winner's 2 ranks' steps under its pid, ``--metrics-out`` rank
    0's step count, and ``--profile-dir`` gives each rank a watchdog
    (``--slow-step`` is the elastic path's and parses here too, as in
    the reference); ``--overlap`` (item 8 part 4) raises."""
    from repro_torch.obs import load_trace, span_events
    trace, prom = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    rc = torch_train.main(["--plan", str(cli[2]), "--device", "cpu",
                           "--smoke", "--tp", "2", "--steps", "2",
                           "--trace-out", trace, "--metrics-out", prom,
                           "--profile-dir", str(tmp_path / "prof"),
                           "--slow-step", "1"])
    out = capfd.readouterr().out
    assert rc == 0, out
    steps = [e["pid"] for e in span_events(load_trace(trace))
             if e["name"] == "train/step"]
    assert sorted(steps) == [0, 0, 1, 1]
    snap = json.loads(open(prom).read())
    assert snap["metrics"]["train_steps_total"]["values"] == {
        '{suite="trainer"}': 2}
    winner = load_plan_report(str(cli[2]))["winner"]["plan"]["name"]
    assert f"[plan] applying winner {winner}" in out
    assert "tp=2" in out
    losses = [float(v) for v in re.findall(
        r"\[trainer\] step \d+ loss (\S+) gnorm", out)]
    assert losses and all(math.isfinite(v) for v in losses), out
    with pytest.raises(NotImplementedError, match="item 8 part 4"):
        torch_train.main(["--overlap", "1", "--device", "cpu"])
