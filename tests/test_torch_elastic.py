"""The port's elastic runtime (``train/elastic.py: run_elastic``) on the
reference's seeded-fault cases (``tests/test_elastic.py``), one run per
fault script (a module-scoped fixture each; every phase spawns its gloo
CPU ranks), and against the reference's run on the same config and
script.

Width 32, depth 2, batch 16, 8 devices on 4 hosts, tensor_col first,
ks (4,), checkpoints every 5 steps, the audit gate off (as in the
reference's tests; ``test_unported_gates_raise`` and the CLI run hold it
on), target 1e-9
(never reached: every run goes to ``max_steps``).  The port's weights
and batches are not the reference's (its batches come from numpy, its
draws from torch), so losses are not compared; the plans, the recovery
fields and the account's step counts are, with the reference's peak
given to the port's scoring.  Also: the CLI run of the acceptance
command (with a slow step, a trace and metrics), the energy-drift
watchdog over a run on an injected step clock, the re-plan's audit gate
against the reference's (``solve_plan(audit=True)``), and what raises: a
device budget that does not divide over the hosts, a repo-root
``--report-out``."""
import contextlib
import functools
import io
from pathlib import Path

import numpy as np
import pytest

from repro.core.energy import TPU_PEAK_FLOPS
from repro.planner.calibration import paper_default_calibration as jpaper
from repro.train.elastic import ElasticConfig as JElasticConfig
from repro.train.elastic import run_elastic as jax_run_elastic
from repro.train.fault import FaultScript as JFaultScript
from repro_torch.planner import paper_default_calibration, score_plans
from repro_torch.telemetry import Ledger
from repro_torch.train import elastic
from repro_torch.train.elastic import ElasticConfig, run_elastic, solve_plan
from repro_torch.train.fault import FaultScript

# the straggler detector off (threshold 1e6) on both sides: a loaded
# host's CPU step times would trip it at random, and its out-of-cadence
# save would move the restored step
BASE = dict(devices=8, hosts=4, width=32, depth=2, batch=16,
            target_loss=1e-9, max_steps=24, checkpoint_every=5, ks=(4,),
            audit_replan=False, heartbeat_timeout_s=2.5,
            initial_strategy="tensor_col", straggler_threshold=1e6)
KILL12 = ((12, "host3"),)


def _quiet(*a, **k):
    pass


def _cfg(path, **kw):
    return ElasticConfig(**dict(BASE, workdir=str(path), **kw))


def _run(tmp_path_factory, name, kills=(), ledger=None, **kw):
    """One port run at the reference's peak (the parity tests compare its
    plans with the reference's)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(elastic, "score_plans", functools.partial(
            score_plans, peak_flops=TPU_PEAK_FLOPS))
        return run_elastic(_cfg(tmp_path_factory.mktemp(name), **kw),
                           fault_script=FaultScript(kills=kills),
                           ledger=ledger, log_fn=_quiet, device="cpu")


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return _run(tmp_path_factory, "clean", max_steps=12)


@pytest.fixture(scope="module")
def kill12(tmp_path_factory):
    ledger = Ledger(run="test")
    return _run(tmp_path_factory, "kill12", KILL12, ledger=ledger), ledger


@pytest.fixture(scope="module")
def reference_kill12(tmp_path_factory):
    cfg = JElasticConfig(**dict(
        BASE, workdir=str(tmp_path_factory.mktemp("ref12"))))
    return jax_run_elastic(cfg, fault_script=JFaultScript(kills=KILL12),
                           calibration=jpaper(), log_fn=_quiet)


def test_no_faults_runs_clean(clean):
    res = clean
    assert not res.aborted
    assert res.final_step == 12
    assert res.recoveries == []
    assert len(res.phases) == 1
    assert res.account["replay_overhead_ratio"] == 0.0
    assert res.account["steps_total"] == 12
    assert len(res.losses) == 12
    assert all(np.isfinite(res.losses))


def test_recovery_resumes_from_checkpoint(kill12):
    res, _ = kill12
    assert not res.aborted
    assert res.final_step == 24
    assert len(res.recoveries) == 1
    rec = res.recoveries[0]
    assert rec["restored_step"] == 10
    assert rec["detect_step"] > 12
    assert rec["replayed_steps"] == rec["detect_step"] - 10
    assert not rec["from_scratch"]
    assert rec["dead_hosts"] == ["host3"]
    assert len(res.phases) == 2
    assert res.phases[1]["restart"]
    assert res.account["replayed_steps"] == rec["replayed_steps"]
    assert res.account["restarts"] == 1


def test_phantom_downsize_distills(kill12):
    """The reference's case re-plans over the phantom family only; here
    the re-plan may pick either, and at 6 surviving devices no tensor
    plan divides width 32 and batch 16, so the same fault script
    downsizes onto a phantom plan by construction: the checkpoint is
    SVD-distilled into the (k, tp) factor class on fewer devices."""
    res, _ = kill12
    rec = res.recoveries[0]
    assert rec["distilled"]
    assert rec["devices_after"] < rec["devices_before"]
    assert res.phases[0]["strategy"] == "tensor_col"
    assert res.phases[1]["strategy"] == "phantom"
    assert res.losses[-1] < res.losses[0]


def test_account_consistency(kill12):
    res, _ = kill12
    a = res.account
    np.testing.assert_allclose(
        a["energy_j_total"],
        a["energy_j_useful"] + a["energy_j_replay"]
        + a["energy_j_ckpt_io"] + a["energy_j_restart"], rtol=1e-9)
    assert a["steps_total"] == sum(p["steps"] for p in res.phases)
    assert a["replayed_steps"] == sum(p["replayed_steps"]
                                      for p in res.phases)
    step_j = a["energy_j_useful"] + a["energy_j_replay"]
    np.testing.assert_allclose(a["replay_overhead_ratio"],
                               a["energy_j_replay"] / step_j, rtol=1e-9)
    assert 0.0 < a["replay_overhead_ratio"] < 1.0
    assert a["restarts"] == 1
    assert a["schema"] == "recovery-account/v1"
    assert a["ckpt_io_bytes"] > 0 and a["compile_s"] > 0


def test_ledger_entry_recorded(kill12):
    res, ledger = kill12
    rows = [e for e in ledger.entries if e.kind == "elastic"]
    assert len(rows) == 1
    e = rows[0]
    assert e.suite == "elastic"
    assert e.name == "elastic_ffn32"
    assert set(e.predicted) == {"energy_j_total", "energy_j_useful",
                                "energy_j_replay"}
    assert e.extra["recovery"]["schema"] == "recovery-account/v1"
    assert len(e.extra["recoveries"]) == 1
    assert e.extra["plans"] == res.plan_names


def test_checkpoint_bytes_are_the_saves_global_state(kill12):
    """Each phase's ranks wrote, in all, its saves times the plan's
    global parameters and AdamW moments (float32)."""
    from repro_torch.core.ffn import ffn_model_params
    from repro_torch.train.elastic import plan_from_dict
    res, _ = kill12
    for ph in res.phases:
        plan = elastic.PlanCandidate(
            dp=ph["mesh"][0], tp=ph["mesh"][1], pp=ph["mesh"][2],
            strategy=ph["strategy"], width=32, depth=2, batch=16,
            k=ph["k"])
        start = ph["start_step"]
        saves = len([s for s in range(start + 1, start + ph["steps"] + 1)
                     if s % 5 == 0])
        per = 3 * 4 * ffn_model_params(plan.model_config(), plan.tp)
        assert ph["ckpt_io_bytes"] == saves * per
        assert plan_from_dict(plan.as_dict()) == plan


def test_matches_the_reference_run(kill12, reference_kill12):
    """The same config and fault script as the reference's run: the same
    plans, recovery step fields and the account's step counts."""
    res, _ = kill12
    ref = reference_kill12
    assert res.plan_names == ref.plan_names
    for mine, theirs in zip(res.recoveries, ref.recoveries):
        for key in ("detect_step", "restored_step", "replayed_steps",
                    "distilled", "from_scratch", "dead_hosts",
                    "devices_before", "devices_after", "plan_before",
                    "plan_after", "decision", "audit_ok"):
            assert mine[key] == theirs[key], key
    assert len(res.recoveries) == len(ref.recoveries)
    for key in ("steps_total", "replayed_steps", "restarts"):
        assert res.account[key] == ref.account[key], key
    assert ([(p["start_step"], p["steps"], p["replayed_steps"])
             for p in res.phases]
            == [(p["start_step"], p["steps"], p["replayed_steps"])
                for p in ref.phases])
    for mine, theirs in zip(res.phases, ref.phases):
        np.testing.assert_allclose(mine["energy_j_per_iter"],
                                   theirs["energy_j_per_iter"], rtol=1e-9)
    assert (res.final_step, res.aborted) == (ref.final_step, ref.aborted)


def test_kill_during_warmup_restarts_from_scratch(tmp_path_factory):
    res = _run(tmp_path_factory, "warmup", ((2, "host1"),), max_steps=14)
    assert not res.aborted
    assert res.final_step == 14
    assert len(res.recoveries) == 1
    rec = res.recoveries[0]
    assert rec["from_scratch"]
    assert rec["restored_step"] == 0
    assert rec["replayed_steps"] == rec["detect_step"]


def test_all_hosts_dead_aborts(tmp_path_factory):
    res = _run(tmp_path_factory, "dead",
               tuple((3, f"host{i}") for i in range(4)))
    assert res.aborted
    assert not res.reached_target


def test_max_restarts_exhausted_aborts(tmp_path_factory):
    res = _run(tmp_path_factory, "max0", ((6, "host2"),), max_restarts=0)
    assert res.aborted
    assert res.recoveries == []


def test_devices_must_divide_hosts(tmp_path):
    with pytest.raises(ValueError, match="divide"):
        run_elastic(_cfg(tmp_path, devices=6, hosts=4), log_fn=_quiet,
                    device="cpu")


def test_unported_gates_raise(tmp_path):
    """The gates that raised until they were ported now run.  The
    re-plan audit (item 8 part 4): ``ElasticConfig.audit_replan``
    defaults to on, as the reference's, and ``solve_plan(audit=True)``
    walks the energy-sorted candidates, on the caller's worlds (without
    them it raises), until one passes the audit, here
    the first, which is the reference's audited plan on the same
    budget, config and calibration (scored at the reference's peak);
    its audit record passed with 0 errors.  The watchdog with its
    slow-step fixtures (part 3) watches a run: on an injected step clock
    the slow step is the one trip, and the watchdog's state crossed the
    phase's ranks back to the caller."""
    from repro.train.elastic import solve_plan as jax_solve_plan
    from repro_torch.analysis.units import RankPools
    from repro_torch.obs import EnergyDriftWatchdog
    from torch_ranks import VirtualStepClock
    assert ElasticConfig(workdir=str(tmp_path)).audit_replan is True
    assert JElasticConfig(workdir=str(tmp_path)).audit_replan is True
    cfg = _cfg(tmp_path, devices=6, hosts=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(elastic, "score_plans", functools.partial(
            score_plans, peak_flops=TPU_PEAK_FLOPS))
        with pytest.raises(ValueError, match="pass pools"):
            solve_plan(6, cfg, paper_default_calibration(), audit=True,
                       device="cpu")
        with RankPools("cpu") as pools:
            got, audit = solve_plan(6, cfg, paper_default_calibration(),
                                    audit=True, device="cpu", pools=pools)
    jcfg = JElasticConfig(**dict(BASE, devices=6, hosts=3,
                                 workdir=str(tmp_path / "jax")))
    want, jaudit = jax_solve_plan(6, jcfg, jpaper(), audit=True)
    assert got.plan.name == want.plan.name
    assert got.notes["audit_ok"] and want.notes["audit_ok"]
    assert list(audit) == list(jaudit) == [got.plan.name]
    assert audit[got.plan.name]["ok"] and \
        audit[got.plan.name]["counts"]["error"] == 0
    ledger = Ledger(run="t")
    wd = EnergyDriftWatchdog(min_samples=3, ledger=ledger)
    res = run_elastic(_cfg(tmp_path / "slow", devices=2, hosts=2,
                           max_steps=6, slow_steps=(5,)),
                      watchdog=wd, ledger=ledger, log_fn=_quiet,
                      device="cpu", step_clock=VirtualStepClock(0.01))
    assert res.final_step == 6
    assert [(t.kind, t.step) for t in wd.trips] == [("spike", 5)]
    assert wd.summary()["observations"] == 6
    assert [e.kind for e in ledger.entries].count("anomaly") == 1


def test_cli_survives_a_loss_and_reaches_the_target(tmp_path):
    """``python -m repro_torch.launch.train --elastic --device cpu
    --kill-at-step 25`` at the reference CLI's defaults (width 64, 300
    steps, target 0.12), with ``--slow-step 20``, ``--trace-out`` and
    ``--metrics-out``: it survives the loss, reaches the target and
    exits 0, prints the watchdog's line, and its trace passes
    ``verify-recovery`` against its report; the report defaults to
    ``build/``, and a repo-root report path raises before anything
    runs."""
    from repro_torch.launch.obs import main as obs_main
    from repro_torch.launch.train import (DEFAULT_ELASTIC_REPORT,
                                          build_parser, main)
    from repro_torch.telemetry.ledger import REPORT_DIR, load_report
    out = tmp_path / "build" / "elastic.json"
    trace, prom = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--elastic", "--device", "cpu", "--kill-at-step", "25",
                   "--workdir", str(tmp_path / "w"), "--report-out",
                   str(out), "--slow-step", "20", "--trace-out", trace,
                   "--metrics-out", prom])
        assert obs_main(["verify-recovery", "--trace", trace,
                         "--report", str(out)]) == 0
    log = buf.getvalue()
    assert rc == 0, log
    # the re-plan passed its audit (the gate is on, as the reference's)
    assert "surviving devices, audit ok), restored" in log
    assert "step 25: host host3 lost" in log and "REACHED" in log
    assert "[obs] watchdog:" in log and "[obs] trace ->" in log
    assert "elastic_recoveries_total" in open(prom).read()
    rows = [e for e in load_report(str(out))["entries"]
            if e["kind"] == "elastic"]
    assert rows[0]["extra"]["reached_target"]
    assert len(rows[0]["extra"]["recoveries"]) == 1
    args = build_parser().parse_args(["--elastic"])
    assert (args.steps, args.batch, args.width) == (300, 32, 64)
    assert (REPORT_DIR / DEFAULT_ELASTIC_REPORT).parent.name == "build"
    root = Path(__file__).resolve().parents[1]
    with pytest.raises(ValueError, match="repo root"):
        main(["--elastic", "--device", "cpu", "--report-out",
              str(root / "BENCH_report.json")])
    # --plan applies a plan report since it was ported
    # (tests/test_torch_plan_cli.py), and --slow-step and --profile-dir
    # (item 8 part 3) parse as the reference's do
    args = build_parser().parse_args(["--elastic", "--slow-step", "3",
                                      "--slow-step", "7", "--profile-dir",
                                      "p"])
    assert (args.slow_step, args.slow_factor, args.profile_dir) == \
        ([3, 7], 6.0, "p")
    with pytest.raises(NotImplementedError, match="queue 2, item 8"):
        main(["--elastic", "--overlap", "1"])
