"""The port's ``train/fault.py`` against the reference's cases
(``tests/test_fault.py``), its recovery account against the reference's,
and the trainer's fault hooks.

  * virtual-clock heartbeat detection, the straggler detector and its
    metered-loop hook (a ledger event of kind ``fault``), the restart
    policy, fault scripts; the two packages' simulated clusters detect
    the same hosts at the same steps under the same scripts;
  * kill and restore end to end on dp 2 x tp 4 gloo ranks
    (phi3-mini-smoke): 2 steps saved, a host killed and detected on the
    virtual clock, a new world of ranks restores the latest checkpoint
    and its steps 3 and 4 equal the uninterrupted run's;
  * ``telemetry/predict.py: recovery_account`` equal to the reference's
    to 1e-9;
  * ``Trainer``: a straggler step takes an out-of-cadence checkpoint;
    ``launch/train.py --ckpt-dir`` resumes from the checkpoint there.
"""
import io
import contextlib
import time

import numpy as np
import pytest

from repro.telemetry.predict import recovery_account as jax_recovery_account
from repro.train import fault as jfault
from repro_torch.launch.mesh import spawn
from repro_torch.telemetry import Ledger
from repro_torch.telemetry.predict import (CKPT_DISK_BW_BPS,
                                           recovery_account)
from repro_torch.train.fault import (FaultScript, RestartPolicy,
                                     SimulatedCluster, StragglerDetector,
                                     VirtualClock, note_step_time)

import torch_ranks


def test_heartbeat_detects_dead_host_virtual(tmp_path):
    cl = SimulatedCluster(str(tmp_path), hosts=4, timeout_s=2.5,
                          virtual=True)
    cl.tick(step=1)
    assert cl.check() == []
    cl.kill("host2")
    cl.advance(2.5)
    cl.tick(step=2)
    assert cl.check() == []
    cl.advance(1.0)
    cl.tick(step=3)
    assert cl.check() == ["host2"]


def test_virtual_clock_is_shared(tmp_path):
    cl = SimulatedCluster(str(tmp_path), hosts=2, timeout_s=1.0,
                          virtual=True)
    assert isinstance(cl.clock, VirtualClock)
    assert cl.monitor.clock is cl.clock
    assert all(hb.clock is cl.clock for hb in cl.hbs.values())


def test_all_hosts_dead(tmp_path):
    cl = SimulatedCluster(str(tmp_path), hosts=3, timeout_s=1.0,
                          virtual=True)
    cl.tick(0)
    for h in list(cl.hosts):
        cl.kill(h)
    cl.advance(2.0)
    assert cl.check() == ["host0", "host1", "host2"]


def test_straggler_detector():
    det = StragglerDetector(window=20, threshold=2.0)
    for s in range(20):
        assert not det.record(s, 0.1)
    assert det.record(20, 0.5)
    assert not det.record(21, 0.12)
    assert len(det.flagged) == 1


def test_straggler_needs_history():
    det = StragglerDetector(window=20, threshold=2.0)
    for s in range(9):
        det.record(s, 0.1)
    assert not det.record(9, 99.0)
    assert det.flagged == []


def test_note_step_time_wiring():
    det = StragglerDetector(window=20, threshold=2.0)
    pol = RestartPolicy(checkpoint_on_straggler=True)
    ledger = Ledger(run="test")
    for s in range(15):
        assert note_step_time(det, pol, s, 0.1, ledger) is None
    decision = note_step_time(det, pol, 15, 1.0, ledger,
                              name="unit", arch="ffn", impl="tensor", p=2)
    assert decision == "checkpoint"
    faults = [e for e in ledger.entries if e.kind == "fault"]
    assert len(faults) == 1
    e = faults[0]
    assert e.name == "unit_step15"
    assert e.extra["event"] == "straggler"
    assert e.extra["decision"] == "checkpoint"
    assert e.measured["slowdown"] > 2.0
    assert pol.restarts == 0


def test_note_step_time_no_detector():
    assert note_step_time(None, RestartPolicy(), 0, 1.0) is None


def test_restart_policy_limits():
    pol = RestartPolicy(max_restarts=2)
    assert pol.on_host_failure(["h1"], None) == "restore"
    assert pol.on_host_failure(["h1"], None) == "restore"
    assert pol.on_host_failure(["h1"], None) == "abort"


def test_restart_policy_straggler_decision():
    assert RestartPolicy().on_straggler(3, 1.0) == "checkpoint"
    assert RestartPolicy(
        checkpoint_on_straggler=False).on_straggler(3, 1.0) == "log"


def test_fault_script():
    fs = FaultScript(kills=((5, "host1"), (5, "host2"), (9, "host0")))
    assert fs.hosts_at(5) == ["host1", "host2"]
    assert fs.hosts_at(6) == []
    assert fs.kill_steps == [5, 9]
    assert FaultScript().hosts_at(0) == []


@pytest.mark.parametrize("kills,timeout", [
    (((12, "host3"),), 2.5), (((2, "host1"),), 0.5),
    (((7, "host1"), (18, "host2")), 2.5),
    (tuple((3, f"host{i}") for i in range(4)), 1.5)])
def test_clusters_detect_as_the_reference_does(tmp_path, kills, timeout):
    """The elastic loop's event order a step (kills, advance, tick,
    check) on both packages' clusters: the same dead hosts each step."""
    seen = []
    for mod, sub in ((jfault, "ref"), (None, "port")):
        cl = (mod.SimulatedCluster if mod else SimulatedCluster)(
            str(tmp_path / sub), hosts=4, timeout_s=timeout, virtual=True)
        fs = (mod.FaultScript if mod else FaultScript)(kills=kills)
        steps = []
        for step in range(30):
            for host in fs.hosts_at(step):
                cl.kill(host)
            cl.advance(1.0)
            cl.tick(step)
            steps.append(cl.check())
        seen.append(steps)
    assert seen[0] == seen[1]
    assert any(seen[1])


def test_kill_restore_end_to_end(tmp_path):
    """A host lost after the step-2 checkpoint: detected on the virtual
    clock, the policy restores, and a new world of dp 2 x tp 4 ranks
    resumes from the latest checkpoint; its losses equal the
    uninterrupted run's."""
    job = {"dir": str(tmp_path / "ckpt"), "part": 1}
    cl = SimulatedCluster(str(tmp_path / "hb"), hosts=2, timeout_s=0.5,
                          virtual=True)
    for s in range(2):
        cl.tick(s)
        cl.advance(0.1)
    first = spawn(torch_ranks.kill_restore_body, 2, 4, "cpu", timeout_s=300,
                  args=(job,))
    cl.kill("host1")
    cl.advance(1.0)
    cl.tick(2)
    dead = cl.check()
    assert dead == ["host1"]
    assert RestartPolicy().on_host_failure(dead, None) == "restore"
    resumed = spawn(torch_ranks.kill_restore_body, 2, 4, "cpu",
                    timeout_s=300, args=(dict(job, part=2),))
    for a, b in zip(first, resumed):
        assert b["step"] == 2
        np.testing.assert_allclose(b["resumed"], a["straight"][2:],
                                   rtol=1e-6)


_PHASES = [
    {"steps": 27, "replayed_steps": 0, "devices": 8,
     "energy_j_per_iter": 0.5, "ckpt_io_bytes": 3e6, "ckpt_io_s": 0.01,
     "compile_s": 1.5, "wall_s": 3.0},
    {"steps": 40, "replayed_steps": 7, "devices": 2,
     "energy_j_per_iter": 0.125, "ckpt_io_bytes": 5e6, "ckpt_io_s": 0.0,
     "compile_s": 2.25, "wall_s": 4.0}]
_RECOVERIES = [{"devices_after": 2, "restore_s": 0.03, "replan_s": 0.002}]


@pytest.mark.parametrize("phases,recoveries", [
    (_PHASES, _RECOVERIES), (_PHASES[:1], []), ([], [])])
def test_recovery_account_matches_the_reference(phases, recoveries):
    got = recovery_account(phases, recoveries)
    want = jax_recovery_account(phases, recoveries)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=0)
    if phases:
        # the second phase's IO seconds come from the assumed bandwidth
        assert got["ckpt_io_s"] == pytest.approx(
            sum(p["ckpt_io_s"] or p["ckpt_io_bytes"] / CKPT_DISK_BW_BPS
                for p in phases))


def _smoke_trainer(tmp_path, **kw):
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.optim import AdamW
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.train.trainer import Trainer
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    return Trainer(cfg, MeshAxes(), AdamW(1e-3),
                   LMDataset(cfg.vocab_size, 2, 17, device="cpu"),
                   checkpoint_dir=str(tmp_path), device="cpu",
                   log_fn=lambda _m: None, **kw)


def test_trainer_straggler_takes_an_out_of_cadence_checkpoint(tmp_path):
    """A step far slower than the trailing median is flagged, recorded in
    the ledger and checkpointed, though the cadence (100) saves nothing;
    every checkpoint is a flagged step's (a loaded host may flag
    another)."""
    ledger = Ledger(run="test")
    trainer = _smoke_trainer(
        tmp_path, ledger=ledger, restart_policy=RestartPolicy(),
        straggler=StragglerDetector(window=20, threshold=25.0))
    inner = trainer.step_fn

    def slow_at_12(params, opt_state, step, batch):
        out = inner(params, opt_state, step, batch)
        if step == 11:
            time.sleep(50 * np.median(trainer.meter.times_us) / 1e6 + 1.0)
        return out
    trainer.step_fn = slow_at_12
    trainer.run(trainer.init_state(0), 13)
    flagged = {e.measured["step"] for e in ledger.entries
               if e.kind == "fault"}
    saved = set(trainer.checkpoints.available_steps())
    assert 12 in saved and 12 in flagged and saved <= flagged
    assert all(e.extra["decision"] == "checkpoint" for e in ledger.entries
               if e.kind == "fault")


def test_launcher_resumes_from_ckpt_dir(tmp_path, monkeypatch):
    """``launch/train.py --ckpt-dir``: with a checkpoint of step 2 in the
    directory, the launch logs ``[trainer] restored step 2`` and runs
    steps 3 and 4 only."""
    import torch
    from repro_torch.launch.train import (build_parser, main, make_trainer,
                                          train_config)
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.train.trainer import Trainer
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    args = build_parser().parse_args(argv + ["--steps", "2"])
    trainer = make_trainer(MeshAxes(), torch.device("cpu"),
                           train_config(args), args)
    trainer.save_async(trainer.run(trainer.init_state(0), 2))
    trainer.checkpoints.flush()
    runs = []
    run = Trainer.run

    def spy(self, state, num_steps):
        out = run(self, state, num_steps)
        runs.append((state.step, len(self.history), out.step))
        return out
    monkeypatch.setattr(Trainer, "run", spy)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv + ["--steps", "4"]) == 0
    assert "[trainer] restored step 2" in buf.getvalue()
    assert runs == [(2, 2, 4)]
