"""Fault tolerance and elasticity: the port's copy of the reference's
``train/fault.py`` (host only, no torch).

1. **Checkpoint/restart**: ``train/checkpoint.py: CheckpointManager``
   (atomic commits, ``latest`` always complete, the corrupt-checkpoint
   fallback, asynchronous writes flushed at exit).  The trainer saves
   every N steps; ``Trainer.restore_or_init`` resumes from the latest.
2. **Failure detection**: ``Heartbeat``, a per-host beat file with an
   injected clock; the monitor declares a host dead ``timeout_s`` after
   its last beat.  ``SimulatedCluster`` drives it in one process, on a
   ``VirtualClock`` with ``virtual=True``, so a fault's detection lag is
   a pure function of the beats.
3. **Straggler mitigation**: ``StragglerDetector`` flags a step slower
   than ``threshold`` x the trailing median; ``note_step_time`` is the
   hook every metered loop calls (``Trainer``, the elastic runner): a
   flagged step becomes a ledger event (kind ``fault``) and the
   ``RestartPolicy``'s decision, checkpoint-now by default, counted in
   ``straggler_events_total`` and marked by a ``fault/straggler``
   instant.
4. **Elastic rescale**: ``FaultScript`` injects scripted host losses;
   ``train/elastic.py`` re-plans dp x tp x k over the survivors.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class VirtualClock:
    """Manually-advanced clock for deterministic fault tests."""

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


class Heartbeat:
    """File-based heartbeat registry (stand-in for etcd or a coordination
    service's key-value store).  ``clock`` is injectable (``VirtualClock``
    in tests), so liveness is a pure function of the recorded beats."""

    def __init__(self, directory: str, host_id: str, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        self.dir = directory
        self.host_id = host_id
        self.timeout_s = timeout_s
        self.clock = clock
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int):
        path = os.path.join(self.dir, f"{self.host_id}.hb")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": self.clock(), "step": step}, f)
        os.replace(tmp, path)

    def alive_hosts(self) -> Dict[str, dict]:
        now = self.clock()
        out = {}
        for name in os.listdir(self.dir):
            if not name.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    rec = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue
            if now - rec["t"] <= self.timeout_s:
                out[name[:-3]] = rec
        return out

    def dead_hosts(self, expected: List[str]) -> List[str]:
        alive = self.alive_hosts()
        return [h for h in expected if h not in alive]


@dataclass
class StragglerDetector:
    """Flags steps slower than ``threshold`` x the trailing median."""
    window: int = 50
    threshold: float = 2.0
    _times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        hist = self._times[-self.window:]
        is_straggler = False
        if len(hist) >= 10:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.threshold * med:
                is_straggler = True
                self.flagged.append((step, dt, med))
        self._times.append(dt)
        return is_straggler


@dataclass
class RestartPolicy:
    """What the monitor does when a failure or a straggler fires."""
    max_restarts: int = 100
    checkpoint_on_straggler: bool = True
    restarts: int = 0

    def on_host_failure(self, dead: List[str], trainer) -> str:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return "abort"
        return "restore"

    def on_straggler(self, step: int, dt: float,
                     median: Optional[float] = None) -> str:
        """A straggler is a warning, not a failure: it does not consume
        the restart budget.  Checkpoint-now (the default) banks a restore
        point while the run is still healthy enough to produce one."""
        return "checkpoint" if self.checkpoint_on_straggler else "log"


def note_step_time(detector: Optional[StragglerDetector],
                   policy: Optional[RestartPolicy], step: int, dt_s: float,
                   ledger=None, *, name: str = "straggler", arch: str = "",
                   impl: str = "", p: int = 0) -> Optional[str]:
    """The metered loop's straggler hook (``Trainer``, the elastic
    runner).  Records the step time; when the detector flags a
    straggler, records a ledger event (kind ``fault``) and returns the
    policy's decision (``checkpoint`` | ``log``) for the caller to act
    on.  Returns None on healthy steps or without a detector."""
    if detector is None or not detector.record(step, dt_s):
        return None
    _, _, median = detector.flagged[-1]
    decision = (policy.on_straggler(step, dt_s, median)
                if policy is not None else "log")
    from repro_torch.obs import get_metrics, get_tracer
    get_metrics().counter(
        "straggler_events_total",
        "steps flagged slower than threshold x trailing median").inc(
            decision=decision)
    get_tracer().instant(
        "fault/straggler", cat="fault", step=step, dt_s=dt_s,
        median_s=median, decision=decision)
    if ledger is not None:
        from repro_torch.telemetry import LedgerEntry
        ledger.record(LedgerEntry(
            name=f"{name}_step{step}", suite="fault", kind="fault",
            arch=arch, impl=impl, p=p,
            measured={"step": step, "dt_s": dt_s, "median_s": median,
                      "slowdown": dt_s / median if median else 0.0},
            extra={"event": "straggler", "decision": decision,
                   "threshold": detector.threshold}))
    return decision


@dataclass(frozen=True)
class FaultScript:
    """Deterministic device-loss injection: ``kills`` is a tuple of
    ``(step, host)`` pairs; at the start of ``step``, ``host`` stops
    heartbeating.  The monitor detects the loss once the heartbeat
    timeout has elapsed (on the virtual clock, timeout_s / dt ticks
    later): the detection lag a real deployment pays."""
    kills: Tuple[Tuple[int, str], ...] = ()

    def hosts_at(self, step: int) -> List[str]:
        return [h for s, h in self.kills if s == step]

    @property
    def kill_steps(self) -> List[int]:
        return sorted({s for s, _ in self.kills})


class SimulatedCluster:
    """The fault path in one process: N simulated hosts heartbeat, and a
    killed one stops.  ``virtual=True`` gives every heartbeat one
    ``VirtualClock``: ``advance(dt)`` moves simulated time, so a killed
    host's staleness (hence the detection lag) is deterministic."""

    def __init__(self, tmpdir: str, hosts: int = 4, timeout_s: float = 0.5,
                 virtual: bool = False):
        self.clock: Callable[[], float] = (VirtualClock() if virtual
                                           else time.time)
        self.hosts = [f"host{i}" for i in range(hosts)]
        self.hbs = {h: Heartbeat(tmpdir, h, timeout_s, clock=self.clock)
                    for h in self.hosts}
        self.monitor = Heartbeat(tmpdir, "monitor", timeout_s,
                                 clock=self.clock)
        self.killed = set()

    def tick(self, step: int):
        for h, hb in self.hbs.items():
            if h not in self.killed:
                hb.beat(step)

    def advance(self, dt: float):
        if isinstance(self.clock, VirtualClock):
            self.clock.advance(dt)

    def kill(self, host: str):
        self.killed.add(host)

    def check(self) -> List[str]:
        return self.monitor.dead_hosts(self.hosts)
