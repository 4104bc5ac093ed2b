"""The energy-drift watchdog: in-flight measured/predicted banding, the
port's copy of the reference's ``obs/watchdog.py``.

The ledger proves (after the run) that measured cost tracks the
analytic energy account; the watchdog watches the SAME ratio while the
run is still going.  Each observed step contributes

    ratio = measured_step_seconds / predicted_step_seconds

(at fixed power the step's energy is proportional to its wall time, so
a wall-time ratio IS the measured/predicted energy ratio).  When no
analytic prediction is available the watchdog self-baselines: the
median of the first ``min_samples`` steps becomes the reference, and
the ratio band becomes a drift band over the run's own healthy steady
state.

Two trip conditions:

  * **spike** — a single ratio ≥ ``spike_factor`` (a straggler step,
    a thermal event, an interfering tenant);
  * **drift** — the mean ratio over the trailing ``window`` leaves
    ``band`` (the energy model no longer predicts this run: wrong
    calibration, changed sharding, input-pipeline degradation).

A trip records an anomaly event to the energy ledger (kind
``anomaly``), marks the trace (instant event), bumps the
``obs_watchdog_trips_total`` counter — and, when a ``profile_dir`` is
configured, arms a one-shot profiler capture: the caller wraps its NEXT
step in ``watchdog.capture(fn, *args)``.  After a trip the watchdog
stays quiet for ``cooldown`` observations so a sustained stall doesn't
flood the ledger.

The port's capture is ``torch.profiler`` (CPU and CUDA activities on
the card, the CPU's alone elsewhere) in place of ``jax.profiler``: one
Chrome trace per rank, ``<profile_dir>/rank{rank}.json``.  On a mesh
of ranks rank 0 observes its own steps and its armed capture is every
rank's (``train/trainer.py: rank0_value``): ``set_capture_pending``
carries the decision to the watchdogs of the other ranks.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.trace import get_tracer


@dataclass
class WatchdogEvent:
    step: int
    kind: str                   # spike | drift
    ratio: float                # this observation's measured/predicted
    window_mean: float          # trailing-window mean ratio
    measured_s: float
    predicted_s: float

    def as_dict(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "ratio": self.ratio, "window_mean": self.window_mean,
                "measured_s": self.measured_s,
                "predicted_s": self.predicted_s}


@dataclass
class EnergyDriftWatchdog:
    """Stream per-step measured seconds; trip on spike or band drift."""

    band: tuple = (0.5, 2.0)        # windowed-mean drift band
    spike_factor: float = 3.0       # single-step trip threshold
    window: int = 8
    min_samples: int = 5            # self-baseline sample count
    cooldown: int = 20              # observations muted after a trip
    predicted_s: Optional[float] = None   # analytic step seconds; None
                                          # = self-baseline
    profile_dir: Optional[str] = None
    ledger: Optional[object] = None
    name: str = "watchdog"
    arch: str = ""
    impl: str = ""
    p: int = 0
    rank: int = 0                   # names the capture: rank{rank}.json

    trips: List[WatchdogEvent] = field(default_factory=list)
    captures: List[str] = field(default_factory=list)
    _ratios: List[float] = field(default_factory=list, repr=False)
    _baseline: List[float] = field(default_factory=list, repr=False)
    _mute_until: int = field(default=0, repr=False)
    _obs: int = field(default=0, repr=False)
    _capture_armed: bool = field(default=False, repr=False)

    # --- observation -----------------------------------------------------

    def reference_s(self) -> Optional[float]:
        """The predicted step seconds ratios are taken against."""
        if self.predicted_s:
            return float(self.predicted_s)
        if len(self._baseline) >= self.min_samples:
            return float(np.median(self._baseline))
        return None

    def observe(self, step: int, measured_s: float,
                predicted_s: Optional[float] = None
                ) -> Optional[WatchdogEvent]:
        """Record one step; returns the trip event if this observation
        tripped the watchdog, else None."""
        self._obs += 1
        if predicted_s:
            self.predicted_s = float(predicted_s)
        ref = self.reference_s()
        if ref is None:
            # still collecting the self-baseline
            self._baseline.append(float(measured_s))
            return None
        ratio = float(measured_s) / ref
        self._ratios.append(ratio)
        tail = self._ratios[-self.window:]
        mean = float(np.mean(tail))
        get_metrics().gauge(
            "obs_energy_ratio",
            "trailing-window measured/predicted step ratio").set(
                mean, name=self.name)
        if self._obs < self._mute_until:
            return None
        kind = None
        if ratio >= self.spike_factor:
            kind = "spike"
        elif len(tail) >= self.window and \
                not (self.band[0] <= mean <= self.band[1]):
            kind = "drift"
        if kind is None:
            return None
        ev = WatchdogEvent(step=step, kind=kind, ratio=ratio,
                           window_mean=mean, measured_s=float(measured_s),
                           predicted_s=ref)
        self._trip(ev)
        return ev

    # --- trip actions ----------------------------------------------------

    def _trip(self, ev: WatchdogEvent):
        self.trips.append(ev)
        self._mute_until = self._obs + self.cooldown
        if self.profile_dir:
            self._capture_armed = True
        get_metrics().counter(
            "obs_watchdog_trips_total",
            "energy-drift watchdog anomaly trips").inc(kind=ev.kind)
        get_tracer().instant(
            f"watchdog/{ev.kind}", cat="watchdog", **ev.as_dict())
        if self.ledger is not None:
            from repro_torch.telemetry import LedgerEntry
            self.ledger.record(LedgerEntry(
                name=f"{self.name}_step{ev.step}", suite="obs",
                kind="anomaly", arch=self.arch, impl=self.impl, p=self.p,
                measured={"step": ev.step, "dt_s": ev.measured_s,
                          "ratio": ev.ratio,
                          "window_mean": ev.window_mean},
                predicted={"dt_s": ev.predicted_s},
                extra={"event": f"watchdog_{ev.kind}",
                       "band": list(self.band),
                       "spike_factor": self.spike_factor,
                       "window": self.window,
                       "profile_armed": bool(self.profile_dir)}))

    # --- on-demand profiler capture --------------------------------------

    def capture_pending(self) -> bool:
        return self._capture_armed

    def set_capture_pending(self, armed: bool):
        """Arm (or disarm) the next step's capture on this rank's
        watchdog: rank 0's decision, carried to every rank, since the
        ranks run that step together."""
        self._capture_armed = bool(armed and self.profile_dir)

    def capture(self, fn, *args, **kwargs):
        """Run ``fn(*args)`` under a one-shot ``torch.profiler`` capture
        when a trip armed one, writing the Chrome trace
        ``rank{rank}.json`` under ``profile_dir``; otherwise just call
        it.  Capture failures never break the step — the artifact is
        best-effort."""
        if not self._capture_armed:
            return fn(*args, **kwargs)
        self._capture_armed = False
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = None
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as exc:       # profiler unavailable/busy
            prof = None
            get_tracer().instant("watchdog/capture_failed",
                                 cat="watchdog", error=str(exc))
        try:
            return fn(*args, **kwargs)
        finally:
            if prof is not None:
                try:
                    if torch.profiler.ProfilerActivity.CUDA in acts:
                        torch.cuda.synchronize()
                    prof.stop()
                    os.makedirs(self.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        self.profile_dir, f"rank{self.rank}.json"))
                    self.captures.append(self.profile_dir)
                    get_tracer().instant("watchdog/capture",
                                         cat="watchdog",
                                         dir=self.profile_dir)
                except Exception as exc:
                    get_tracer().instant("watchdog/capture_failed",
                                         cat="watchdog", error=str(exc))

    def summary(self) -> dict:
        return {"observations": self._obs, "trips":
                [t.as_dict() for t in self.trips],
                "captures": list(self.captures),
                "reference_s": self.reference_s(),
                "band": list(self.band),
                "spike_factor": self.spike_factor}
