"""Counters, gauges and histograms with Prometheus + JSONL export: the
port's copy of the reference's ``obs/metrics.py``, whose output it
reproduces byte for byte.

A ``MetricsRegistry`` owns named metrics; the runtime layers (trainer,
pipeline, elastic, fault, serve, planner) register and update them
through the module-level default registry, and the launchers export the
final state via ``--metrics-out`` — Prometheus text exposition format
for ``.prom``/``.txt`` paths, one JSON snapshot line appended for
``.jsonl`` (a scrape-less stand-in for a pushgateway).

Thread-safe: one lock per registry covers registration and every
update (the checkpoint writer thread and the step loop both record).
Metric and label names follow Prometheus conventions (base units in
the name: ``_seconds``, ``_total``); the reference's
docs/observability.md lists every metric.

Ranks are processes in the port: each rank records into a registry of
its own, ``dump()`` carries its raw state to the parent
(``launch/mesh.py: RankPool``), and ``absorb`` adds it to the parent's
(``obs/ranks.py``).
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

SNAPSHOT_SCHEMA = "obs-metrics/v1"

_DEF_BUCKETS = (.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1.0,
                2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._reg = registry

    def _lock(self):
        return self._reg._lock


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, registry):
        super().__init__(name, help, registry)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1.0, **labels):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _labelkey(labels)
        with self._lock():
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock():
            return self._values.get(_labelkey(labels), 0.0)

    def expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in sorted(self._values.items())]

    def snapshot(self) -> dict:
        return {_fmt_labels(k) or "": v
                for k, v in sorted(self._values.items())}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, registry):
        super().__init__(name, help, registry)
        self._values: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels):
        with self._lock():
            self._values[_labelkey(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels):
        key = _labelkey(labels)
        with self._lock():
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock():
            return self._values.get(_labelkey(labels), 0.0)

    expose = Counter.expose
    snapshot = Counter.snapshot


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, registry,
                 buckets: Sequence[float] = _DEF_BUCKETS):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: no buckets")
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, v: float, **labels):
        key = _labelkey(labels)
        with self._lock():
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + float(v)
            self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock():
            return self._n.get(_labelkey(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock():
            return self._sum.get(_labelkey(labels), 0.0)

    def expose(self) -> List[str]:
        out = []
        for key in sorted(self._counts):
            cum = 0
            for b, c in zip(self.buckets, self._counts[key]):
                cum += c
                lk = _fmt_labels(key + (("le", _fmt_value(b)),))
                out.append(f"{self.name}_bucket{lk} {cum}")
            cum += self._counts[key][-1]
            lk = _fmt_labels(key + (("le", "+Inf"),))
            out.append(f"{self.name}_bucket{lk} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} "
                       f"{_fmt_value(self._sum[key])}")
            out.append(f"{self.name}_count{_fmt_labels(key)} "
                       f"{self._n[key]}")
        return out

    def snapshot(self) -> dict:
        return {_fmt_labels(k) or "": {
                    "count": self._n[k], "sum": self._sum[k],
                    "buckets": dict(zip(
                        [_fmt_value(b) for b in self.buckets]
                        + ["+Inf"], self._counts[k]))}
                for k in sorted(self._counts)}


class MetricsRegistry:
    """Named metrics; registration is idempotent (same name + same
    kind returns the existing instance — the wiring helpers in every
    subsystem can therefore register at call sites)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if not isinstance(got, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{got.kind}, not {cls.kind}")
                return got
            m = cls(name, help, self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = _DEF_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    # --- export ----------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self, meta: Optional[dict] = None) -> dict:
        with self._lock:
            return {"schema": SNAPSHOT_SCHEMA,
                    "meta": dict(meta or {}),
                    "metrics": {name: {"kind": m.kind,
                                       "values": m.snapshot()}
                                for name, m in
                                sorted(self._metrics.items())}}

    def write(self, path: str, meta: Optional[dict] = None) -> str:
        """``.jsonl`` appends one snapshot line (timestamped); anything
        else writes/overwrites Prometheus text exposition format."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if path.endswith(".jsonl"):
            snap = self.snapshot(meta=dict(meta or {},
                                           unix_time=time.time()))
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        else:
            with open(path, "w") as f:
                f.write(self.to_prometheus())
        return path

    def reset(self):
        with self._lock:
            self._metrics.clear()

    # --- ranks as processes -----------------------------------------------

    def dump(self) -> list:
        """Every metric's kind, name, help, buckets and raw values by
        label key: what a rank sends its parent (picklable)."""
        out = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Histogram):
                    vals = {k: (list(c), m._sum[k], m._n[k])
                            for k, c in m._counts.items()}
                    out.append((m.kind, name, m.help, m.buckets, vals))
                else:
                    out.append((m.kind, name, m.help, None,
                                dict(m._values)))
        return out

    def absorb(self, dump: list) -> "MetricsRegistry":
        """Add another registry's ``dump`` into this one: counters and
        histograms add, a gauge takes the dumped value."""
        for kind, name, help, buckets, vals in dump:
            if kind == "histogram":
                h = self.histogram(name, help, buckets=buckets)
                with self._lock:
                    for k, (counts, total, n) in vals.items():
                        mine = h._counts.setdefault(
                            k, [0] * (len(h.buckets) + 1))
                        for i, c in enumerate(counts):
                            mine[i] += c
                        h._sum[k] = h._sum.get(k, 0.0) + total
                        h._n[k] = h._n.get(k, 0) + n
                continue
            m = (self.counter if kind == "counter" else self.gauge)(name,
                                                                    help)
            with self._lock:
                for k, v in vals.items():
                    m._values[k] = (m._values.get(k, 0.0) + v
                                    if kind == "counter" else v)
        return self


# ---------------------------------------------------------------------------
# module-level default registry
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _DEFAULT


def set_metrics(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install a fresh registry (None -> a new empty one); returns the
    previous.  Launchers swap one in so ``--metrics-out`` exports only
    this run's metrics."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = reg if reg is not None else MetricsRegistry()
    return prev
