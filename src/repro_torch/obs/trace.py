"""Context-manager span tracing, emitted as Chrome-trace-event JSON.

A ``Tracer`` records **spans** — named, categorised intervals with
stable ids — and **instants** (zero-duration markers).  The output is
the Chrome trace-event format (``{"traceEvents": [...]}``, "X"/"i"/"M"
phases), which Perfetto and ``chrome://tracing`` load directly; the
``python -m repro_torch.launch.obs`` CLI summarises and cross-checks the
same file.  The port's copy of the reference's ``obs/trace.py``: a
one-process run writes the reference's document byte for byte.

Determinism: span ids are sequence numbers assigned in emission order
(``s000000``, ``s000001``, …) and timestamps come from an injectable
``clock`` (seconds; ``time.perf_counter`` by default).  Under a
manually-advanced clock — the elastic runtime's ``VirtualClock`` — two
identical schedules produce byte-identical traces, which is what the
golden-schema tests pin.

The ledger cross-link: a span that timed a computation the energy
ledger also priced calls ``span.link_ledger(entry)``; the span's args
then carry the entry name, the measured wall fields and the predicted
joules, so the trace shows measured time AND predicted energy per span.

Module-level current tracer: deep layers (trainer, serve engine,
checkpoint worker) emit through ``get_tracer()`` so nothing needs a
tracer threaded through its signature; the default is a disabled tracer
whose spans are free no-ops.

Ranks are processes in the port (``launch/mesh.py: RankPool``): each
rank traces into a ``Tracer`` built on its parent's ``origin``
(``time.perf_counter`` is ``CLOCK_MONOTONIC`` on Linux, one clock for
every process of the host), and ``add_rank`` merges what it recorded
into the parent's document under ``pid = rank``, with a
``process_name`` of ``rank r``.  Rank 0 shares pid 0 with the parent;
span ids stay per-rank sequences, which the pid tells apart.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

TRACE_SCHEMA = "chrome-trace-event"


class Span:
    """One open (or closed) interval; mutate args via ``annotate``."""

    __slots__ = ("name", "cat", "span_id", "tid", "ts_us", "dur_us",
                 "args", "_tracer")

    def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
                 span_id: str, tid: int, ts_us: float):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.tid = tid
        self.ts_us = ts_us
        self.dur_us: Optional[float] = None
        self.args: dict = {}

    def annotate(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def link_ledger(self, entry) -> "Span":
        """Cross-link the ``LedgerEntry`` this span timed: the span
        carries the entry's name, measured wall fields and predicted
        joules, so the trace and ``BENCH_report.json`` join by name."""
        if entry is None:
            return self
        link = {"entry": entry.name, "kind": entry.kind}
        m = entry.measured or {}
        for k in ("wall_us_median", "total_s", "calls"):
            if k in m:
                link[k] = m[k]
        p = entry.predicted or {}
        for k in ("energy_j_per_iter", "energy_j_total"):
            if k in p:
                link[f"predicted_{k}"] = p[k]
        self.args["ledger"] = link
        return self

    def as_event(self) -> dict:
        ev = {"ph": "X", "name": self.name, "cat": self.cat or "misc",
              "pid": 0, "tid": self.tid,
              "ts": round(self.ts_us, 3),
              "dur": round(self.dur_us or 0.0, 3),
              "args": dict(self.args, span_id=self.span_id)}
        return ev


class _NullSpan(Span):
    """Shared no-op span handed out by a disabled tracer."""

    def __init__(self):
        super().__init__(None, "", "", "", 0, 0.0)

    def annotate(self, **kw):
        return self

    def link_ledger(self, entry):
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans/instants; writes Perfetto-loadable JSON.

    ``clock`` returns SECONDS (monotonic or virtual); event timestamps
    are microseconds relative to the tracer's construction instant.
    Thread-safe: the checkpoint writer thread and the training loop may
    emit concurrently.  Construct with ``enabled=False`` (or use the
    module default) for a zero-cost null tracer.
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True, meta: Optional[dict] = None,
                 origin: Optional[float] = None):
        self.enabled = enabled
        self.clock = clock
        self.meta = dict(meta or {})
        if origin is not None:
            self._t0 = float(origin)         # a rank on its parent's
        else:
            self._t0 = clock() if enabled else 0.0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._open: List[Span] = []          # non-lexical begin/end spans
        self._seq = 0
        self._tids: dict = {}                # thread ident -> stable tid
        self._rank_threads: dict = {}        # (pid, tid) -> thread name

    @property
    def origin(self) -> float:
        """The clock reading that timestamps count from."""
        return self._t0

    # --- internals -------------------------------------------------------

    def _now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            # stable small ints in order of first emission: the main
            # loop is tid 0, the first helper thread tid 1, ...
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _next_id(self) -> str:
        sid = f"s{self._seq:06d}"
        self._seq += 1
        return sid

    # --- emission --------------------------------------------------------

    def begin(self, name: str, cat: str = "", **args) -> Span:
        """Open a non-lexical span (close with ``end``); span ids are
        assigned at begin time, so nesting order stays deterministic."""
        if not self.enabled:
            return _NULL_SPAN
        with self._lock:
            sp = Span(self, name, cat, self._next_id(), self._tid(),
                      self._now_us())
            sp.args.update(args)
            self._open.append(sp)
        return sp

    def end(self, span: Span) -> Span:
        if not self.enabled or span is _NULL_SPAN:
            return span
        with self._lock:
            span.dur_us = max(self._now_us() - span.ts_us, 0.0)
            if span in self._open:
                self._open.remove(span)
            self._events.append(span.as_event())
        return span

    @contextmanager
    def span(self, name: str, cat: str = "", **args):
        """``with tracer.span("train/step", cat="train", step=i) as sp``
        — the workhorse API; yields the span for ``annotate`` /
        ``link_ledger``."""
        sp = self.begin(name, cat, **args)
        try:
            yield sp
        finally:
            self.end(sp)

    def instant(self, name: str, cat: str = "", **args):
        """Zero-duration marker (watchdog trips, detections, …)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "ph": "i", "name": name, "cat": cat or "misc", "pid": 0,
                "tid": self._tid(), "ts": round(self._now_us(), 3),
                "s": "t", "args": dict(args, span_id=self._next_id())})

    def add_rank(self, rank: int, events: List[dict]):
        """Merge the events a rank's tracer recorded (its ``to_chrome``
        events, timestamped from this tracer's ``origin``) under
        ``pid = rank``; its thread names come along, its process is
        named ``rank r``."""
        if not self.enabled:
            return
        with self._lock:
            self._rank_threads.setdefault((rank, None), f"rank {rank}")
            for ev in events:
                if ev.get("ph") == "M":
                    if ev.get("name") == "thread_name":
                        self._rank_threads.setdefault(
                            (rank, ev["tid"]), ev["args"]["name"])
                    continue
                self._events.append(dict(ev, pid=rank))

    # --- output ----------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The Chrome/Perfetto trace document.  Still-open spans are
        closed at the current clock so a crash dump stays loadable."""
        with self._lock:
            evs = list(self._events)
            for sp in self._open:
                ev = sp.as_event()
                ev["dur"] = round(max(self._now_us() - sp.ts_us, 0.0), 3)
                ev["args"]["unclosed"] = True
                evs.append(ev)
            procs = {0: "repro"}
            threads = {(0, tid): "main" if tid == 0 else f"worker-{tid}"
                       for tid in self._tids.values()}
            for (pid, tid), name in self._rank_threads.items():
                if tid is None:
                    procs[pid] = name
                else:
                    threads.setdefault((pid, tid), name)
            meta_evs = [{"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": name}}
                        for pid, name in sorted(procs.items())]
            for (pid, tid), name in sorted(threads.items()):
                meta_evs.append({"ph": "M", "name": "thread_name",
                                 "pid": pid, "tid": tid,
                                 "args": {"name": name}})
        return {"traceEvents": meta_evs + evs,
                "displayTimeUnit": "ms",
                "otherData": dict(self.meta, schema=TRACE_SCHEMA)}

    def write(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path

    def summary(self) -> dict:
        """Per-category span counts and summed durations (seconds) —
        what the ``obs`` CLI prints and the recovery cross-check sums."""
        out: dict = {}
        for ev in self.events():
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "misc")
            rec = out.setdefault(cat, {"spans": 0, "total_s": 0.0})
            rec["spans"] += 1
            rec["total_s"] += ev.get("dur", 0.0) * 1e-6
        return out

    def __len__(self):
        with self._lock:
            return len(self._events)


# ---------------------------------------------------------------------------
# module-level current tracer
# ---------------------------------------------------------------------------

NULL_TRACER = Tracer(enabled=False)
_CURRENT: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    return _CURRENT


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the process-wide current tracer (None
    restores the disabled default); returns the previous one."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else NULL_TRACER
    return prev


@contextmanager
def use_tracer(tracer: Tracer):
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


# ---------------------------------------------------------------------------
# reading traces back (the CLI + tests)
# ---------------------------------------------------------------------------

def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace-event document "
                         "(no traceEvents key)")
    return doc


def span_events(doc: dict, cat: Optional[str] = None,
                name_prefix: str = "") -> List[dict]:
    """The "X" events of a loaded trace, optionally filtered."""
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if cat is not None and ev.get("cat") != cat:
            continue
        if name_prefix and not ev.get("name", "").startswith(name_prefix):
            continue
        out.append(ev)
    return out
