"""The measured-vs-predicted energy ledger: the port's own copy of the
JAX package's ``telemetry/ledger.py`` (stdlib only), same schema
``bench-ledger/v1``, so a report from either package loads in the other.

One ``LedgerEntry`` per metered step or benchmark row, holding up to
three views of the same computation:

  * ``measured``  — wall time from a ``StepMeter`` and/or the counted
    costs of a step (``telemetry/counted.py``: flops from
    ``FlopCounterMode``, wire bytes from the collective log)
  * ``predicted`` — the analytic account from ``strategy_prediction``
    (the same ``ProjectionStrategy`` objects that executed, priced by
    the paper's Eqn. 26 comm model and E = ν·p·(A·α + B·β))
  * ``ratios``    — measured/predicted for every key present in both,
    computed at serialization time.  A ratio near 1.0 means the analytic
    energy model is accounting for the operators that actually ran; a
    drift is a model bug or an unmodeled operator.

``Ledger`` collects entries (optionally streaming each to a JSONL file
as it is recorded) and writes the aggregate report to the path its
caller gives: the port's reports go under ``build/`` (``REPORT_DIR``),
and the repo-root ``BENCH_report.json``, the JAX package's, is refused.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import time
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

SCHEMA = "bench-ledger/v1"

_ROOT = Path(__file__).resolve().parents[3]    # the checkout
REPORT_DIR = _ROOT / "build"
_REFERENCE_REPORT = _ROOT / "BENCH_report.json"

# all live ledgers, flushed once at interpreter exit so JSONL tails
# (and a configured report) survive crashes/interrupts — the same
# guarantee CheckpointManager gives queued saves
_LEDGERS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _flush_all_ledgers():
    for led in list(_LEDGERS):
        try:
            led.close()
        except Exception:
            pass

# measured keys ratioed against same-named predicted keys
_RATIO_KEYS = (
    "flops_per_device",
    "hbm_bytes_per_device",
    "collective_wire_bytes_per_device",
    "boundary_wire_bytes_per_device",   # pipeline stage-boundary p2p
    "transfer_wire_bytes",              # fleet prefill->decode KV pages
    "migrations",                       # fleet KV-page migration count
    "collective_m_floats",
    "energy_j_per_iter",
    "iterations",
)


@dataclass
class LedgerEntry:
    name: str                          # unique row id, e.g. fig5a_hlo_wire
    suite: str = ""                    # producing subsystem/suite
    kind: str = "step"                 # train|prefill|decode|collective|
                                       # analytic|step
    arch: str = ""                     # model/config name
    impl: str = ""                     # tensor_col|phantom|dense|...
    p: int = 0                         # parallel width (model axis)
    measured: Optional[dict] = None
    predicted: Optional[dict] = None
    extra: dict = field(default_factory=dict)

    def ratios(self) -> dict:
        """measured/predicted for the curated ``_RATIO_KEYS`` present in
        both dicts — only keys where the two sides measure the SAME
        quantity."""
        if not self.measured or not self.predicted:
            return {}
        out = {}
        for key in _RATIO_KEYS:
            m, pr = self.measured.get(key), self.predicted.get(key)
            if isinstance(m, (int, float)) and isinstance(pr, (int, float)) \
                    and pr:
                out[key] = m / pr
        return out

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ratios"] = self.ratios()
        return {k: v for k, v in d.items() if v not in (None, {}, "")}


class Ledger:
    """Collects LedgerEntry rows; one instance per process/run.

    Tail-write guarantees: the JSONL stream is held open and flushed
    after every row, ``close()`` (idempotent; also the context-manager
    exit and an atexit hook) fsyncs the tail and writes the aggregate
    report when ``report_path`` is configured — so a crash or interrupt
    mid-run loses at most the row being serialized, never the stream.
    """

    def __init__(self, run: str = "", jsonl_path: Optional[str] = None,
                 meta: Optional[dict] = None,
                 report_path: Optional[str] = None):
        self.run = run
        self.meta = dict(meta or {})
        self.entries: List[LedgerEntry] = []
        self.suite_status: dict = {}       # suite -> ok|failed: <error>
        self._jsonl_path = jsonl_path
        self.report_path = report_path
        self._jsonl_f = None
        self._closed = False
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            # truncate: one JSONL stream per run; the handle stays open
            # (line-flushed per record) so tails survive interrupts
            self._jsonl_f = open(jsonl_path, "w")
        _LEDGERS.add(self)

    # --- recording -------------------------------------------------------
    def record(self, entry: LedgerEntry) -> LedgerEntry:
        self.entries.append(entry)
        if self._jsonl_path:
            if self._jsonl_f is None or self._jsonl_f.closed:
                self._jsonl_f = open(self._jsonl_path, "a")
                self._closed = False    # re-arm close() for the new tail
            self._jsonl_f.write(json.dumps(entry.as_dict()) + "\n")
            self._jsonl_f.flush()
        return entry

    # --- durability ------------------------------------------------------
    def flush(self):
        """Push the JSONL tail to the OS and fsync it to disk."""
        if self._jsonl_f is not None and not self._jsonl_f.closed:
            self._jsonl_f.flush()
            try:
                os.fsync(self._jsonl_f.fileno())
            except OSError:
                pass

    def close(self):
        """Flush + close the stream; write ``report_path`` if set.
        Idempotent — safe from finally-paths AND the atexit sweep."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self._jsonl_f is not None and not self._jsonl_f.closed:
            self._jsonl_f.close()
        if self.report_path:
            self.write_report(self.report_path)

    def __enter__(self) -> "Ledger":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def entry(self, name: str, **kw) -> LedgerEntry:
        return self.record(LedgerEntry(name=name, **kw))

    def suite_ok(self, suite: str, seconds: float = 0.0):
        self.suite_status[suite] = {"status": "ok", "seconds": seconds}

    def suite_failed(self, suite: str, error: str, seconds: float = 0.0):
        self.suite_status[suite] = {"status": "failed", "error": error,
                                    "seconds": seconds}

    # --- reporting -------------------------------------------------------
    def joined(self) -> List[LedgerEntry]:
        """Entries whose measured and predicted accounts share at least
        one ratio-able key — the rows that falsify (or confirm) the
        energy model."""
        return [e for e in self.entries if e.ratios()]

    def report(self) -> dict:
        entries = [e.as_dict() for e in self.entries]
        n_joined = len(self.joined())
        return {
            "schema": SCHEMA,
            "run": self.run,
            "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()),
            "meta": self.meta,
            "suites": self.suite_status,
            "counts": {"entries": len(entries), "joined": n_joined},
            "entries": entries,
        }

    def write_report(self, path) -> str:
        """Write the report to ``path`` (its directory made first); the
        JAX package's repo-root report is refused."""
        path = Path(path).resolve()
        if path == _REFERENCE_REPORT:
            raise ValueError(f"{path} is the JAX package's report; the port "
                             f"writes its own under {REPORT_DIR}")
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)
        return str(path)

    def __len__(self):
        return len(self.entries)

    def __repr__(self):
        return (f"Ledger(run={self.run!r}, entries={len(self.entries)}, "
                f"joined={len(self.joined())})")


def load_report(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unknown ledger schema "
                         f"{rec.get('schema')!r} (want {SCHEMA})")
    return rec
