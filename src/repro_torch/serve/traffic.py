"""Synthetic serving workloads and the SLO report.

``make_trace`` draws a reproducible request trace — Poisson or bursty
(two-state modulated Poisson) arrivals, lognormal or uniform prompt and
output length distributions — entirely from one ``RandomState`` seed,
so a trace name + seed identifies the workload exactly (the serve bench
replays the same trace through every candidate config).

``SLOTracker`` turns per-request timestamps the engine stamps (submit,
first token, done — on the engine's virtual clock) into the serving
report: TTFT / TPOT / e2e p50/p95/p99, throughput, and goodput under
deadline (the fraction of requests that finished within their own
deadline AND met the global TTFT SLO, weighted by generated tokens —
tokens delivered late count for nothing).

``replay`` drives an engine through a trace against the engine's
virtual clock: requests become visible to the scheduler only once the
clock passes their arrival time, and the clock advances by the measured
wall time of each engine step (scaled by ``speedup`` so a "60 s @ 2
rps" trace replays in CPU-test time).  On a mesh every rank replays the
same trace through its engine; the engines agree their clocks, so every
rank admits the same arrivals at the same step.

The port of the reference's ``serve/traffic.py``: the same draws from
the same seeds, the same report, which also feeds the process-wide
metrics registry (``obs/``: the TTFT and TPOT histograms, the goodput
gauge).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

TRACE_KINDS = ("poisson", "bursty", "closed")


@dataclass(frozen=True)
class TraceItem:
    """One request of a workload trace (lengths only — prompts are
    materialized per-arch by ``trace_requests``)."""
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    deadline_ms: float = 0.0     # e2e deadline; 0 = none
    seed: int = 0                # per-request sampling seed


def make_trace(kind: str = "poisson", *, n: int = 32,
               rate_rps: float = 4.0, burst_factor: float = 8.0,
               burst_fraction: float = 0.25,
               prompt_len_range=(4, 48), prompt_len_dist: str = "lognormal",
               new_tokens_range=(4, 24), deadline_ms: float = 0.0,
               max_requests: int = 0, seed: int = 0) -> List[TraceItem]:
    """Draw ``n`` requests.  ``bursty`` alternates between a quiet
    Poisson phase at ``rate_rps`` and bursts at ``burst_factor x`` the
    rate (``burst_fraction`` of requests arrive in bursts); ``closed``
    is the degenerate all-at-once trace (arrival 0) the old launcher
    effectively ran.

    ``max_requests`` truncates the trace WITHOUT changing the draw: the
    length/output arrays are still drawn at size ``n``, so
    ``make_trace(n=N, max_requests=M)`` is exactly the first ``M`` items
    of ``make_trace(n=N)`` (a prefix, seeded-deterministic — the
    property the fleet's trace-capping relies on).  Note this is NOT
    ``make_trace(n=M)``, whose vectorized draws differ."""
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"known: {TRACE_KINDS}")
    rng = np.random.RandomState(seed)
    lo, hi = prompt_len_range
    if prompt_len_dist == "lognormal":
        # median near the geometric middle of the range, clipped
        mu = np.log(np.sqrt(max(lo, 1) * hi))
        lens = np.clip(np.round(rng.lognormal(mu, 0.6, n)), lo, hi)
    elif prompt_len_dist == "uniform":
        lens = rng.randint(lo, hi + 1, n)
    elif prompt_len_dist == "fixed":
        lens = np.full(n, hi)
    else:
        raise ValueError(f"unknown prompt_len_dist {prompt_len_dist!r}")
    news = rng.randint(new_tokens_range[0], new_tokens_range[1] + 1, n)

    t = 0.0
    items = []
    stop = min(n, max_requests) if max_requests else n
    for i in range(stop):
        if kind == "closed":
            gap = 0.0
        elif kind == "bursty" and rng.rand() < burst_fraction:
            gap = rng.exponential(1.0 / (rate_rps * burst_factor))
        else:
            gap = rng.exponential(1.0 / rate_rps)
        t += gap
        items.append(TraceItem(
            arrival_s=round(t, 6), prompt_len=int(lens[i]),
            max_new_tokens=int(news[i]), deadline_ms=deadline_ms,
            seed=int(rng.randint(0, 2 ** 31 - 1))))
    return items


def trace_requests(trace: Sequence[TraceItem], vocab_size: int, *,
                   seed: int = 0, sampling=None):
    """Materialize engine ``Request``s for a trace: prompt token ids are
    drawn from one ``RandomState(seed)`` stream in trace order, so the
    same (trace, seed, vocab) produces identical prompts in every
    config replayed by the bench."""
    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(seed)
    reqs = []
    for i, it in enumerate(trace):
        prompt = rng.randint(0, vocab_size, it.prompt_len).astype(np.int32)
        kw = {}
        if sampling is not None:
            from dataclasses import replace as dc_replace
            kw["sampling"] = dc_replace(sampling, seed=it.seed)
        reqs.append(Request(prompt=prompt, max_new_tokens=it.max_new_tokens,
                            req_id=i, arrival_s=it.arrival_s,
                            deadline_ms=it.deadline_ms, **kw))
    return reqs


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------

def _pcts(xs: List[float]) -> dict:
    if not xs:
        return {}
    a = np.asarray(xs)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(np.mean(a)), "max": float(np.max(a))}


@dataclass
class SLOTracker:
    """Aggregates finished requests into the serving SLO report."""

    slo_ttft_ms: float = 0.0        # 0 = no TTFT SLO
    finished: list = field(default_factory=list)

    def observe(self, req):
        if req.t_done_s is not None:
            self.finished.append(req)

    def observe_all(self, requests):
        for r in requests:
            self.observe(r)

    def report(self) -> dict:
        from repro_torch.obs import get_metrics
        mx = get_metrics()
        # serving latencies are milliseconds; default buckets top out
        # at 10 so spread explicit ms buckets instead
        ms_buckets = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                      2500, 5000, 10000)
        ttft_h = mx.histogram("serve_ttft_ms",
                              "time to first token (ms)",
                              buckets=ms_buckets)
        tpot_h = mx.histogram("serve_tpot_ms",
                              "time per output token (ms)",
                              buckets=ms_buckets)
        ttft, tpot, e2e = [], [], []
        good_tokens = total_tokens = 0
        met = 0
        last_done = 0.0
        for r in self.finished:
            n = len(r.out_tokens)
            total_tokens += n
            t_ttft = (r.t_first_s - r.arrival_s) * 1e3
            t_e2e = (r.t_done_s - r.arrival_s) * 1e3
            ttft.append(t_ttft)
            ttft_h.observe(t_ttft)
            e2e.append(t_e2e)
            if n > 1:
                t_tpot = (r.t_done_s - r.t_first_s) * 1e3 / (n - 1)
                tpot.append(t_tpot)
                tpot_h.observe(t_tpot)
            last_done = max(last_done, r.t_done_s)
            ok = (not self.slo_ttft_ms or t_ttft <= self.slo_ttft_ms) and \
                 (not r.deadline_ms or t_e2e <= r.deadline_ms)
            if ok:
                met += 1
                good_tokens += n
        out = {
            "requests": len(self.finished),
            "generated_tokens": total_tokens,
            "ttft_ms": _pcts(ttft),
            "tpot_ms": _pcts(tpot),
            "e2e_ms": _pcts(e2e),
            "slo_ttft_ms": self.slo_ttft_ms,
            "slo_met_fraction": (met / len(self.finished)
                                 if self.finished else 0.0),
            "goodput_tokens": good_tokens,
        }
        if last_done > 0:
            out["duration_s"] = last_done
            out["tokens_per_s"] = total_tokens / last_done
            out["goodput_tokens_per_s"] = good_tokens / last_done
            mx.gauge("serve_goodput_tokens_per_s",
                     "deadline+TTFT-qualified tokens per second").set(
                         out["goodput_tokens_per_s"])
        mx.gauge("serve_slo_met_fraction",
                 "fraction of requests meeting their SLOs").set(
                     out["slo_met_fraction"])
        return out


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

def replay(engine, requests, *, tracker: Optional[SLOTracker] = None,
           speedup: float = 1.0, max_steps: int = 100_000) -> SLOTracker:
    """Open-loop replay: feed ``requests`` to ``engine`` as the engine's
    virtual clock (wall time of executed steps x ``speedup``) passes
    each arrival time; decode until everything finishes."""
    tracker = tracker or SLOTracker()
    pending = sorted(requests, key=lambda r: r.arrival_s)
    engine.clock_scale = speedup
    steps = 0
    while (pending or engine.has_active()) and steps < max_steps:
        ready = []
        while pending and pending[0].arrival_s <= engine.now_s:
            ready.append(pending.pop(0))
        if ready:
            # one submit for every ready arrival, so simultaneous
            # arrivals land in one length-bucketed prefill group
            engine.submit(ready)
        if not engine.has_active():
            if pending:
                # idle gap: jump the clock to the next arrival
                engine.advance_clock(pending[0].arrival_s - engine.now_s)
            continue
        engine.step()
        steps += 1
    tracker.observe_all(requests)
    return tracker
