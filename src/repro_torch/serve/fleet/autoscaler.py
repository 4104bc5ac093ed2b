"""Queue-depth / SLO-headroom autoscaling policy for the fleet pools
(the reference's ``serve/fleet/autoscaler.py``, unchanged: pure logic).

Pure decision logic — the ``FleetRouter`` owns execution (spinning
replicas up through their warmup delay, draining and retiring them) so
the policy stays unit-testable without a simulation behind it.

The policy is deliberately boring (threshold + cooldown, the shape
production autoscalers actually run):

  * **scale up** when the estimated queue wait exceeds the SLO headroom
    budget — ``queue_depth * service_s_per_item / n_active`` against
    ``headroom * slo_s`` (with no SLO, against ``default_wait_s``);
  * **scale down** when a pool has been under ``scale_down_util`` busy
    fraction for ``idle_ticks`` consecutive ticks with an empty queue —
    the router then *drains* the victim (no new work) and retires it
    once empty, so scale-down never drops tokens;
  * a per-pool ``cooldown_s`` between decisions and ``min_replicas`` /
    ``max_replicas`` clamps bound the oscillation; new replicas serve
    only after ``spinup_s`` of (virtual) warmup, which the wait
    estimate counts as capacity already ordered — no thundering herd
    of scale-ups while one is still warming.

Joules enter through sizing, not the decision: a pool scaled beyond
its load burns full-shape decode steps at low occupancy, which the
fleet's J/token report makes visible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class AutoscalePolicy:
    min_replicas: int = 1
    max_replicas: int = 4
    tick_s: float = 0.25          # policy evaluation cadence (virtual)
    headroom: float = 0.7         # fraction of the SLO the queue may eat
    default_wait_s: float = 0.5   # wait budget when no SLO is set
    scale_down_util: float = 0.35
    idle_ticks: int = 4           # low-util ticks before draining
    cooldown_s: float = 1.0       # min gap between decisions
    spinup_s: float = 0.5         # warmup before a new replica serves

    def wait_budget_s(self, slo_ms: float) -> float:
        return (self.headroom * slo_ms * 1e-3 if slo_ms
                else self.default_wait_s)


@dataclass
class ScaleEvent:
    t_s: float
    pool: str                     # "prefill" | "decode"
    action: str                   # "up" | "down"
    replicas: int                 # pool size after the decision
    reason: str

    def as_dict(self) -> dict:
        return {"t_s": self.t_s, "pool": self.pool,
                "action": self.action, "replicas": self.replicas,
                "reason": self.reason}


@dataclass
class PoolStats:
    """The autoscaler's view of one pool at a tick."""
    queue_depth: int              # items waiting for a replica
    n_active: int
    n_warming: int
    service_s_per_item: float     # replica-seconds one queued item needs
    busy_fraction: float          # busy share since the last tick


class Autoscaler:
    """Threshold policy over ``PoolStats`` ticks for one pool."""

    def __init__(self, policy: AutoscalePolicy, *, pool: str,
                 slo_ms: float = 0.0):
        self.policy = policy
        self.pool = pool
        self.slo_ms = slo_ms
        self._last_decision_s = -1e18
        self._low_util_ticks = 0
        self.events: List[ScaleEvent] = []

    def est_wait_s(self, stats: PoolStats) -> float:
        """Queue wait if today's queue drains at today's capacity —
        warming replicas count (capacity already ordered)."""
        cap = max(stats.n_active + stats.n_warming, 1)
        return stats.queue_depth * stats.service_s_per_item / cap

    def evaluate(self, now_s: float, stats: PoolStats) -> Optional[str]:
        """Return ``"up"``, ``"down"``, or ``None``; records the event.
        Clamps and cooldown are enforced here so callers just execute."""
        pol = self.policy
        n_total = stats.n_active + stats.n_warming
        if stats.busy_fraction < pol.scale_down_util \
                and not stats.queue_depth:
            self._low_util_ticks += 1
        else:
            self._low_util_ticks = 0
        if now_s - self._last_decision_s < pol.cooldown_s:
            return None
        wait = self.est_wait_s(stats)
        if wait > pol.wait_budget_s(self.slo_ms) \
                and n_total < pol.max_replicas:
            self._last_decision_s = now_s
            self._low_util_ticks = 0
            self.events.append(ScaleEvent(
                now_s, self.pool, "up", n_total + 1,
                f"est_wait={wait * 1e3:.1f}ms > "
                f"budget={pol.wait_budget_s(self.slo_ms) * 1e3:.1f}ms "
                f"(queue={stats.queue_depth})"))
            return "up"
        if self._low_util_ticks >= pol.idle_ticks \
                and stats.n_active > pol.min_replicas:
            self._last_decision_s = now_s
            self._low_util_ticks = 0
            self.events.append(ScaleEvent(
                now_s, self.pool, "down", n_total - 1,
                f"util<{pol.scale_down_util:.0%} for "
                f"{pol.idle_ticks} ticks, queue empty"))
            return "down"
        return None
