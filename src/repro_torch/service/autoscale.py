"""Replica autoscaling from queue-depth and tail-latency signals.

A copy of ``repro/service/autoscale.py`` (framework-free).

The paper sizes its PIM fleet offline from the load balancer's cost
model; an online service can't — traffic skew drifts, so the replica
count has to follow the measured signals the serving runtime already
collects.  :class:`Autoscaler` is the pure decision core: feed it a
:class:`ScaleSignals` snapshot between batches and it answers with a
target replica count inside ``[min_replicas, max_replicas]``.

Policy (deliberately boring — hysteresis over two signals):

  * scale **up** one replica when the fleet's mean queue depth per live
    replica exceeds ``queue_high`` — queues are the leading indicator
    (they grow before p99 does) — or when recent p99 exceeds
    ``p99_budget_s`` (the lagging SLO indicator, optional);
  * scale **down** one replica when mean depth per replica falls below
    ``queue_low`` AND p99 (when budgeted) has margin — never shed
    capacity on a queue that is merely briefly empty: ``cooldown``
    decisions must pass between *any* two scale events, which also damps
    grow/shrink flapping around a threshold.

Scaling is one step per decision: replica construction is expensive
(engine build + bucket warmup), and single-step moves keep the
neighbor-set invariance trivially auditable — the service grows/shrinks
the *tail* of the replica list, and every replica serves identical
results by construction.

The autoscaler never touches replicas itself; ``AnnService`` applies the
decision (``scale_to``) between batches so no in-flight batch ever sees
the fleet change under it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """One between-batches snapshot of the fleet's load signals."""
    queue_depths: Sequence[int]          # per live replica
    p99_s: Optional[float] = None        # recent-window p99 (None: no data)
    open_breakers: int = 0               # replicas tripped open (no traffic)
    open_mask: Optional[Sequence[bool]] = None   # per-replica breaker open

    @property
    def mean_depth(self) -> float:
        # an open-breaker replica serves nothing: both its (stale) queue
        # depth and its headcount must leave the per-serving-replica
        # mean, else the stale numerator inflates it and triggers
        # spurious scale-up on top of the explicit lost_capacity grow
        qs = list(self.queue_depths)
        if not qs:
            return 0.0
        if self.open_mask is not None and len(self.open_mask) == len(qs):
            qs = [q for q, is_open in zip(qs, self.open_mask)
                  if not is_open]
            return (sum(qs) / len(qs)) if qs else 0.0
        # legacy callers (count only): shrink the denominator, keep the
        # full sum — the best available without knowing which are open
        n = max(len(qs) - self.open_breakers, 1)
        return sum(qs) / n


@dataclasses.dataclass
class ScaleEvent:
    """Audit record of one applied decision (exported via stats)."""
    decision: int                        # +1 grow, -1 shrink
    n_before: int
    n_after: int
    mean_depth: float
    p99_s: Optional[float]


class Autoscaler:
    """Hysteresis controller: signals snapshot -> target replica count."""

    def __init__(self, min_replicas: int, max_replicas: int, *,
                 queue_high: float = 4.0, queue_low: float = 0.5,
                 p99_budget_s: Optional[float] = None,
                 cooldown: int = 8):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas ({max_replicas}) must be >= "
                             f"min_replicas ({min_replicas})")
        if queue_low >= queue_high:
            raise ValueError(f"queue_low ({queue_low}) must be < "
                             f"queue_high ({queue_high})")
        if p99_budget_s is not None and p99_budget_s <= 0:
            raise ValueError("p99_budget_s must be positive or None")
        if cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.p99_budget_s = p99_budget_s
        self.cooldown = int(cooldown)
        self._since_last_event = cooldown     # first decision is live
        self.events: List[ScaleEvent] = []

    def decide(self, signals: ScaleSignals) -> int:
        """Target replica count for the next inter-batch window.

        Call once per evaluation tick; cooldown is counted in ticks."""
        n = len(signals.queue_depths)
        self._since_last_event += 1
        if n == 0:
            return self.min_replicas
        target = n
        depth = signals.mean_depth
        p99 = signals.p99_s
        over_budget = (self.p99_budget_s is not None and p99 is not None
                       and p99 > self.p99_budget_s)
        # an open circuit breaker is lost capacity: replace it (grow)
        # even if the survivors' queues look calm, so the fleet's
        # *serving* headroom is restored while the breaker cools off
        lost_capacity = signals.open_breakers > 0 and n < self.max_replicas
        if depth > self.queue_high or over_budget or lost_capacity:
            target = min(n + 1, self.max_replicas)
        elif depth < self.queue_low and not over_budget:
            target = max(n - 1, self.min_replicas)
        if target == n or self._since_last_event < self.cooldown:
            return n
        self._since_last_event = 0
        self.events.append(ScaleEvent(
            decision=1 if target > n else -1, n_before=n, n_after=target,
            mean_depth=depth, p99_s=p99))
        return target

    def stats(self) -> dict:
        return {
            "bounds": [self.min_replicas, self.max_replicas],
            "events": [dataclasses.asdict(e) for e in self.events],
            "grows": sum(1 for e in self.events if e.decision > 0),
            "shrinks": sum(1 for e in self.events if e.decision < 0),
        }
