"""Per-tenant QoS: token-bucket quotas + weighted fair queueing.

The port of ``repro/service/tenancy.py``, framework-free as the
reference is (a copy: the port imports nothing of the reference).

Multi-tenant serving shares one physical index and one replica fleet;
without QoS a single hot tenant's burst fills every micro-batcher and
every quiet tenant pays its queueing delay.  This module keeps the
*mechanism* small and policy-free:

  * :class:`TokenBucket` — classic leaky-bucket admission: ``rate_qps``
    tokens/second refill up to ``burst``; ``take(now)`` is O(1) and
    clock-injectable (works on the virtual and the wall clock alike).
    Rate 0 means "no quota" (always admits).
  * :class:`TenantRegistry` — the service's view of the spec's
    ``tenants`` section: name <-> id resolution, per-tenant weight and
    bucket, per-tenant shed accounting.  One registry per service.
  * :class:`WFQScheduler` — weighted fair queueing in front of the
    router (wall-clock executor path).  Each submit is stamped with a
    virtual finish time ``max(V, F_t) + 1/weight_t`` (unit cost per
    request); at most ``window`` dispatches are in flight, and every
    completion pulls the globally smallest-finish-time head.  A hot
    tenant's backlog therefore queues *in the scheduler*, interleaved
    at its weight share, instead of ahead of quiet tenants inside the
    replica batchers.

Layering: admission (the bucket) runs on both clock paths in
``AnnService._route_and_submit``; WFQ wraps only the executor path,
where real concurrency exists.  The router's bounded-load spill still
runs *per dispatch* underneath — WFQ decides *when* a request may enter
the fleet, the router decides *where* it lands.

Dispatch callbacks run outside the scheduler lock (a dispatch enqueues
onto a replica batcher, whose worker may complete it — and re-enter
``on_complete`` — before the dispatch loop returns).
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, Dict, List, Optional, Tuple

NO_TENANT = -1


class TokenBucket:
    """Leaky-bucket request admission (``rate_qps`` refill, ``burst`` cap).

    Not thread-safe on its own — the owning :class:`TenantRegistry`
    serializes ``take`` calls.  The first ``take`` anchors the clock, so
    virtual-clock replays starting at t=0 and wall-clock services
    starting at an arbitrary ``time.monotonic()`` both begin with a full
    burst of tokens.
    """

    def __init__(self, rate_qps: float, burst: int):
        self.rate = float(rate_qps)
        self.burst = float(max(int(burst), 1))
        self.tokens = self.burst
        self.t_last: Optional[float] = None

    def take(self, now: float) -> bool:
        """Admit one request at time ``now``; False = over quota."""
        if self.rate <= 0.0:
            return True
        if self.t_last is None:
            self.t_last = float(now)
        dt = max(float(now) - self.t_last, 0.0)
        self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self.t_last = float(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class TenantRegistry:
    """Name <-> id resolution + per-tenant quota/shed accounting.

    Built from the spec's ``tenants`` tuples ``(name, id, weight,
    rate_qps, burst)``.  Unknown tenants resolve by int id (scoping
    works without registration); only registered tenants carry quotas
    and weights.
    """

    def __init__(self, tenants: Tuple[Tuple, ...] = ()):
        self._lock = threading.Lock()
        self.by_name: Dict[str, int] = {}
        self._names: Dict[int, str] = {}
        self._weights: Dict[int, float] = {}
        self._buckets: Dict[int, TokenBucket] = {}
        self.shed: Dict[int, int] = {}
        for name, tid, weight, rate_qps, burst in tenants:
            tid = int(tid)
            self.by_name[str(name)] = tid
            self._names[tid] = str(name)
            self._weights[tid] = float(weight)
            self._buckets[tid] = TokenBucket(rate_qps, burst)
            self.shed[tid] = 0

    def resolve(self, tenant) -> int:
        """None -> -1 (unscoped); int passes through; str looks up."""
        if tenant is None:
            return NO_TENANT
        if isinstance(tenant, str):
            if tenant not in self.by_name:
                raise KeyError(f"unknown tenant {tenant!r} (registered: "
                               f"{sorted(self.by_name)})")
            return self.by_name[tenant]
        return int(tenant)

    def name_of(self, tid: int) -> str:
        return self._names.get(int(tid), str(int(tid)))

    def weight_of(self, tid: int) -> float:
        return self._weights.get(int(tid), 1.0)

    def admit(self, tid: int, now: float) -> bool:
        """Token-bucket check for one request; False increments the
        tenant's shed counter (the caller raises TenantThrottled)."""
        tid = int(tid)
        with self._lock:
            bucket = self._buckets.get(tid)
            if bucket is None or bucket.take(now):
                return True
            self.shed[tid] = self.shed.get(tid, 0) + 1
            return False

    def stats(self) -> dict:
        with self._lock:
            return {self._names[tid]: {
                        "id": tid,
                        "weight": self._weights[tid],
                        "rate_qps": self._buckets[tid].rate,
                        "shed": self.shed.get(tid, 0)}
                    for tid in sorted(self._names)}


class WFQScheduler:
    """Weighted fair queueing with a bounded in-flight dispatch window.

    ``submit(tid, dispatch)`` stamps the request with its virtual finish
    time and either dispatches immediately (window open) or holds it;
    ``on_complete`` — registered as a done-callback on every dispatched
    request's future — frees a window slot and dispatches the smallest
    finish time across all tenant queues.  Per-tenant FIFO order is
    preserved (finish times are monotone within a tenant); across
    tenants, throughput converges to the weight ratio whenever both are
    backlogged.

    Dispatch callables run outside the lock; a dispatch that fails must
    still fail its future (the service wraps it so), because the done
    callback is the only thing that returns the window slot.
    """

    def __init__(self, registry: TenantRegistry, window: int):
        if window < 1:
            raise ValueError(f"WFQ window must be >= 1, got {window}")
        self.registry = registry
        self.window = int(window)
        self._lock = threading.Lock()
        self._heap: List[Tuple[float, int, int, Callable[[], None]]] = []
        self._seq = 0
        self._vtime = 0.0                    # virtual clock (dispatch edge)
        self._finish: Dict[int, float] = {}  # last finish time per tenant
        self.in_flight = 0
        self.dispatched: Dict[int, int] = {}
        self.max_queued = 0

    @property
    def pending(self) -> int:
        """Requests held in the scheduler (not yet dispatched)."""
        with self._lock:
            return len(self._heap)

    def submit(self, tid: int, dispatch: Callable[[], None]) -> None:
        """Enqueue one request for tenant ``tid`` (NO_TENANT requests
        share one weight-1 lane) and pump the window."""
        tid = int(tid)
        with self._lock:
            start = max(self._vtime, self._finish.get(tid, 0.0))
            finish = start + 1.0 / self.registry.weight_of(tid)
            self._finish[tid] = finish
            heapq.heappush(self._heap, (finish, self._seq, tid, dispatch))
            self._seq += 1
            self.max_queued = max(self.max_queued, len(self._heap))
            ready = self._pull_locked()
        for fn in ready:
            fn()

    def on_complete(self, _future=None) -> None:
        """Done-callback for a dispatched request's future: return the
        window slot and dispatch the next head(s)."""
        with self._lock:
            self.in_flight = max(self.in_flight - 1, 0)
            ready = self._pull_locked()
        for fn in ready:
            fn()

    def _pull_locked(self) -> List[Callable[[], None]]:
        ready: List[Callable[[], None]] = []
        while self._heap and self.in_flight < self.window:
            finish, _, tid, fn = heapq.heappop(self._heap)
            self._vtime = max(self._vtime, finish)
            self.in_flight += 1
            self.dispatched[tid] = self.dispatched.get(tid, 0) + 1
            ready.append(fn)
        return ready

    def stats(self) -> dict:
        with self._lock:
            return {"window": self.window,
                    "in_flight": self.in_flight,
                    "queued": len(self._heap),
                    "max_queued": self.max_queued,
                    "dispatched": {self.registry.name_of(t): n
                                   for t, n in sorted(
                                       self.dispatched.items())}}
