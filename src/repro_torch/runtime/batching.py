"""Dynamic micro-batching for serving.

Online ANNS traffic arrives as a stream of single queries, but the
engine wants batches.  The batcher coalesces requests into padded
micro-batches drawn from a small set of batch-size buckets, so the
engine sees few distinct shapes.

Flush policy (both knobs in :class:`MicroBatcher`):

  * flush-on-full      — queue depth reached ``max_batch``;
  * flush-on-deadline  — the oldest queued request has waited
    ``max_wait_s`` (bounds tail latency under light load).

All timestamps are passed in explicitly (``now``, seconds), so the
batcher is deterministic under a virtual clock.  Queue operations are
thread-safe (one lock around submit/poll/depth).

:class:`TasksPerShardController` picks the sharded engine's static
``(n_shards, tasks_per_shard)`` task-table width per batch size: too
wide and small batches pay for padding tasks, too narrow and large
batches overflow into drain rounds.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.util import next_pow2 as _pow2_ceil


class BucketPolicy:
    """A small sorted set of allowed (padded) batch sizes.

    ``bucket_for(n)`` returns the smallest bucket >= n (clamped to the
    largest bucket).
    """

    def __init__(self, buckets):
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets = tuple(bs)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def __repr__(self):
        return f"BucketPolicy{self.buckets}"


@dataclasses.dataclass
class Request:
    """One in-flight query.  Result fields are stamped at completion.

    ``t_arrival -> t_flush`` is queue time, ``t_flush ->
    t_service_start`` is batch time (waiting for the server), and
    ``t_service_start -> t_done`` is engine time, all on the clock that
    drove the request.  ``future`` is the completion hook the service's
    async API attaches (resolved by the runtime at serve time, see
    :class:`repro_torch.service.executor.SearchFuture`)."""
    req_id: int
    query: np.ndarray            # (D,) float32
    t_arrival: float
    # stamped by the runtime when the batch it rode in completes:
    dists: Optional[np.ndarray] = None    # (k,)
    ids: Optional[np.ndarray] = None      # (k,)
    t_done: Optional[float] = None
    bucket: Optional[int] = None          # padded batch shape it rode in
    t_flush: Optional[float] = None
    t_service_start: Optional[float] = None
    future: Optional[Any] = None   # SearchFuture-like completion hook
    replica: Optional[int] = None  # which replica served it (service tier)
    retried: bool = False          # re-routed after a replica failure
    retries: int = 0               # how many times it was re-routed
    degraded: bool = False         # served from resident-only probes
    deadline_missed: bool = False  # t_done exceeded the deadline budget
    tenant: int = -1               # tenant scope (-1 = unscoped)
    terms: tuple = ()              # predicate terms (u32 tags; () = none)

    @property
    def scoped(self) -> bool:
        return self.tenant >= 0 or bool(self.terms)

    @property
    def done(self) -> bool:
        return self.ids is not None

    @property
    def latency_s(self) -> float:
        if self.t_done is None:
            raise RuntimeError(f"request {self.req_id} not served yet")
        return self.t_done - self.t_arrival

    def timing(self) -> dict:
        """Lifecycle breakdown (seconds): queue / batch / engine / total,
        and whether the result was degraded or missed its deadline."""
        if self.t_done is None:
            raise RuntimeError(f"request {self.req_id} not served yet")
        t_flush = self.t_flush if self.t_flush is not None else self.t_arrival
        t_svc = (self.t_service_start if self.t_service_start is not None
                 else t_flush)
        return {"queue_s": t_flush - self.t_arrival,
                "batch_s": t_svc - t_flush,
                "engine_s": self.t_done - t_svc,
                "total_s": self.t_done - self.t_arrival,
                "degraded": self.degraded,
                "deadline_missed": self.deadline_missed}


@dataclasses.dataclass
class MicroBatch:
    """A flushed, padded batch ready for the engine."""
    requests: List[Request]      # the n_valid real requests, queue order
    queries: np.ndarray          # (bucket, D); rows >= n_valid are zero pad
    bucket: int
    reason: str                  # "full" | "deadline" | "drain"
    t_flush: float

    @property
    def n_valid(self) -> int:
        return len(self.requests)

    @property
    def scoped(self) -> bool:
        """Whether any rider carries a tenant / predicate scope: the
        runtime then passes the batch's scope arrays to the engine."""
        return any(r.scoped for r in self.requests)

    def scope_arrays(self, width: int):
        """(tenants (bucket,) i32, terms (bucket, width) u32) for the
        scoped scans.  Padding rows (and unscoped riders) get tenant -1
        and all-NO_TAG terms, so they behave exactly like unscoped rows."""
        from repro_torch.core.filter import pad_terms
        tenants = np.full(self.bucket, -1, np.int32)
        rows = [()] * self.bucket
        for i, r in enumerate(self.requests):
            tenants[i] = r.tenant
            rows[i] = r.terms
        return tenants, pad_terms(rows, width)


class MicroBatcher:
    """Request queue + bucketed flush policy (no engine knowledge).

    One lock guards the queue; the flush decision
    and the pop happen under the same lock, so two pollers can never
    split one batch."""

    def __init__(self, policy: BucketPolicy, max_wait_s: float = 2e-3,
                 max_batch: Optional[int] = None):
        self.policy = policy
        self.max_wait_s = float(max_wait_s)
        self.max_batch = int(max_batch or policy.max_batch)
        if self.max_batch > policy.max_batch:
            raise ValueError("max_batch exceeds largest bucket")
        self._queue: Deque[Request] = deque()
        self._lock = threading.Lock()
        self._next_id = 0

    # -- queue side --------------------------------------------------------
    def submit(self, query: np.ndarray, now: float,
               attach: Optional[Callable[[Request], None]] = None,
               tenant: int = -1, terms: tuple = ()) -> Request:
        """Queue one request.  ``attach(req)``, when given, runs under
        the queue lock before the request becomes visible to a poller, so
        the service binds a future without racing a replica's worker.
        ``tenant`` / ``terms`` scope the request (see
        :mod:`repro_torch.core.filter`)."""
        with self._lock:
            req = Request(self._next_id, np.asarray(query, np.float32),
                          float(now), tenant=int(tenant), terms=tuple(terms))
            self._next_id += 1
            if attach is not None:
                attach(req)
            self._queue.append(req)
            return req

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def next_deadline(self) -> Optional[float]:
        """Time at which the oldest request must flush."""
        with self._lock:
            return self._next_deadline_locked()

    def _next_deadline_locked(self) -> Optional[float]:
        if not self._queue:
            return None
        return self._queue[0].t_arrival + self.max_wait_s

    # -- flush side --------------------------------------------------------
    def ready(self, now: float) -> Optional[str]:
        """The flush reason at ``now`` ("full" | "deadline"), or None."""
        with self._lock:
            return self._ready_locked(now)

    def _ready_locked(self, now: float) -> Optional[str]:
        if not self._queue:
            return None
        if len(self._queue) >= self.max_batch:
            return "full"
        if now >= self._next_deadline_locked():
            return "deadline"
        return None

    def poll(self, now: float, drain: bool = False) -> Optional[MicroBatch]:
        """Flush one micro-batch if policy (or ``drain``) says so."""
        with self._lock:
            reason = self._ready_locked(now)
            if reason is None:
                if not (drain and self._queue):
                    return None
                reason = "drain"
            take = min(len(self._queue), self.max_batch)
            reqs = [self._queue.popleft() for _ in range(take)]
            bucket = self.policy.bucket_for(take)
        d = reqs[0].query.shape[0]
        queries = np.zeros((bucket, d), np.float32)
        for i, r in enumerate(reqs):
            queries[i] = r.query
            r.bucket = bucket
        return MicroBatch(reqs, queries, bucket, reason, float(now))


class TasksPerShardController:
    """Pick the sharded engine's static task-table width per batch bucket.

    Prediction: a batch of ``b`` queries generates about
    ``b * tasks_per_query`` (q, instance) tasks (``tasks_per_query`` =
    nprobe x expected split parts per probed cluster, heat-weighted —
    replicas do not add tasks, the scheduler picks one).  LPT-greedy
    balancing spreads them near-evenly, so the per-shard width is that
    total over ``n_shards`` times a ``headroom`` factor for residual
    imbalance, rounded up to a power of two.

    Perf-model cap: with ``mean_task_s`` (Eq. 15 latency of an average
    task) and ``max_shard_time_s`` set, the width is additionally capped
    at the number of tasks a shard can serve inside the latency target —
    overflow is then deliberate deferral, the paper's inter-batch filter.

    Adaptation: ``observe(b, n_deferred)`` doubles a bucket's width
    multiplier whenever its schedule hit the hard cap, so a mispredicted
    fan-out (e.g. heat drift concentrating probes) self-corrects after
    one batch.

    ``tasks_for`` is clamped to ``[floor, cap]``; ``cap`` should be the
    engine's static ``tasks_per_shard`` so tuning never produces a wider
    table than the untuned default.
    """

    def __init__(self, n_shards: int, tasks_per_query: float, *,
                 headroom: float = 1.5, floor: int = 16, cap: int = 1024,
                 mean_task_s: Optional[float] = None,
                 max_shard_time_s: Optional[float] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if tasks_per_query <= 0:
            raise ValueError("tasks_per_query must be positive")
        self.n_shards = int(n_shards)
        self.tasks_per_query = float(tasks_per_query)
        self.headroom = float(headroom)
        self.floor = int(floor)
        self.cap = int(cap)
        self.mean_task_s = mean_task_s
        self.max_shard_time_s = max_shard_time_s
        self._boost: Dict[int, float] = {}    # bucket -> multiplier
        self.overflows = 0

    def tasks_for(self, batch_size: int) -> int:
        """Static table width for a ``batch_size``-query batch."""
        b = max(int(batch_size), 1)
        want = b * self.tasks_per_query * self.headroom / self.n_shards
        want *= self._boost.get(b, 1.0)
        width = _pow2_ceil(-(-want // 1))
        if self.mean_task_s and self.max_shard_time_s:
            budget = max(int(self.max_shard_time_s / self.mean_task_s), 1)
            width = min(width, _pow2_ceil(budget))
        return max(self.floor, min(width, self.cap))

    def observe(self, batch_size: int, n_deferred: int) -> None:
        """Feedback after scheduling: a hard-cap overflow (deferred tasks
        with the table full) doubles this bucket's width next time.  A
        boost that cannot change the width (static cap or perf-budget cap
        already binding) is not applied, so the multiplier stays bounded
        and ``overflows`` counts only effective adaptations."""
        if n_deferred <= 0:
            return
        b = max(int(batch_size), 1)
        before = self.tasks_for(b)
        if before >= self.cap:
            return                            # already at the static cap
        prev = self._boost.get(b, 1.0)
        self._boost[b] = prev * 2.0
        if self.tasks_for(b) == before:       # another cap binds: inert
            self._boost[b] = prev
            return
        self.overflows += 1

    def retune(self, tasks_per_query: float,
               mean_task_s: Optional[float] = None) -> None:
        """Re-price the prediction after a re-layout changed split parts
        (tasks_per_query) or task sizing (mean_task_s).  Learned overflow
        boosts are kept — they still encode observed under-prediction."""
        if tasks_per_query <= 0:
            raise ValueError("tasks_per_query must be positive")
        self.tasks_per_query = float(tasks_per_query)
        if mean_task_s is not None:
            self.mean_task_s = mean_task_s

    def summary(self) -> dict:
        """Widths currently chosen for the buckets seen so far."""
        buckets = sorted(self._boost) or []
        return {"overflows": self.overflows,
                "cap": self.cap,
                "boosted": {b: self.tasks_for(b) for b in buckets}}
