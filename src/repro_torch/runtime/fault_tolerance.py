"""Per-replica health for the serving tier: :class:`ReplicaHealth`.

The port of the serving half of ``repro/runtime/fault_tolerance.py``.
The service feeds each replica's batch outcomes in, picks retry targets
after a mid-batch engine failure from the healthy set, and routes around
a replica whose breaker is open.  Framework-free: no torch here.

The training-side control plane of the reference module
(``HeartbeatRegistry``, ``ElasticPlan``, ``StragglerPolicy``,
``RunSupervisor``) belongs to the LM stack and is not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class ReplicaHealth:
    """Per-replica circuit breaker fed by batch outcomes.

    Classic three-state breaker, one per replica:

      * **closed** — normal routing.  ``max_consecutive`` consecutive
        batch failures trip the breaker *open* (``record_failure``).
      * **open** — the replica takes no traffic (``allow`` is False) and
        the router steers around it.  After ``half_open_after_s`` of
        wall time the breaker transitions to *half-open*.
      * **half-open** — exactly ONE probe batch is admitted (``allow``
        returns True once per open period); its success closes the
        breaker, its failure re-opens it and restarts the clock.  A
        claimed probe that never reports back (executor scaled down or
        wedged before serving, service shutdown) would otherwise pin the
        slot forever — after ``probe timeout`` (= ``half_open_after_s``)
        of silence the slot is released so a fresh probe can be
        admitted and the replica can still rejoin.

    ``half_open_after_s=0`` (default) means no timed recovery: an
    open breaker stays open until some success (e.g. a retry that still
    landed there) resets it.

    ``is_healthy``/``healthy`` stay the *pure* views (closed-or-not,
    used for retry-target picking and stats); ``allow`` is the
    routing-time check that additionally claims the half-open probe
    slot.  Thread-safe: executor workers record outcomes concurrently.
    """

    def __init__(self, n_replicas: int, max_consecutive: int = 3,
                 half_open_after_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        if half_open_after_s < 0:
            raise ValueError("half_open_after_s must be >= 0")
        self.max_consecutive = int(max_consecutive)
        self.half_open_after_s = float(half_open_after_s)
        self.clock = clock
        self._consecutive = [0] * int(n_replicas)
        self._total = [0] * int(n_replicas)
        self._opened_at: List[Optional[float]] = [None] * int(n_replicas)
        self._probing = [False] * int(n_replicas)
        self._probe_started: List[Optional[float]] = [None] * int(n_replicas)
        self._lock = threading.Lock()

    @property
    def n_replicas(self) -> int:
        return len(self._consecutive)

    def resize(self, n_replicas: int) -> None:
        """Track a grown fleet (new replicas start healthy); shrinking
        drops the trailing replicas' counts (LIFO, matching the
        autoscaler's grow/shrink order)."""
        with self._lock:
            n = int(n_replicas)
            if n < 1:
                raise ValueError("n_replicas must be >= 1")
            cur = len(self._consecutive)
            if n > cur:
                self._consecutive += [0] * (n - cur)
                self._total += [0] * (n - cur)
                self._opened_at += [None] * (n - cur)
                self._probing += [False] * (n - cur)
                self._probe_started += [None] * (n - cur)
            else:
                del self._consecutive[n:]
                del self._total[n:]
                del self._opened_at[n:]
                del self._probing[n:]
                del self._probe_started[n:]

    def record_success(self, replica: int) -> None:
        with self._lock:
            self._consecutive[replica] = 0
            self._opened_at[replica] = None
            self._probing[replica] = False
            self._probe_started[replica] = None

    def record_failure(self, replica: int) -> None:
        with self._lock:
            self._consecutive[replica] += 1
            self._total[replica] += 1
            if self._probing[replica]:
                # half-open probe failed: re-open, restart the clock
                self._probing[replica] = False
                self._probe_started[replica] = None
                self._opened_at[replica] = self.clock()
            elif self._consecutive[replica] >= self.max_consecutive \
                    and self._opened_at[replica] is None:
                self._opened_at[replica] = self.clock()

    def _release_stale_probe_locked(self, replica: int) -> None:
        """A claimed probe whose outcome never arrived (its request died
        before record_success/record_failure) must not pin the half-open
        slot forever: after a full ``half_open_after_s`` of silence the
        claim is released so the next router can probe."""
        if self._probing[replica] and self.half_open_after_s > 0 \
                and self._probe_started[replica] is not None \
                and self.clock() - self._probe_started[replica] \
                >= self.half_open_after_s:
            self._probing[replica] = False
            self._probe_started[replica] = None

    def state(self, replica: int) -> str:
        """'closed' | 'open' | 'half_open' (pure view)."""
        with self._lock:
            return self._state_locked(replica)

    def _state_locked(self, replica: int) -> str:
        if self._opened_at[replica] is None:
            return "closed"
        if self._probing[replica]:
            return "half_open"
        if self.half_open_after_s > 0 and \
                self.clock() - self._opened_at[replica] \
                >= self.half_open_after_s:
            return "half_open"
        return "open"

    def allow(self, replica: int) -> bool:
        """Routing-time admission: closed replicas always pass; an open
        breaker passes exactly one probe batch once the half-open window
        arrives (claiming it — concurrent routers race for one slot).
        A claimed probe times out after ``half_open_after_s`` so a lost
        probe request cannot wedge the replica out of the fleet."""
        with self._lock:
            if self._opened_at[replica] is None:
                return True
            self._release_stale_probe_locked(replica)
            if self._probing[replica]:
                return False              # probe already in flight
            if self.half_open_after_s > 0 and \
                    self.clock() - self._opened_at[replica] \
                    >= self.half_open_after_s:
                self._probing[replica] = True
                self._probe_started[replica] = self.clock()
                return True
            return False

    def is_healthy(self, replica: int) -> bool:
        with self._lock:
            return self._consecutive[replica] < self.max_consecutive

    def healthy(self) -> List[int]:
        with self._lock:
            return [r for r, c in enumerate(self._consecutive)
                    if c < self.max_consecutive]

    def open_count(self) -> int:
        """Replicas currently taking no traffic — the autoscaler's
        lost-capacity signal."""
        with self._lock:
            return sum(1 for r in range(len(self._consecutive))
                       if self._state_locked(r) == "open")

    def stats(self) -> dict:
        with self._lock:
            return {"failures": list(self._total),
                    "unhealthy": [r for r, c in
                                  enumerate(self._consecutive)
                                  if c >= self.max_consecutive],
                    "breaker": [self._state_locked(r)
                                for r in range(len(self._consecutive))]}
