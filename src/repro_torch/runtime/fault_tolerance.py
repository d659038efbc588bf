"""Fault tolerance: the training control plane and per-replica health.

A copy of ``repro/runtime/fault_tolerance.py`` (framework-free: no torch
here).

Training (coordinator-side, pure python):

  * ``HeartbeatRegistry`` — every host pings; the coordinator declares a
    host dead after ``timeout_s`` without a beat.
  * ``ElasticPlan`` / ``plan_elastic_mesh`` — given the surviving host
    set, the largest usable mesh (the data axis shrinks to a power of
    two; the model axis is kept).
  * ``StragglerPolicy`` flags hosts whose step times exceed the p50 by a
    ratio; ``RunSupervisor`` is the restart loop: on failure, shrink,
    resume from the latest committed checkpoint (the token pipeline is a
    pure function of (seed, step), so it replays to the recorded step).

Serving: :class:`ReplicaHealth`, per-replica circuit breakers fed by
batch outcomes.  The service picks retry targets after a mid-batch
engine failure from the healthy set, and routes around a replica whose
breaker is open.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    step_times: List[float] = dataclasses.field(default_factory=list)


class HeartbeatRegistry:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        t0 = clock()
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, t0) for h in range(n_hosts)}

    def beat(self, host_id: int, step_time_s: Optional[float] = None):
        st = self.hosts[host_id]
        st.last_beat = self.clock()
        if step_time_s is not None:
            st.step_times.append(step_time_s)
            del st.step_times[:-32]

    def alive(self) -> List[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat <= self.timeout_s]

    def dead(self) -> List[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.timeout_s]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data_axis: int            # new data-parallel degree (hosts)
    model_axis: int           # unchanged TP degree
    dropped_hosts: tuple
    batch_ratio: float        # new_global_batch / old_global_batch


def plan_elastic_mesh(n_alive: int, data_axis: int, model_axis: int,
                      keep_batch: bool = True) -> Optional[ElasticPlan]:
    """Shrink the data axis to the largest power-of-two (or divisor)
    <= n_alive hosts; model axis is preserved.  Returns None if even TP
    can't be formed (fatal)."""
    if n_alive < 1:
        return None
    new_data = 1
    d = 1
    while d * 2 <= min(n_alive, data_axis):
        d *= 2
    new_data = d
    return ElasticPlan(data_axis=new_data, model_axis=model_axis,
                       dropped_hosts=(),
                       batch_ratio=new_data / data_axis if not keep_batch
                       else 1.0)


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


@dataclasses.dataclass
class StragglerPolicy:
    ratio: float = 1.5        # flag hosts slower than ratio x p50
    min_samples: int = 8

    def flag(self, registry: HeartbeatRegistry) -> List[int]:
        import statistics
        med = []
        for st in registry.hosts.values():
            if len(st.step_times) >= self.min_samples:
                med.append(statistics.median(st.step_times))
        if not med:
            return []
        p50 = statistics.median(med)
        out = []
        for h, st in registry.hosts.items():
            if len(st.step_times) >= self.min_samples and \
                    statistics.median(st.step_times) > self.ratio * p50:
                out.append(h)
        return out


class RunSupervisor:
    """Restart loop: run -> on failure shrink mesh -> restore -> resume.

    ``run_fn(mesh_shape, start_step) -> ('done'|'failed', last_step)`` is
    the training driver; ``failure injection`` in tests simulates node loss.

    ``checkpoint_steps`` names the steps with a committed checkpoint: on
    failure the run resumes from the *latest checkpoint* <= the failure
    step — you cannot restart from a step that was never persisted.
    With no checkpoint list the failure step itself is trusted (legacy
    callers that checkpoint every step).
    """

    def __init__(self, data_axis: int, model_axis: int,
                 checkpoint_steps: Sequence[int] = ()):
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.checkpoint_steps = tuple(sorted(int(s)
                                             for s in checkpoint_steps))
        self.history: List[dict] = []

    def _resume_step(self, last_step: int) -> int:
        """Latest checkpointed step <= ``last_step`` (0 if the failure
        precedes every checkpoint); ``last_step`` itself when no
        checkpoint schedule was declared."""
        if not self.checkpoint_steps:
            return last_step
        eligible = [s for s in self.checkpoint_steps if s <= last_step]
        return eligible[-1] if eligible else 0

    def supervise(self, run_fn, registry: HeartbeatRegistry,
                  max_restarts: int = 8):
        start_step = 0
        restarts = 0
        while restarts <= max_restarts:
            status, last_step = run_fn((self.data_axis, self.model_axis),
                                       start_step)
            self.history.append({"status": status, "step": last_step,
                                 "mesh": (self.data_axis, self.model_axis)})
            if status == "done":
                return last_step
            # failure: shrink to survivors, resume from last checkpoint
            n_alive = len(registry.alive())
            plan = plan_elastic_mesh(n_alive, self.data_axis,
                                     self.model_axis)
            if plan is None:
                raise RuntimeError("no usable mesh after failures")
            self.data_axis = plan.data_axis
            start_step = self._resume_step(last_step)
            restarts += 1
        raise RuntimeError(f"exceeded {max_restarts} restarts")
