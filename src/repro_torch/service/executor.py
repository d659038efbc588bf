"""Executor-backed replicas: the async half of the service tier.

The port of ``repro/service/executor.py``.  One difference: several
workers may launch on one card, so each worker makes its replica's
device current (``torch.cuda.set_device``) before it serves, and the
kernels launch on that thread's current stream.  The kernels' first
launches (library load) happen in ``AnnService.warmup``, before any
worker starts.

The paper's throughput argument (§load balancing) is that many PIM ranks
stay busy *concurrently*; the service-tier analogue is that N replica
runtimes must genuinely overlap — a request parked in one replica's
micro-batcher must not stop another replica from flushing.  This module
provides that overlap:

  * :class:`SearchFuture` — the caller-facing handle for one submitted
    query: ``done()``, ``result(timeout)``, and ``timing()`` (the
    queue / batch / engine breakdown stamped by the runtime).  One
    future tracks one request across retries — if a replica fails
    mid-batch the service re-routes the request and re-binds the same
    future, so callers never observe the failover.
  * :class:`ReplicaExecutor` — one daemon worker thread owning one
    replica's :class:`~repro_torch.runtime.serving.ServingRuntime`.  Submits
    land in the (thread-safe) micro-batcher from the router thread; the
    worker sleeps until the earliest deadline (or a flush-on-full
    notification), serves the batch on the wall clock, and resolves the
    futures.  N executors = N overlapping servers behind one router.

Failure contract: an engine exception inside a batch raises
:class:`~repro_torch.runtime.serving.BatchServeError`; the worker hands the
dead batch to ``on_batch_failure`` (the service's retry hook) and keeps
running.  Only that batch's futures are affected — a poisoned query can
never take down requests queued behind it on other replicas.

Everything here is clock-injectable (``clock=...``) so tests can drive
the worker deterministically; production uses ``time.monotonic``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.batching import MicroBatch, Request
from repro_torch.runtime.serving import BatchServeError, ServingRuntime


class SearchFuture:
    """Completion handle for one submitted query.

    Created by ``AnnService.submit_async`` (and by the stream drivers);
    resolved by whichever replica runtime ends up serving the request —
    including after a mid-batch replica failure, when the service
    re-binds the future to the retried request.
    """

    def __init__(self, request: Optional[Request] = None,
                 replica: int = -1):
        self._event = threading.Event()
        self._request = request
        self._error: Optional[BaseException] = None
        self._callbacks: list = []
        self._cb_lock = threading.Lock()
        if request is not None:
            request.future = self
            request.replica = replica

    # -- runtime-facing ---------------------------------------------------
    def _bind(self, request: Request, replica: int) -> None:
        """Bind this future to ``request`` on replica ``replica``."""
        request.future = self
        request.replica = replica
        self._request = request

    def _rebind(self, request: Request, replica: int) -> None:
        """Point this future at a retried request on another replica."""
        request.retried = True
        self._bind(request, replica)

    def _resolve(self, request: Request) -> None:
        """Called by ``ServingRuntime._serve`` once results are stamped."""
        if request is self._request:      # a stale pre-retry request loses
            self._event.set()
            self._run_callbacks()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()
        self._run_callbacks()

    def _run_callbacks(self) -> None:
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` once the future resolves or fails (on the
        resolving thread); immediately if it already did.  Each callback
        fires exactly once even across retries (resolve fires only for
        the currently bound request)."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- caller-facing ----------------------------------------------------
    @property
    def request(self) -> Request:
        """The live Request (post-retry it is the re-routed one)."""
        return self._request

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Block until served; returns ((k,) distances, (k,) ids).

        Raises ``TimeoutError`` if ``timeout`` (seconds) elapses first,
        or the engine's exception if the request ultimately failed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self._request.req_id} not served within "
                f"{timeout}s (queue depth may be growing faster than "
                f"the fleet drains it)")
        if self._error is not None:
            raise self._error
        return self._request.dists, self._request.ids

    def timing(self) -> dict:
        """Queue/batch/engine breakdown plus routing provenance and
        whether the result was degraded (a tiered engine shed cold
        probes under deadline pressure)."""
        out = self._request.timing()
        out["replica"] = self._request.replica
        out["retried"] = self._request.retried
        out["degraded"] = self._request.degraded
        return out


class ReplicaExecutor:
    """One worker thread driving one replica's runtime on the wall clock.

    The worker sleeps until the replica's earliest flush deadline (or is
    notified on submit, which covers flush-on-full), polls the batcher,
    and serves the flushed batch; ``ServingRuntime._serve`` resolves the
    futures.  ``flush()`` force-drains queued requests (end of stream);
    ``shutdown()`` drains and joins the thread.
    """

    def __init__(self, runtime: ServingRuntime, replica_idx: int,
                 clock: Callable[[], float] = time.monotonic,
                 on_batch_failure: Optional[
                     Callable[[int, MicroBatch, BaseException], None]]
                 = None,
                 on_batch_success: Optional[Callable[[int], None]] = None,
                 join_timeout_s: float = 30.0,
                 device: Optional[torch.device] = None):
        if join_timeout_s <= 0:
            raise ValueError(f"join_timeout_s must be positive, "
                             f"got {join_timeout_s}")
        self.runtime = runtime
        self.replica_idx = int(replica_idx)
        self.clock = clock
        self.on_batch_failure = on_batch_failure
        self.on_batch_success = on_batch_success
        self.join_timeout_s = float(join_timeout_s)
        self.device = device
        self.failures = 0
        self.wedged = False
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ReplicaExecutor":
        """Start (or restart, after shutdown — an autoscaler re-grow)
        the worker thread."""
        if self._thread is None:
            self._stop = False
            self._draining = False
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"replica-exec-{self.replica_idx}")
            self._thread.start()
        return self

    def submit(self, query: np.ndarray, now: Optional[float] = None,
               attach=None, tenant: int = -1,
               terms: Tuple[int, ...] = ()) -> Request:
        """Enqueue one query (router thread); wakes the worker so a
        flush-on-full fires immediately rather than at the deadline.
        ``attach(req)`` binds a future before the worker can see the
        request (it runs under the batcher lock).  ``tenant`` / ``terms``
        scope the request (see :mod:`repro_torch.core.filter`)."""
        req = self.runtime.submit(
            np.asarray(query, np.float32),
            float(now) if now is not None else self.clock(),
            attach=attach, tenant=tenant, terms=terms)
        with self._cond:
            self._cond.notify()
        return req

    @property
    def queue_depth(self) -> int:
        return self.runtime.batcher.depth

    def flush(self) -> None:
        """Force the worker to drain everything currently queued (the
        drain flag clears once the queue empties)."""
        with self._cond:
            self._draining = True
            self._cond.notify()

    def shutdown(self) -> None:
        """Drain outstanding requests, then stop and join the worker.

        Raises ``RuntimeError`` if the worker does not exit within
        ``join_timeout_s`` (a wedged engine): ``wedged`` is set first so
        ``AnnService.stats()`` can count it, and the thread is kept
        referenced so ``running`` stays truthful and a later ``start()``
        cannot spawn a duplicate worker over the same runtime."""
        if self._thread is None:
            return
        with self._cond:
            self._stop = True
            self._draining = True
            self._cond.notify()
        self._thread.join(timeout=self.join_timeout_s)
        if self._thread.is_alive():
            self.wedged = True
            raise RuntimeError(
                f"replica {self.replica_idx} executor did not drain "
                f"within {self.join_timeout_s:g}s (engine wedged "
                f"mid-batch?); its worker is still running")
        self.wedged = False
        self._thread = None

    # -- worker ------------------------------------------------------------
    def _wait_for_work(self) -> bool:
        """Sleep until there is something to flush.  Returns False when
        stopped with an empty queue (worker exits)."""
        with self._cond:
            while True:
                batcher = self.runtime.batcher
                now = self.clock()
                if batcher.ready(now) is not None:
                    return True
                if self._draining:
                    if batcher.depth:
                        return True
                    self._draining = False        # drained: back to normal
                if self._stop:
                    return batcher.depth > 0
                ddl = batcher.next_deadline()
                if ddl is None:
                    self._cond.wait()
                else:
                    self._cond.wait(max(ddl - now, 0.0))

    def _loop(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while self._wait_for_work():
            with self._cond:
                drain = self._draining or self._stop
            batch = self.runtime.batcher.poll(self.clock(), drain=drain)
            if batch is None:
                continue
            try:
                self.runtime.serve_flushed(batch, t_start=self.clock())
                if self.on_batch_success is not None:
                    self.on_batch_success(self.replica_idx)
            except BatchServeError as err:
                self.failures += 1
                try:
                    if self.on_batch_failure is not None:
                        self.on_batch_failure(self.replica_idx, err.batch,
                                              err.cause)
                except Exception as hook_err:      # noqa: BLE001
                    # the hook itself is not allowed to kill the worker
                    # or strand futures: fail whatever it left unhandled
                    err.cause = hook_err
                finally:
                    for req in err.batch.requests:
                        fut = req.future
                        # skip futures the hook re-bound to a retry
                        # (their .request is no longer this batch's)
                        if (fut is not None and not fut.done()
                                and fut.request is req):
                            fut._fail(err.cause)
