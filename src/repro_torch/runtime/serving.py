"""Online serving runtime: micro-batched streaming search over the engine.

  * :mod:`repro_torch.runtime.batching` coalesces single-query requests
    into padded micro-batches, flushing on deadline or on a full batch;
  * :class:`LocalEngine` runs the single-device five-phase pipeline
    (``core.search.search_ivfpq``) over an all-resident index;
  * :class:`ShardedEngine` serves ``core.sharded_search.DistributedEngine``
    (layout-sharded clusters, scheduled scans, optional LUT cache);
  * :class:`ServingRuntime` offers a submit/step online API plus a
    virtual-clock stream simulator with latency/throughput
    instrumentation (p50/p99, queue depth, batch occupancy).

Timestamps and latencies are seconds on the caller's clock (the
simulator uses a virtual clock and charges real measured engine time,
which includes the device work: results come back to the host).

Invariant: every engine op is row-wise per query, so a request's result
does not depend on the micro-batch it rode in; de-padded served results
match a direct search.  (On the card that needs CL to run on a fixed
block shape, see ``core.search._search_chunk``.)
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.search import SearchParams, search_ivfpq
from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request)
from repro_torch.runtime.cache import HotClusterLUTCache


class SearchEngine(Protocol):
    """What the runtime needs from an engine: fixed k, batched search."""

    k: int

    def search_batch(self, queries: np.ndarray,
                     n_valid: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) f32 -> ((B, k) dists, (B, k) ids), row-wise per query.
        Rows >= ``n_valid`` are batch padding."""
        ...


class LocalEngine:
    """Single-device five-phase pipeline behind the serving protocol.

    Covers the all-resident, uncached, unscoped engine.  The LUT cache,
    tiered storage, the two-level coarse quantizer and tenant / predicate
    scopes are not ported yet and raise ``NotImplementedError``.
    """

    def __init__(self, index: IVFPQIndex, clusters: PaddedClusters,
                 params: SearchParams, lut_cache=None, tiered_store=None,
                 coarse=None, meta=None):
        for name, val in (("lut_cache", lut_cache),
                          ("tiered_store", tiered_store), ("coarse", coarse),
                          ("meta", meta)):
            if val is not None:
                raise NotImplementedError(
                    f"LocalEngine({name}=...) is not ported to repro_torch "
                    f"yet")
        if clusters is None:
            raise ValueError("clusters are required (tiered storage is not "
                             "ported)")
        self.index = index
        self.clusters = clusters
        self.params = params
        self.k = params.k
        self.device = index.centroids.device

    def search_batch(self, queries: np.ndarray,
                     n_valid: Optional[int] = None,
                     budget_s: Optional[float] = None,
                     tenants: Optional[np.ndarray] = None,
                     terms: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) queries -> ((B, k) f32 dists, (B, k) i32 ids) on the
        host.  ``budget_s`` only matters to the tiered path and is
        ignored here, as in the reference's all-resident engine."""
        if tenants is not None or terms is not None:
            raise NotImplementedError("tenant / predicate scoped search is "
                                      "not ported to repro_torch yet")
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        d, i = search_ivfpq(self.index, self.clusters, q, self.params)
        return d.cpu().numpy(), i.cpu().numpy()

    def serving_info(self) -> dict:
        return {"engine": "local", "device": str(self.device)}


class ShardedEngine:
    """``core.sharded_search.DistributedEngine`` behind the protocol.

    ``search(flush=True)`` drains deferred tasks, so each batch returns
    complete results; the per-query merge makes rows independent of batch
    composition, which is what the de-padding invariant needs.

    The serving collaborators live on the wrapped engine; this adapter
    forwards them (``lut_cache`` as a settable property so warmup's
    throwaway-cache swap reaches the engine, ``n_valid`` so padding rows
    stay out of the cache and the heat estimator).
    """

    def __init__(self, engine):
        self.engine = engine
        self.k = engine.cfg.k

    @property
    def lut_cache(self):
        return self.engine.lut_cache

    @lut_cache.setter
    def lut_cache(self, cache):
        self.engine.lut_cache = cache

    @property
    def nprobe(self) -> int:
        return self.engine.cfg.nprobe

    def precompile_lc(self, max_rows: int) -> None:
        self.engine.precompile_lc(max_rows)

    def serving_info(self) -> dict:
        return self.engine.serving_info()

    def search_batch(self, queries: np.ndarray,
                     n_valid: Optional[int] = None,
                     budget_s: Optional[float] = None,
                     tenants: Optional[np.ndarray] = None,
                     terms: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        d, i, _info = self.engine.search(np.asarray(queries, np.float32),
                                         n_valid=n_valid, budget_s=budget_s,
                                         tenants=tenants, terms=terms)
        return np.asarray(d), np.asarray(i)


# ---------------------------------------------------------------------------
# Instrumentation
# ---------------------------------------------------------------------------

def _percentile(xs: Sequence[float], pct: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), pct))


@dataclasses.dataclass
class BatchRecord:
    bucket: int
    n_valid: int
    reason: str
    service_s: float
    t_flush: float


class ServingStats:
    """Per-request latency + per-batch occupancy/service accounting.
    One lock guards the lists; ``summary()`` reads a consistent
    snapshot."""

    def __init__(self):
        self.latencies_s: List[float] = []
        self.batches: List[BatchRecord] = []
        self.queue_depths: List[int] = []
        self.t_first_arrival: Optional[float] = None
        self.t_last_done: Optional[float] = None
        self._lock = threading.Lock()

    def record_arrival(self, req: Request, depth: int) -> None:
        with self._lock:
            if (self.t_first_arrival is None
                    or req.t_arrival < self.t_first_arrival):
                self.t_first_arrival = req.t_arrival
            self.queue_depths.append(depth)

    def record_batch(self, batch: MicroBatch, service_s: float) -> None:
        with self._lock:
            self.batches.append(BatchRecord(batch.bucket, batch.n_valid,
                                            batch.reason, service_s,
                                            batch.t_flush))

    def record_done(self, req: Request) -> None:
        with self._lock:
            self.latencies_s.append(req.latency_s)
            if self.t_last_done is None or req.t_done > self.t_last_done:
                self.t_last_done = req.t_done

    def summary(self) -> dict:
        with self._lock:
            n = len(self.latencies_s)
            span = ((self.t_last_done - self.t_first_arrival)
                    if n and self.t_last_done is not None else 0.0)
            slots = sum(b.bucket for b in self.batches)
            valid = sum(b.n_valid for b in self.batches)
            reasons = {"full": 0, "deadline": 0, "drain": 0}
            for b in self.batches:
                reasons[b.reason] += 1
            return {
                "requests": n,
                "batches": len(self.batches),
                "p50_ms": _percentile(self.latencies_s, 50) * 1e3,
                "p99_ms": _percentile(self.latencies_s, 99) * 1e3,
                "mean_ms": (float(np.mean(self.latencies_s)) * 1e3
                            if n else float("nan")),
                "qps": n / span if span > 0 else float("nan"),
                "avg_batch_occupancy": (valid / slots if slots
                                        else float("nan")),
                "pad_fraction": (slots - valid) / slots if slots else 0.0,
                "mean_queue_depth": (float(np.mean(self.queue_depths))
                                     if self.queue_depths else 0.0),
                "max_queue_depth": (max(self.queue_depths)
                                    if self.queue_depths else 0),
                "flushes": reasons,
            }


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingConfig:
    """Bucket-policy and flush knobs."""
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    max_wait_s: float = 2e-3          # deadline flush bound
    max_batch: Optional[int] = None   # default: largest bucket

    def make_batcher(self) -> MicroBatcher:
        return MicroBatcher(BucketPolicy(self.buckets),
                            max_wait_s=self.max_wait_s,
                            max_batch=self.max_batch)


class BatchServeError(RuntimeError):
    """An engine raised mid-batch.  Carries the flushed batch so the
    caller can fail or retry exactly the requests that rode in it."""

    def __init__(self, batch: MicroBatch, cause: BaseException):
        super().__init__(f"engine failed serving a {batch.bucket}-slot "
                         f"batch ({batch.n_valid} live requests): {cause!r}")
        self.batch = batch
        self.cause = cause


class ServingRuntime:
    """Single-server online loop: submit -> micro-batch -> engine -> depad.

      * online:  ``submit(q, now)`` + ``step(now)`` under a caller clock;
      * offline: ``run_stream([(t, q), ...])`` replays a timestamped
        arrival trace on a virtual clock, charging each batch its real
        measured engine service time.
    """

    def __init__(self, engine: SearchEngine,
                 config: Optional[ServingConfig] = None):
        self.engine = engine
        self.config = config or ServingConfig()
        self.batcher = self.config.make_batcher()
        self.stats = ServingStats()

    def warmup(self, d: int) -> None:
        """Run every bucket shape once (all-padding, ``n_valid=0``) so
        the first real batch per bucket is not charged first-use costs
        (kernel build and load, cuBLAS handle and workspace).  Warmup
        batches never touch the cache or the heat estimator: a throwaway
        LUT cache (same granularity and dtype) stands in for the real one
        meanwhile, and the cached path's miss-batch LC shapes are run
        once too."""
        cache = getattr(self.engine, "lut_cache", None)
        if cache is not None:
            self.engine.lut_cache = HotClusterLUTCache(
                capacity=len(self.batcher.policy.buckets) * 64,
                granularity=cache.granularity,
                lut_dtype=cache.lut_dtype)
        try:
            for b in self.batcher.policy.buckets:
                self.engine.search_batch(np.zeros((b, d), np.float32),
                                         n_valid=0)
            if cache is not None:
                self.engine.precompile_lc(self.batcher.policy.max_batch
                                          * self.engine.nprobe)
        finally:
            if cache is not None:
                self.engine.lut_cache = cache

    # -- online API --------------------------------------------------------
    def submit(self, query: np.ndarray, now: float) -> Request:
        """Queue one request."""
        req = self.batcher.submit(query, now)
        self.stats.record_arrival(req, self.batcher.depth)
        return req

    def step(self, now: float, drain: bool = False) -> List[Request]:
        """Flush + serve every batch the policy releases at time ``now``."""
        done: List[Request] = []
        while True:
            batch = self.batcher.poll(now, drain=drain)
            if batch is None:
                return done
            done.extend(self._serve(batch, t_start=now))

    def serve_flushed(self, batch: MicroBatch,
                      t_start: float) -> List[Request]:
        """Serve an already-flushed batch at time ``t_start`` (hook for
        external stream drivers)."""
        return self._serve(batch, t_start=t_start)

    def _serve(self, batch: MicroBatch, t_start: float) -> List[Request]:
        t0 = time.perf_counter()
        try:
            d, i = self.engine.search_batch(batch.queries,
                                            n_valid=batch.n_valid)
        except Exception as e:
            # fail only this batch's requests; the caller decides whether
            # to retry them elsewhere or propagate
            raise BatchServeError(batch, e) from e
        service_s = time.perf_counter() - t0
        self.stats.record_batch(batch, service_s)
        t_done = t_start + service_s
        for row, req in enumerate(batch.requests):   # de-pad: rows [0, n)
            req.dists = np.asarray(d[row])
            req.ids = np.asarray(i[row])
            req.t_flush = batch.t_flush
            req.t_service_start = t_start
            req.t_done = t_done
            self.stats.record_done(req)
        return batch.requests

    # -- offline simulation ------------------------------------------------
    def run_stream(self, arrivals: Sequence[Tuple[float, np.ndarray]]
                   ) -> List[Request]:
        """Replay (t_arrival, query) pairs; returns requests in order.

        Single-server discrete-event model: a batch flushed at t starts
        service at max(t, server_free) and occupies the server for its
        measured wall-clock engine time, so queueing delay shows up in
        the latency percentiles as offered load approaches capacity.
        """
        reqs: List[Request] = []
        server_free = 0.0

        def serve_at(batch: MicroBatch) -> None:
            nonlocal server_free
            start = max(batch.t_flush, server_free)
            served = self._serve(batch, t_start=start)
            server_free = served[0].t_done
        for t, query in sorted(arrivals, key=lambda a: a[0]):
            while True:   # fire deadline flushes that precede this arrival
                ddl = self.batcher.next_deadline()
                if ddl is None or ddl > t:
                    break
                batch = self.batcher.poll(ddl)
                if batch is None:
                    break
                serve_at(batch)
            reqs.append(self.submit(query, now=t))
            batch = self.batcher.poll(t)             # flush-on-full
            if batch is not None:
                serve_at(batch)
        while self.batcher.depth:                    # end-of-stream drain
            ddl = self.batcher.next_deadline()
            batch = self.batcher.poll(ddl, drain=True)
            serve_at(batch)
        return reqs

    # -- metrics -----------------------------------------------------------
    def metrics(self) -> dict:
        out = self.stats.summary()
        cache = getattr(self.engine, "lut_cache", None)
        if cache is not None:
            out["lut_cache"] = dict(cache.stats.as_dict(),
                                    entries=len(cache),
                                    granularity=cache.granularity)
        info = getattr(self.engine, "serving_info", None)
        if info is not None:
            out["engine"] = info()
        return out
