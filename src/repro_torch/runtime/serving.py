"""Online serving runtime: micro-batched streaming search over the engine.

  * :mod:`repro_torch.runtime.batching` coalesces single-query requests
    into padded micro-batches, flushing on deadline or on a full batch;
  * :class:`LocalEngine` runs the single-device five-phase pipeline
    (``core.search.search_ivfpq``) over an all-resident index, optionally
    backed by the hot-cluster LUT cache (:mod:`repro_torch.runtime.cache`);
  * :class:`ShardedEngine` serves ``core.sharded_search.DistributedEngine``
    (layout-sharded clusters, scheduled scans, optional LUT cache);
  * :class:`PimPacedEngine` paces any engine's batches to their modeled
    DRAM-PIM service time (results unchanged);
  * :class:`ServingRuntime` offers a submit/step online API plus a
    virtual-clock stream simulator with latency/throughput
    instrumentation (p50/p99, queue depth, batch occupancy).

Timestamps and latencies are seconds on the caller's clock (the
simulator uses a virtual clock and charges real measured engine time,
which includes the device work: results come back to the host).

Invariant: every engine op is row-wise per query, so a request's result
does not depend on the micro-batch it rode in; de-padded served results
match a direct search.  (On the card that needs CL to run on a fixed
block shape, see ``core.search.cl_rc``.)  Padding rows (``row >=
n_valid``) never reach the LUT cache or the sharded engine's heat
estimator.

The supported front door is :class:`repro_torch.service.AnnService`;
constructing the engine adapters or the runtime directly still works and
warns once per class (``service_construction`` silences it for the
service's own builds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.search import SearchParams, cl_rc, dc_ts, search_ivfpq
from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request)
from repro_torch.runtime.cache import (HotClusterLUTCache, lut_fill_misses,
                                       lut_miss_scan, precompile_lut_shapes,
                                       stack_lut_bank)
from repro_torch.util import next_pow2


# ---------------------------------------------------------------------------
# Direct construction of the engine adapters and the runtime warns once per
# class and process; the service layer builds inside
# ``service_construction()`` and never warns.
# ---------------------------------------------------------------------------

_DEPRECATION_WARNED: set = set()
_SUPPRESS_DEPRECATION = threading.local()


@contextlib.contextmanager
def service_construction():
    """Mark constructions issued by the service layer (no deprecation
    warning).  Re-entrant and thread-local."""
    prev = getattr(_SUPPRESS_DEPRECATION, "on", False)
    _SUPPRESS_DEPRECATION.on = True
    try:
        yield
    finally:
        _SUPPRESS_DEPRECATION.on = prev


def _warn_direct_use(name: str) -> None:
    if getattr(_SUPPRESS_DEPRECATION, "on", False):
        return
    if name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(name)
    warnings.warn(
        f"Direct {name}(...) construction is deprecated; build through "
        f"repro_torch.service.AnnService (AnnService.build(ServiceSpec(...)"
        f")), which owns the engine/runtime lifecycle. The old constructor "
        f"keeps working.", DeprecationWarning, stacklevel=3)


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

    With ``lut_cache`` set, LC consults the hot-cluster LUT cache per
    (query, probed cluster) pair and builds tables for the misses only
    (one batched LC over the miss rows, through the LC kernels on the
    card); CL, RC, DC and TS are the cache-off pipeline's own steps
    (``core.search.cl_rc`` / ``dc_ts``), so at exact granularity an f32
    hit gives the same numbers as the cache-off search.  Host seconds of
    each cached-path phase accumulate in :attr:`phase_s` (``cl_rc``,
    ``lut_scan``, ``lut_fill``, ``bank``, ``dc_ts``; each ends where the
    host next needs the device's result, so device time is inside).

    Tiered storage, the two-level coarse quantizer and tenant / predicate
    scopes are not ported yet and raise ``NotImplementedError`` (ROADMAP
    items 7 and 8).
    """

    def __init__(self, index: IVFPQIndex, clusters: PaddedClusters,
                 params: SearchParams,
                 lut_cache: Optional[HotClusterLUTCache] = None,
                 tiered_store=None, coarse=None, meta=None):
        _warn_direct_use("LocalEngine")
        for name, val, item in (("tiered_store", tiered_store, 7),
                                ("coarse", coarse, 7), ("meta", meta, 8)):
            if val is not None:
                raise NotImplementedError(
                    f"LocalEngine({name}=...) is not ported to repro_torch "
                    f"yet (ROADMAP item {item})")
        if clusters is None:
            raise ValueError("clusters are required (tiered storage is not "
                             "ported)")
        if lut_cache is not None and lut_cache.lut_dtype != params.lut_dtype:
            raise ValueError(
                f"lut_cache.lut_dtype={lut_cache.lut_dtype!r} disagrees "
                f"with SearchParams.lut_dtype={params.lut_dtype!r}; cached "
                f"and uncached scans must run the same dtype")
        self.index = index
        self.clusters = clusters
        self.params = params
        self.lut_cache = lut_cache
        self.k = params.k
        self.device = index.centroids.device
        self.phase_s: dict = {}

    def _clock(self, phase: str, t0: float) -> float:
        now = time.perf_counter()
        self.phase_s[phase] = self.phase_s.get(phase, 0.0) + (now - t0)
        return now

    @property
    def nprobe(self) -> int:
        return self.params.nprobe

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
                                      "not ported to repro_torch yet "
                                      "(ROADMAP item 8)")
        queries = np.asarray(queries, np.float32)
        if self.lut_cache is not None:
            return self._search_cached(queries, n_valid)
        q = torch.from_numpy(queries).to(self.device)
        d, i = search_ivfpq(self.index, self.clusters, q, self.params)
        return d.cpu().numpy(), i.cpu().numpy()

    def serving_info(self) -> dict:
        return {"engine": "local", "device": str(self.device)}

    def precompile_lc(self, max_rows: int) -> None:
        """Run the cached path's miss-batch LC shapes (powers of two up to
        ``max_rows``) once ahead of traffic."""
        precompile_lut_shapes(self.index.codebook, max_rows,
                              lut_dtype=self.params.lut_dtype)

    @torch.no_grad()
    def _search_cached(self, queries: np.ndarray,
                       n_valid: Optional[int] = None):
        """The cached pipeline, one ``query_chunk`` of queries at a time
        (as ``search_ivfpq``).  Padding rows (>= n_valid) bypass the
        cache entirely: no LRU slot, no hit or miss."""
        qc = self.params.query_chunk
        nv = len(queries) if n_valid is None else min(n_valid, len(queries))
        outs = [self._search_cached_chunk(queries[s:s + qc],
                                          min(max(nv - s, 0), qc))
                for s in range(0, len(queries), qc)]
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def _search_cached_chunk(self, queries: np.ndarray, n_valid: int):
        p, cache, index = self.params, self.lut_cache, self.index
        t0 = time.perf_counter()
        probes, flat_res = cl_rc(torch.from_numpy(queries).to(self.device),
                                 index.centroids, index.rotation, p)
        nq, npr = probes.shape
        flat_probes = probes.reshape(-1).cpu().numpy()
        t0 = self._clock("cl_rc", t0)
        # one hash per valid query, reused across its nprobe cache keys
        buckets = [cache.bucket_of(queries[qi]) for qi in range(n_valid)]
        luts, miss_rows = lut_miss_scan(cache, flat_probes, buckets, npr,
                                        nq * npr)
        t0 = self._clock("lut_scan", t0)
        if miss_rows:
            # the chunk's own residual rows, padded to a power of two
            rows = torch.zeros(next_pow2(len(miss_rows)), dtype=torch.long)
            rows[:len(miss_rows)] = torch.as_tensor(miss_rows)
            lut_fill_misses(cache, index.codebook, luts, miss_rows,
                            flat_probes, buckets, npr,
                            flat_res.index_select(0, rows.to(self.device)))
            t0 = self._clock("lut_fill", t0)
        lut = stack_lut_bank(luts, device=self.device)
        t0 = self._clock("bank", t0)
        d, i = dc_ts(lut, probes, self.clusters, p)
        out = d.cpu().numpy(), i.cpu().numpy()
        self._clock("dc_ts", t0)
        return out


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
        _warn_direct_use("ShardedEngine")
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


class PimPacedEngine:
    """Pace an engine's service time to a modeled DRAM-PIM latency.

    The inner engine computes the exact results; the wrapper then sleeps
    out the remainder of the batch's modeled service time (Eq. 15
    per-task latency on the UPMEM profile, ``ceil(n_valid * nprobe /
    ranks)`` serial task waves over the replica's ``ranks`` DPU ranks).
    Sleeping holds no lock and burns no host time, so N paced replicas
    overlap as N PIM-rank fleets would, and wall-clock serving experiments
    (executor overlap, autoscaling, routing) measure the modeled
    hardware's capacity rather than the host's or the card's.

    Results are bit-identical to the inner engine; only timing changes.
    Warmup batches (``n_valid=0``) are never paced.
    """

    def __init__(self, engine: "SearchEngine", nprobe: int, ranks: int,
                 task_latency_s: float):
        if ranks < 1:
            raise ValueError(f"ranks must be >= 1, got {ranks}")
        if task_latency_s <= 0:
            raise ValueError(f"task_latency_s must be positive, "
                             f"got {task_latency_s}")
        self.engine = engine
        self.k = engine.k
        self.nprobe = int(nprobe)
        self.ranks = int(ranks)
        self.task_latency_s = float(task_latency_s)
        self.paced_batches = 0

    def batch_latency_s(self, n_valid: int) -> float:
        """Modeled service time for a batch of ``n_valid`` queries."""
        tasks = n_valid * self.nprobe
        waves = -(-tasks // self.ranks)
        return waves * self.task_latency_s

    # the runtime's optional engine hooks forward to the inner engine
    # (lut_cache as a real property so warmup's throwaway-cache swap
    # reaches the engine that consults it)
    @property
    def lut_cache(self):
        return getattr(self.engine, "lut_cache", None)

    @lut_cache.setter
    def lut_cache(self, cache):
        self.engine.lut_cache = cache

    def __getattr__(self, name):
        if name == "engine":        # guard: never recurse pre-__init__
            raise AttributeError(name)
        return getattr(self.engine, name)

    def search_batch(self, queries: np.ndarray,
                     n_valid: Optional[int] = None,
                     budget_s: Optional[float] = None,
                     tenants: Optional[np.ndarray] = None,
                     terms: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        kw = {k: v for k, v in (("budget_s", budget_s),
                                ("tenants", tenants),
                                ("terms", terms)) if v is not None}
        d, i = self.engine.search_batch(queries, n_valid=n_valid, **kw)
        n = n_valid if n_valid is not None else len(queries)
        if n > 0:
            remaining = self.batch_latency_s(n) - (time.perf_counter() - t0)
            if remaining > 0:
                time.sleep(remaining)
            self.paced_batches += 1
        return d, i


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

    Thread-safe: arrivals are recorded on the submitting (router) thread
    while batch/done records come from the replica's executor worker, so
    one lock guards the lists and ``summary()`` reads a consistent
    snapshot."""

    def __init__(self):
        self.latencies_s: List[float] = []
        self.batches: List[BatchRecord] = []
        self.queue_depths: List[int] = []
        self.t_first_arrival: Optional[float] = None
        self.t_last_done: Optional[float] = None
        self.deadline_missed = 0
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
            if req.deadline_missed:
                self.deadline_missed += 1
            if self.t_last_done is None or req.t_done > self.t_last_done:
                self.t_last_done = req.t_done

    def recent_latencies(self, n: int = 64) -> List[float]:
        """Last ``n`` served latencies (the autoscaler's p99 window)."""
        with self._lock:
            return self.latencies_s[-n:]

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
                "deadline_missed": self.deadline_missed,
            }


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingConfig:
    """Bucket-policy and flush knobs.

    ``deadline_s`` > 0 arms deadline-bounded serving: each batch's budget
    is ``oldest arrival + deadline_s - service start``, passed to the
    engine (only a tiered engine, not ported, degrades on it), and every
    served request is stamped ``deadline_missed`` when its completion ran
    past its deadline.
    """
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    max_wait_s: float = 2e-3          # deadline flush bound
    max_batch: Optional[int] = None   # default: largest bucket
    deadline_s: float = 0.0           # 0 = no per-request deadline

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
        _warn_direct_use("ServingRuntime")
        self.engine = engine
        self.config = config or ServingConfig()
        self.batcher = self.config.make_batcher()
        self.stats = ServingStats()
        self.replica_idx: Optional[int] = None

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
    def submit(self, query: np.ndarray, now: float,
               attach: Optional[Callable[[Request], None]] = None
               ) -> Request:
        """Queue one request; ``attach(req)`` binds a future under the
        batcher lock (see ``MicroBatcher.submit``)."""
        req = self.batcher.submit(query, now, attach=attach)
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
        kwargs: dict = {}
        # deadline budget: seconds (on the driving clock) until the
        # batch's oldest request blows its deadline
        if self.config.deadline_s > 0 and batch.requests:
            deadline = (min(r.t_arrival for r in batch.requests)
                        + self.config.deadline_s)
            kwargs["budget_s"] = deadline - t_start
        t0 = time.perf_counter()
        try:
            d, i = self.engine.search_batch(batch.queries,
                                            n_valid=batch.n_valid, **kwargs)
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
            if self.config.deadline_s > 0:
                req.deadline_missed = (
                    t_done > req.t_arrival + self.config.deadline_s)
            self.stats.record_done(req)
            if req.future is not None:
                req.future._resolve(req)
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
