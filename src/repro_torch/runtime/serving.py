"""Online serving runtime: micro-batched streaming search over the engine.

  * :mod:`repro_torch.runtime.batching` coalesces single-query requests
    into padded micro-batches, flushing on deadline or on a full batch;
  * :class:`LocalEngine` runs the single-device five-phase pipeline
    (``core.search.search_ivfpq``) over an all-resident index, optionally
    backed by the hot-cluster LUT cache (:mod:`repro_torch.runtime.cache`),
    or over a tiered store (:mod:`repro_torch.storage`) and the two-level
    coarse quantizer (:mod:`repro_torch.core.coarse2`);
  * :class:`ShardedEngine` serves ``core.sharded_search.DistributedEngine``
    (layout-sharded clusters, scheduled scans, optional LUT cache);
  * :class:`PimPacedEngine` paces any engine's batches to their modeled
    DRAM-PIM service time (results unchanged);
  * :class:`ServingRuntime` offers a submit/step online API plus a
    virtual-clock stream simulator with latency/throughput
    instrumentation (p50/p99, queue depth, batch occupancy), and the
    ``engine.straggler`` / ``engine.batch`` chaos sites when ``faults``
    is armed (:mod:`repro_torch.runtime.faults`).

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

from repro_torch.core.filter import NO_TAG, Scope, VectorMeta
from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.search import (SearchParams, cluster_locate,
                                     cluster_locate_masked, dc_ts,
                                     dc_ts_tasks, lc, rc_from_probes,
                                     search_ivfpq)
from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request)
from repro_torch.runtime.cache import (HotClusterLUTCache, lut_fill_misses,
                                       lut_miss_scan, precompile_lut_shapes,
                                       stack_lut_bank)
from repro_torch.runtime.faults import InjectedFault
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

    Without a cache, tier or two-level CL a batch is one ``search_ivfpq``.
    With any of them it runs :meth:`_search_tasks`, one ``query_chunk``
    at a time.  With ``lut_cache`` set, LC consults the hot-cluster LUT
    cache per (query, probed cluster) pair and builds tables for the
    misses only (one batched LC over the miss rows, through the LC
    kernels on the card); CL, RC, DC and TS are the cache-off pipeline's
    own steps (``cluster_locate`` on the fixed block, ``rc_from_probes``,
    ``dc_ts``), so at exact granularity an f32 hit gives the same numbers
    as the cache-off search.  Host seconds of each phase accumulate in
    :attr:`phase_s` (``route``, ``observe``, ``rc``, ``lut_scan``,
    ``lut_fill``, ``bank``, ``rc_lc``, ``fetch``, ``dc_ts``; each ends
    where the host next needs the device's result, so device time is
    inside).

    Live-index support: ``(index, clusters)`` live in one ``_view`` tuple
    read exactly once per batch, and ``install`` swaps the whole tuple --
    a single attribute store -- so a mutation landing mid-batch can never
    mix old centroids with new codes.  ``install`` with a new *index* (a
    generation swap: centroids / codebooks changed) also bumps the view
    generation that salts every LUT-cache bucket, so a stale in-flight
    batch cannot poison the cache for the new generation.

    Beyond-memory serving: with ``tiered_store`` (a :class:`~repro_torch.
    storage.TieredStore`) the engine holds no ``PaddedClusters``
    (``clusters=None``): CL routes as usual, the probes' heat feeds the
    store's residency controller, and each chunk's codes, ids and sizes
    are fetched through the store (the slab on the card, or the spill on
    the host) and scanned by ``core.search.dc_ts_tasks``.  With
    ``coarse`` (a :class:`~repro_torch.core.coarse2.Coarse2`) CL ranks
    only the top ``coarse_nprobe1`` groups' member centroids (default:
    all groups).  The fetched bytes equal ``pad_clusters``'s, so a tiered
    batch equals the all-resident search bit for bit; under deadline
    pressure (``budget_s``) cold probes are shed and ``last_batch_info``
    reports the batch degraded.

    Tenant namespaces and predicate filters: with ``meta`` (a
    :class:`~repro_torch.core.filter.VectorMeta`) ``search_batch`` takes
    per-query ``tenants`` and ``terms``.  A scoped batch ranks only its
    tenants' member clusters in CL (``cluster_locate_masked``, on the
    same fixed block, so an unscoped row of a mixed batch probes as the
    unscoped path does) and strikes out-of-scope rows to ``+inf`` between
    DC and TS: it runs :meth:`_search_tasks` (the reference's fused
    scoped pipeline, one chunk at a time), with or without a cache or a
    tier.  LC and DC go through the same kernels as unscoped traffic; the
    fused DC+TS kernels cannot take the mask and are not used.  Scope
    together with the two-level CL is refused, as in the reference.
    """

    def __init__(self, index: IVFPQIndex, clusters: Optional[PaddedClusters],
                 params: SearchParams,
                 lut_cache: Optional[HotClusterLUTCache] = None,
                 tiered_store=None, coarse=None, coarse_nprobe1: int = 0,
                 meta: Optional[VectorMeta] = None):
        _warn_direct_use("LocalEngine")
        if clusters is None and tiered_store is None:
            raise ValueError("clusters may be omitted only with a "
                             "tiered_store (codes then live in the tier)")
        if lut_cache is not None and lut_cache.lut_dtype != params.lut_dtype:
            raise ValueError(
                f"lut_cache.lut_dtype={lut_cache.lut_dtype!r} disagrees "
                f"with SearchParams.lut_dtype={params.lut_dtype!r}; cached "
                f"and uncached scans must run the same dtype")
        self._view = (index, clusters, 0)
        self.params = params
        self.lut_cache = lut_cache
        self.tiered_store = tiered_store
        self.coarse = coarse
        self.coarse_nprobe1 = (int(coarse_nprobe1) if coarse_nprobe1
                               else (coarse.n_groups if coarse is not None
                                     else 0))
        self.k = params.k
        self.device = index.centroids.device
        # per-vector metadata for tenant-scoped / predicate-filtered
        # search; None = the single-tenant engine
        self.meta = meta
        self.phase_s: dict = {}
        # per-batch degrade report, re-stamped by every search_batch call;
        # the serving runtime reads it to flag requests as degraded
        self.last_batch_info: dict = {"degraded": False, "dropped_probes": 0}

    # the (index, clusters) pair is one atomic view; the split properties
    # keep the attribute surface working
    @property
    def index(self) -> IVFPQIndex:
        return self._view[0]

    @index.setter
    def index(self, index: IVFPQIndex) -> None:
        self.install(index=index)

    @property
    def clusters(self) -> PaddedClusters:
        return self._view[1]

    @clusters.setter
    def clusters(self, clusters: PaddedClusters) -> None:
        self.install(clusters=clusters)

    @property
    def view_generation(self) -> int:
        return self._view[2]

    def install(self, index: Optional[IVFPQIndex] = None,
                clusters: Optional[PaddedClusters] = None) -> None:
        """Atomically swap the engine onto new index tensors.

        ``clusters``-only installs are plain data mutations (upserts /
        deletes): LUTs depend only on (query, centroid, codebook), so
        cached entries stay valid.  Passing ``index`` means the quantizers
        changed (a maintenance generation): the view generation is bumped
        so cache keys from older views can never be hit again, even by a
        batch that was in flight across the swap."""
        cur_index, cur_clusters, gen = self._view
        self._view = (index if index is not None else cur_index,
                      clusters if clusters is not None else cur_clusters,
                      gen + 1 if index is not None else gen)

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
        host.  ``budget_s`` (seconds left before the batch's deadline)
        only matters to the tiered path.  ``tenants`` (B,) i32 (-1 =
        unscoped) / ``terms`` (B, W) u32 (NO_TAG pad) scope the rows; a
        batch with neither runs the unscoped paths."""
        self.last_batch_info = {"degraded": False, "dropped_probes": 0}
        queries = np.asarray(queries, np.float32)
        scope = self._make_scope(tenants, terms, len(queries))
        view = self._view                     # one atomic read per batch
        if (scope is not None or self.lut_cache is not None
                or self.tiered_store is not None
                or self.coarse is not None):
            return self._search_tasks(queries, n_valid, budget_s, view,
                                      scope)
        q = torch.from_numpy(queries).to(self.device)
        d, i = search_ivfpq(view[0], view[1], q, self.params)
        return d.cpu().numpy(), i.cpu().numpy()

    def _make_scope(self, tenants, terms, n: int) -> Optional[Scope]:
        """The batch's :class:`~repro_torch.core.filter.Scope`, or None
        for unscoped traffic (which then stays on the unscoped paths)."""
        scope = Scope.make(self.meta, tenants, terms, n, self.device)
        if scope is not None and self.coarse is not None:
            raise ValueError("scoped search is not supported with the "
                             "two-level coarse router (spec validation "
                             "rejects tenants + coarse_groups)")
        return scope

    def serving_info(self) -> dict:
        """Engine-side metrics block (routing mode, tier residency)."""
        out: dict = {"engine": "local", "device": str(self.device)}
        if self.coarse is not None:
            out["coarse"] = {"n_groups": self.coarse.n_groups,
                             "nprobe1": self.coarse_nprobe1}
        if self.tiered_store is not None:
            out["tier"] = self.tiered_store.serving_info()
        return out

    def precompile_lc(self, max_rows: int) -> None:
        """Run the cached path's miss-batch LC shapes (powers of two up to
        ``max_rows``) once ahead of traffic."""
        precompile_lut_shapes(self.index.codebook, max_rows,
                              lut_dtype=self.params.lut_dtype)

    def _cached_lut(self, queries: np.ndarray, n_valid: int,
                    flat_probes: np.ndarray, npr: int,
                    flat_res: torch.Tensor, index: IVFPQIndex, vgen: int):
        """One chunk's tables through the LUT cache: hits from the cache,
        misses built by LC over the chunk's own residual rows."""
        cache = self.lut_cache
        t0 = time.perf_counter()
        # one hash per valid query, reused across its nprobe cache keys;
        # the view generation salts the bucket, so entries of a superseded
        # generation (older centroids / codebooks) can never hit
        buckets = [(vgen, cache.bucket_of(queries[qi]))
                   for qi in range(n_valid)]
        luts, miss_rows = lut_miss_scan(cache, flat_probes, buckets, npr,
                                        len(flat_probes))
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
        self._clock("bank", t0)
        return lut

    def _route(self, queries: torch.Tensor, index: IVFPQIndex) -> torch.Tensor:
        """CL, flat or two-level, for one chunk -> probes (Qc, P).  Flat
        CL runs on the fixed (query_chunk, D) block, as ``cl_rc``; with a
        :class:`~repro_torch.core.coarse2.Coarse2` routing scores
        ``n_groups + nprobe1 * gmax`` centroid rows instead of all
        ``nlist`` (at ``nprobe1 == n_groups`` the probe set is flat CL's
        up to near-ties)."""
        p = self.params
        if self.coarse is None:
            return cluster_locate(queries, index.centroids, p.nprobe,
                                  block=p.query_chunk)[0]
        from repro_torch.core.coarse2 import coarse2_locate
        return coarse2_locate(self.coarse, queries, nprobe=p.nprobe,
                              nprobe1=self.coarse_nprobe1,
                              block=p.query_chunk)[0]

    @torch.no_grad()
    def _search_tasks(self, queries: np.ndarray, n_valid: Optional[int],
                      budget_s: Optional[float], view: tuple,
                      scope: Optional[Scope] = None):
        """The cached, tiered, two-level and scoped path: route, then per
        chunk the tables (cache or LC), the codes (the clusters, or the
        tier's slab hit or batched spill read), DC + TS.  With ``scope``
        CL is masked to the tenants' member clusters and the scope mask
        runs between DC and TS.

        CL runs for the whole batch first, so the probe heat of the valid
        rows feeds the tier's residency controller once per batch and
        *before* the fetch (a sustained shift promotes clusters ahead of
        the reads that want them), and the deadline check sees the whole
        batch's cold clusters.  Then one ``query_chunk`` at a time: RC,
        LC (the cache, or the LC kernels), the fetch (one deduplicated
        spill read per chunk), DC + TS.  Padding rows (>= n_valid)
        bypass the cache entirely (no LRU slot, no hit or miss), feed no
        heat and are never shed.

        Fail-operational: the fetch runs through ``TieredStore.
        gather_degraded``; probes the tier cannot serve (quarantined
        clusters, or *all* cold probes when ``budget_s`` says the
        predicted cold-fetch cost would blow the deadline) come back with
        size 0, so the scan is exact over what was scanned, and the batch
        is reported degraded in ``last_batch_info``.
        """
        p = self.params
        index, clusters, vgen = view
        tier = self.tiered_store
        qc = p.query_chunk
        nq = len(queries)
        nv = nq if n_valid is None else min(n_valid, nq)
        t0 = time.perf_counter()
        q_all = torch.from_numpy(queries).to(self.device)
        chunks = [(s, q_all[s:s + qc]) for s in range(0, nq, qc)]
        if scope is not None:
            nlist = index.centroids.shape[0]
            probes = [cluster_locate_masked(
                q, index.centroids, p.nprobe,
                scope.allowed(slice(s, s + len(q)), nlist), block=qc)[0]
                for s, q in chunks]
        else:
            probes = [self._route(q, index) for _, q in chunks]
        probes_np = (torch.cat(probes).cpu().numpy() if probes
                     else np.zeros((0, p.nprobe), np.int64))
        t0 = self._clock("route", t0)
        resident_only = False
        if tier is not None:
            if nv > 0:
                tier.observe(probes_np[:nv])
            # deadline-at-risk check: if the predicted cold-fetch cost
            # (online EWMA of measured cold fetches) would overrun the
            # remaining budget, drop cold probes and serve resident-only
            if budget_s is not None:
                flat = probes_np[:nv].reshape(-1)   # padding is not shed
                n_cold = int(np.unique(flat[~tier.resident_mask[flat]]).size)
                resident_only = bool(n_cold) and (
                    budget_s <= 0
                    or tier.estimate_cold_seconds(n_cold) > budget_s)
            t0 = self._clock("observe", t0)
        outs, n_dropped = [], 0
        for (s, q), pr in zip(chunks, probes):
            nv_chunk = min(max(nv - s, 0), len(q))
            flat_probes = probes_np[s:s + len(q)].reshape(-1)
            t0 = time.perf_counter()
            flat_res = rc_from_probes(q, index.centroids, index.rotation, pr)
            if self.lut_cache is not None:    # clocks its own phases
                self._clock("rc", t0)
                lut = self._cached_lut(queries[s:s + qc], nv_chunk,
                                       flat_probes, pr.shape[1], flat_res,
                                       index, vgen)
            else:
                lut = lc(flat_res, index.codebook, p)
                t0 = self._clock("rc_lc", t0)
            t0 = time.perf_counter()
            mask = (None if scope is None
                    else scope.masker(slice(s, s + len(q))))
            if tier is None:
                d, i = dc_ts(lut, pr, clusters, p, mask)
            else:
                codes, ids, sizes, dropped = tier.gather_degraded(
                    flat_probes, resident_only=resident_only)
                n_dropped += int(dropped[:nv_chunk * pr.shape[1]].sum())
                t0 = self._clock("fetch", t0)
                d, i = dc_ts_tasks(lut, codes, ids, sizes, len(q), p, mask)
            outs.append((d.cpu().numpy(), i.cpu().numpy()))
            t0 = self._clock("dc_ts", t0)
        if n_dropped:
            self.last_batch_info = {"degraded": True,
                                    "dropped_probes": n_dropped}
        if not outs:
            return (np.zeros((0, p.k), np.float32),
                    np.zeros((0, p.k), np.int32))
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))


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

    @property
    def last_batch_info(self) -> dict:
        return self.engine.last_batch_info

    @property
    def meta(self):
        return self.engine.meta

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
        self.degraded_requests = 0
        self.deadline_missed = 0
        # per-tenant latencies: tenant id -> latency list; unscoped
        # requests (tenant -1) stay out of the breakdown
        self.tenant_latencies: dict = {}
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
            if req.tenant >= 0:
                self.tenant_latencies.setdefault(req.tenant,
                                                 []).append(req.latency_s)
            if req.degraded:
                self.degraded_requests += 1
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
            tenants = {
                int(t): {
                    "requests": len(ls),
                    "p50_ms": _percentile(ls, 50) * 1e3,
                    "p99_ms": _percentile(ls, 99) * 1e3,
                    "qps": len(ls) / span if span > 0 else float("nan"),
                } for t, ls in sorted(self.tenant_latencies.items())}
            return {
                **({"tenants": tenants} if tenants else {}),
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
                "degraded_requests": self.degraded_requests,
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
    engine (a tiered engine sheds its cold probes on it), and every
    served request is stamped ``deadline_missed`` when its completion ran
    past its deadline.
    """
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    max_wait_s: float = 2e-3          # deadline flush bound
    max_batch: Optional[int] = None   # default: largest bucket
    deadline_s: float = 0.0           # 0 = no per-request deadline
    filter_width: int = 4             # predicate terms per query

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
        # chaos hooks (runtime.faults): the service arms this with a
        # FaultInjector; None leaves both sites in _serve a dead branch
        self.faults = None

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
            if getattr(self.engine, "meta", None) is not None:
                # scoped traffic runs its own steps (masked CL, the scope
                # mask): run them per bucket too, with a tenant present
                w = self.config.filter_width
                for b in self.batcher.policy.buckets:
                    self.engine.search_batch(
                        np.zeros((b, d), np.float32), n_valid=0,
                        tenants=np.zeros(b, np.int32),
                        terms=np.full((b, w), NO_TAG, np.uint32))
            if cache is not None:
                self.engine.precompile_lc(self.batcher.policy.max_batch
                                          * self.engine.nprobe)
        finally:
            if cache is not None:
                self.engine.lut_cache = cache

    # -- online API --------------------------------------------------------
    def submit(self, query: np.ndarray, now: float,
               attach: Optional[Callable[[Request], None]] = None,
               tenant: int = -1, terms: tuple = ()) -> Request:
        """Queue one request; ``attach(req)`` binds a future under the
        batcher lock (see ``MicroBatcher.submit``).  ``tenant`` >= 0
        scopes the search to that tenant's rows; ``terms`` are predicate
        tags (OR semantics) filtered inside the scan's mask."""
        req = self.batcher.submit(query, now, attach=attach, tenant=tenant,
                                  terms=terms)
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
        slept = 0.0
        if self.faults is not None:          # chaos sites (armed only)
            rule = self.faults.fire("engine.straggler",
                                    replica=self.replica_idx)
            if rule is not None and rule.delay_s > 0:
                time.sleep(rule.delay_s)
                slept = rule.delay_s
            rule = self.faults.fire("engine.batch",
                                    replica=self.replica_idx)
            if rule is not None:
                # raised before the engine call: nothing of this batch
                # was launched on the card
                err = InjectedFault("engine.batch",
                                    f"replica {self.replica_idx}")
                raise BatchServeError(batch, err) from err
        # deadline budget: seconds (on the driving clock) until the
        # batch's oldest request blows its deadline, computed after the
        # straggler sleep and charged the slept time, so the degrade
        # decision never over-commits to a cold fetch that must miss
        if self.config.deadline_s > 0 and batch.requests:
            deadline = (min(r.t_arrival for r in batch.requests)
                        + self.config.deadline_s)
            kwargs["budget_s"] = deadline - (t_start + slept)
        # scoped batches carry per-row tenant / term arrays; unscoped
        # batches pass nothing, so the engine stays on its unscoped path
        if batch.scoped:
            kwargs["tenants"], kwargs["terms"] = batch.scope_arrays(
                self.config.filter_width)
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
        # engines that can degrade report it per batch (set fresh on every
        # search_batch call, so a stale read is impossible)
        info = getattr(self.engine, "last_batch_info", None)
        degraded = bool(info and info.get("degraded"))
        for row, req in enumerate(batch.requests):   # de-pad: rows [0, n)
            req.dists = np.asarray(d[row])
            req.ids = np.asarray(i[row])
            req.t_flush = batch.t_flush
            req.t_service_start = t_start
            req.t_done = t_done
            req.degraded = degraded
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
