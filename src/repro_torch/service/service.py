"""AnnService: the one front door to the DRIM-ANN serving stack.

The port of ``repro/service/service.py``:

    spec = ServiceSpec(engine="sharded", replicas=3, router="cache_aware",
                       cache_capacity=4096, nprobe=8, k=10)
    svc = AnnService.build(spec, points)        # index + engines + runtimes
    svc.warmup()                                # first launch of every shape
    d, i = svc.search(queries)                  # synchronous batch
    fut = svc.submit_async(q)                   # futures-based lifecycle
    d1, i1 = fut.result(timeout=1.0)            #   (executor-backed)
    reqs = svc.stream(trace)                    # virtual-clock replay
    reqs = svc.stream(trace, clock="wall")      # real executor overlap
    svc.stats()                                 # per-replica + aggregate
    svc.shutdown()

With ``ServiceSpec(mutable=True)`` the service is built over a mutable
:class:`~repro_torch.core.mutable_index.Index` handle and ``upsert`` /
``delete`` / ``run_maintenance`` come alive; a :class:`~repro_torch.
service.mutation.MutationCoordinator` fans every mutation and every
maintenance generation out to the replicas.

The service owns N identical replicas, each an engine (``LocalEngine``
over ``search_ivfpq`` or ``ShardedEngine`` over ``DistributedEngine``)
with its own hot-cluster LUT cache and heat estimator behind its own
``ServingRuntime`` micro-batcher, and a :class:`~repro_torch.service.
router.Router` that assigns every incoming query to one replica.
Replicas share the index (and, for the local engine, the padded cluster
tensors), so results are routing-independent.

The service runs where its index lives: ``build`` from points puts the
index on ``device`` (default the card; without CUDA that raises), and a
given index keeps its device.  On the card every engine goes through the
hand-written kernels (``kernels.ops``); a failed batch is retried on
another replica, never on the CPU.  CL for the router and for the
sharded engine's heat sample runs on the index's device on fixed
``CL_BLOCK``-row blocks (``core.sharded_search.locate_probes``), as the
engines' own CL does, so the router's probes are the engine's probes.

Request lifecycle: ``submit_async`` routes the query, enqueues it on the
chosen replica's micro-batcher and returns a :class:`~repro_torch.service.
executor.SearchFuture`; the replica's :class:`~repro_torch.service.
executor.ReplicaExecutor` worker flushes on deadline or full, serves on
the wall clock and resolves the future.  A replica failing mid-batch
fails only that batch's futures, and each affected request is retried on
another healthy replica (``runtime.fault_tolerance.ReplicaHealth``).
``stream`` replays one arrival trace on the virtual clock (a
deterministic discrete-event model) or on the wall clock (the executor
path); with ``ServiceSpec.replicas_max`` set an
:class:`~repro_torch.service.autoscale.Autoscaler` moves the live fleet
between batches.

With ``ServiceSpec(storage="tiered", storage_budget_bytes=...)`` the
index's codes spill to ``storage_dir`` (when None, a fresh temporary
directory that ``shutdown`` removes) and the replicas share one
:class:`~repro_torch.storage.TieredStore` that keeps the hot clusters on
the index's device: local replicas fetch probed clusters through it, sharded ones hold its
resident clusters in their shards and scan the rest through it.
``coarse_groups`` gives local replicas the two-level coarse quantizer
(one :class:`~repro_torch.core.coarse2.Coarse2` per handle).

Multi-tenant serving: ``build(tenants=, tags=)`` (or a spec with a
``tenants`` section) attaches a :class:`~repro_torch.core.filter.
VectorMeta` to the index handle, and ``search`` / ``submit`` /
``submit_async`` / ``stream`` take a ``tenant`` (name or id) and
``terms`` (predicate tags): each engine ranks only the tenant's member
clusters and masks out-of-scope rows before top-k.  Per-tenant QoS rides
in front (:mod:`repro_torch.service.tenancy`): a registered tenant over
its token-bucket quota is refused with :class:`TenantThrottled`, and with
``spec.qos_wfq`` the executor path holds requests in a
:class:`~repro_torch.service.tenancy.WFQScheduler` and dispatches them
in weighted fair order.  ``stats()`` gains per-tenant p50 / p99 / QPS /
shed counts and the scheduler's counters.

Fail-operational serving: ``build(fault_injector=)`` arms one
:class:`~repro_torch.runtime.faults.FaultInjector` on every chaos site
of the stack (each replica's runtime, the index's tiered store, the
mutation coordinator; replicas added by ``scale_to`` too), and
``stats()`` gains its per-site ledger under ``"faults"``.  The canonical
experiment is :mod:`repro_torch.service.chaos`.

Invariants (held in tests/test_torch_service.py):
  * 1 replica, local engine, no cache: ``search`` is exactly
    ``search_ivfpq`` (same call, same bits);
  * per-query neighbour sets are identical across replica counts,
    router policies, stream clocks and autoscale events;
  * serving-batch padding rows never reach the router's heat estimators.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.filter import VectorMeta, pad_terms
from repro_torch.core.ivf import IVFPQIndex
from repro_torch.core.mutable_index import Index
from repro_torch.core.search import SearchParams
from repro_torch.core.sharded_search import (DistributedEngine, EngineConfig,
                                             locate_probes)
from repro_torch.runtime.batching import MicroBatch, Request
from repro_torch.runtime.cache import (HeatAwareAdmission, HotClusterLUTCache,
                                       OnlineHeatEstimator)
from repro_torch.runtime.fault_tolerance import ReplicaHealth
from repro_torch.runtime.serving import (LocalEngine, PimPacedEngine,
                                         ServingConfig, ServingRuntime,
                                         ShardedEngine, _percentile,
                                         service_construction)
from repro_torch.service.autoscale import Autoscaler, ScaleSignals
from repro_torch.service.executor import ReplicaExecutor, SearchFuture
from repro_torch.service.router import Router, make_policy
from repro_torch.service.spec import ServiceSpec
from repro_torch.service.tenancy import TenantRegistry, WFQScheduler


class ServiceOverloaded(RuntimeError):
    """Raised by the submit path when ``spec.queue_bound`` in-flight
    requests are already queued: under overload the service degrades to
    fast rejection instead of letting the queue grow without bound."""


class TenantThrottled(ServiceOverloaded):
    """Raised by the submit path when a tenant's token bucket is out of
    tokens (``ServiceSpec.tenants`` rate_qps / burst): per-tenant
    admission control sheds that tenant's excess instead of letting it
    queue ahead of everyone else.  A :class:`ServiceOverloaded`, so
    overload-aware callers need no new handler."""


@dataclasses.dataclass
class Replica:
    """One engine + runtime lane of the service."""
    runtime: ServingRuntime
    engine: object                     # LocalEngine | ShardedEngine adapter
    core: object                       # LocalEngine | DistributedEngine
    cache: Optional[HotClusterLUTCache]
    heat_estimator: Optional[OnlineHeatEstimator]

    @property
    def queue_depth(self) -> int:
        return self.runtime.batcher.depth


class AnnService:
    """Facade over index + replicas + router + serving runtimes.

    Build with :meth:`build`; the constructor itself is wiring-only and
    takes already-constructed parts.
    """

    def __init__(self, spec: ServiceSpec, index: Index,
                 replicas: Sequence[Replica], router: Router):
        self.spec = spec
        self.index = index                 # the unified Index handle
        self.replicas: List[Replica] = list(replicas)
        self.router = router
        self.health = ReplicaHealth(
            len(self.replicas),
            max_consecutive=spec.breaker_threshold,
            half_open_after_s=spec.breaker_half_open_s)
        self.autoscaler: Optional[Autoscaler] = None
        if spec.replicas_max:
            self.autoscaler = Autoscaler(
                spec.replicas, spec.replicas_max,
                queue_high=spec.autoscale_queue_high,
                queue_low=spec.autoscale_queue_low,
                p99_budget_s=(spec.autoscale_p99_budget_ms * 1e-3
                              if spec.autoscale_p99_budget_ms else None),
                cooldown=spec.autoscale_cooldown)
        self._live = len(self.replicas)
        self._executors: List[ReplicaExecutor] = []
        self._batch_rr = 0
        self._retries = 0
        self._shed = 0                 # submits rejected by queue_bound
        # seeded jitter for retry backoff: deterministic given the spec,
        # uncorrelated across retries
        self._retry_rng = np.random.default_rng(spec.index.seed + 0x5EED)
        # chaos: build(fault_injector=...) arms the whole stack through
        # _arm_faults; None leaves every site hook a dead branch
        self.faults = None
        # serializes retry-target selection (worker threads) against
        # live-set updates (scale_to on the driver thread): a retry can
        # never be routed to a replica the autoscaler is draining
        self._scale_lock = threading.Lock()
        self._warmed = False
        self._closed = False
        self._virtual_used = False   # clock-domain latch (see _check_*_ok)
        # scale-out context, stashed by build(); scale_to() builds more
        # replicas from it when the fleet grows past the built set
        self._sample_probes = None
        self._sample_queries = None       # re-probed after a generation
        self._serving_cfg = self._serving_config(spec)
        self._own_spill_dir: Optional[str] = None    # set by build()
        # multi-tenant QoS: name <-> id registry + token buckets, and
        # (qos_wfq) weighted fair queueing on the executor path
        self.tenancy: Optional[TenantRegistry] = (
            TenantRegistry(spec.tenants) if spec.tenants else None)
        self.wfq: Optional[WFQScheduler] = None
        if spec.qos_wfq:
            window = spec.qos_window or (
                len(self.replicas) * max(spec.buckets))
            self.wfq = WFQScheduler(self.tenancy, window)
        # sticky WFQ dispatch anchor: (replica, dispatches left), see
        # _dispatch_executor
        self._wfq_anchor = (-1, 0)
        # the mutation coordinator (wired by build() when spec.mutable)
        self.mutator = None
        for i, rep in enumerate(self.replicas):
            rep.runtime.replica_idx = i

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, spec: ServiceSpec, points=None, *,
              index=None, sample_queries=None, device="cuda",
              tenants=None, tags=None,
              fault_injector=None) -> "AnnService":
        """Stand up the whole service from a validated spec.

        Either ``points`` (index built per ``spec.index`` on ``device``)
        or a prebuilt ``index`` must be given: an :class:`~repro_torch.
        core.mutable_index.Index` handle or a raw ``IVFPQIndex`` (wrapped;
        it keeps its device).  With ``spec.mutable`` the service is built
        over a *mutable* handle (needs ``points``, or an already-mutable
        handle) and ``upsert`` / ``delete`` / ``run_maintenance`` come
        alive.  With ``spec.storage == "tiered"`` the handle spills its
        codes (a prebuilt handle must have been built that way).
        ``sample_queries`` seeds the sharded engine's heat estimate
        (falls back to a slice of the corpus).

        ``tenants`` (per-vector owning tenant ids, (N,) int, -1 =
        unscoped) and ``tags`` (per-vector predicate tags, (N, <=
        filter_width) u32) attach a :class:`~repro_torch.core.filter.
        VectorMeta` to the index handle; with ``spec.tenants`` set it is
        attached even when both are None (rows are then scoped by tagged
        upserts).  ``fault_injector`` (a :class:`~repro_torch.runtime.
        faults.FaultInjector`) arms every chaos site of the stack, for
        the chaos harness and fault-injection tests; None (production)
        leaves every hook a dead branch."""
        spec.validate()
        storage_kw = dict(storage=spec.storage, storage_dir=spec.storage_dir,
                          storage_budget_bytes=spec.storage_budget_bytes,
                          storage_promote_margin=spec.storage_promote_margin,
                          storage_checksum=spec.checksum)
        own_dir = None
        if (spec.storage == "tiered" and spec.storage_dir is None
                and not isinstance(index, Index)):
            # a fresh spill directory per build, owned by the service:
            # shutdown removes it (an explicit one is the caller's)
            own_dir = storage_kw["storage_dir"] = tempfile.mkdtemp(
                prefix="ann_tier_")
        try:
            svc = cls._build(spec, points, index, sample_queries, device,
                             storage_kw, tenants, tags)
        except BaseException:
            if own_dir is not None:
                shutil.rmtree(own_dir, ignore_errors=True)
            raise
        svc._own_spill_dir = own_dir
        if fault_injector is not None:
            svc._arm_faults(fault_injector)
        return svc

    @classmethod
    def _build(cls, spec: ServiceSpec, points, index, sample_queries,
               device, storage_kw: dict, tenants=None,
               tags=None) -> "AnnService":
        if index is None:
            if points is None:
                raise ValueError("AnnService.build needs points or index")
            handle = spec.index.build(points, device=device,
                                      mutable=spec.mutable, **storage_kw)
        elif isinstance(index, Index):
            handle = index
            if spec.mutable and not handle.mutable:
                raise ValueError(
                    "spec.mutable=True needs a mutable Index handle -- "
                    "build one with IndexSpec.build(points, mutable=True)")
            if handle.storage != spec.storage:
                raise ValueError(
                    f"spec.storage={spec.storage!r} but the prebuilt Index "
                    f"handle was built storage={handle.storage!r} -- build "
                    f"it with IndexSpec.build(points, storage=...) to "
                    f"match")
        elif isinstance(index, IVFPQIndex):
            # identity-preserving for the static case; with spec.mutable
            # the raw points must come along so maintenance can re-encode
            handle = Index(index, points=points, mutable=spec.mutable,
                           **storage_kw)
        else:
            raise TypeError(f"index must be an Index or an IVFPQIndex, got "
                            f"{type(index).__name__}")

        if spec.tenants or tenants is not None or tags is not None:
            cls._attach_meta(spec, handle, tenants, tags)

        sample = sample_probes = None
        if spec.engine == "sharded":
            sample = sample_queries
            if sample is None:
                if points is None:
                    raise ValueError("sharded engine needs sample_queries "
                                     "(or points to fall back on) for the "
                                     "heat estimate")
                sample = points[:min(256, len(points))]
            sample_probes = locate_probes(sample, handle.centroids,
                                          spec.nprobe)

        serving_cfg = cls._serving_config(spec)
        with service_construction():
            replicas = [cls._build_replica(spec, handle, sample_probes,
                                           serving_cfg)
                        for _ in range(spec.replicas)]

        policy = make_policy(
            spec.router, nlist=handle.nlist, n_replicas=spec.replicas,
            halflife_batches=spec.router_halflife_batches)

        def probe_fn(q: np.ndarray) -> np.ndarray:
            # centroids read through the handle, so routing follows the
            # live generation (maintenance may split / merge clusters)
            return locate_probes(np.asarray(q)[None], handle.centroids,
                                 spec.nprobe)[0]

        svc = cls.__new__(cls)
        router = Router(policy, spec.replicas,
                        depth_fn=lambda r: svc.replicas[r].queue_depth,
                        probe_fn=probe_fn)
        cls.__init__(svc, spec, handle, replicas, router)
        svc._sample_probes = sample_probes
        svc._sample_queries = sample
        if spec.mutable:
            from repro_torch.service.mutation import MutationCoordinator
            svc.mutator = MutationCoordinator(svc)
        return svc

    def _arm_faults(self, injector) -> None:
        """Attach one FaultInjector to every chaos hook in the stack."""
        self.faults = injector
        for rep in self.replicas:
            rep.runtime.faults = injector
        if self.index.tiered_store is not None:
            self.index.tiered_store.faults = injector
        if self.mutator is not None:
            self.mutator.faults = injector

    @staticmethod
    def _attach_meta(spec: ServiceSpec, handle: Index,
                     tenants, tags) -> VectorMeta:
        """Build the id-keyed :class:`VectorMeta` tables for the handle:
        per-vector tenant / tags from the caller's arrays (row i = vector
        id i, the build's id assignment), cluster_of from the handle's
        layout (the padded clusters, or the tier's per-cluster id rows;
        the tables stay on the host either way)."""
        meta = VectorMeta(tag_fields=spec.filter_width)
        n = None
        if tenants is not None:
            tenants = np.asarray(tenants, np.int32).reshape(-1)
            n = tenants.size
        if tags is not None:
            tags = np.asarray(tags, np.uint32)
            if tags.ndim == 1:
                tags = tags[:, None]
            if n is not None and len(tags) != n:
                raise ValueError(
                    f"tenants ({n}) and tags ({len(tags)}) must describe "
                    f"the same vectors")
            n = len(tags)
        if n:
            meta.set(np.arange(n), tenant=tenants, tags=tags)
        tier = handle.tiered_store
        if tier is not None:
            for c in range(handle.nlist):
                _, ids_c = tier.peek(c)
                row = np.asarray(ids_c)[:int(tier.sizes[c])]
                row = row[row >= 0]
                if row.size:
                    meta.set(row, cluster=c)
        else:
            cl = handle.clusters
            meta.rebuild_clusters(cl.ids.cpu().numpy(),
                                  cl.sizes.cpu().numpy())
        handle.meta = meta
        return meta

    @staticmethod
    def _serving_config(spec: ServiceSpec) -> ServingConfig:
        return ServingConfig(buckets=tuple(spec.buckets),
                             max_wait_s=spec.max_wait_s,
                             deadline_s=spec.deadline_ms * 1e-3,
                             filter_width=spec.filter_width)

    @staticmethod
    def _build_replica(spec: ServiceSpec, index: Index,
                       sample_probes, serving_cfg: ServingConfig) -> Replica:
        def make_cache(admission=None):
            if not spec.cache_enabled:
                return None
            return HotClusterLUTCache(
                capacity=spec.cache_capacity or None,
                capacity_bytes=spec.cache_capacity_bytes or None,
                granularity=spec.cache_granularity,
                lut_dtype=spec.lut_dtype,
                admission=admission)

        def pace(engine):
            """PIM-paced serving: wrap the engine so batches take their
            Eq. 15 modeled time on a ``pim_paced_ranks``-rank fleet
            (results unchanged; see runtime.serving.PimPacedEngine).
            With tiered storage the per-task latency also carries the
            disk tier's expected cold-probe cost (Eq. 15 + seek/bw), at
            the steady-state cold prior 1 - budget/total."""
            if not spec.pim_paced_ranks:
                return engine
            from repro_torch.core.perf_model import (IndexParams,
                                                     NVME_PROFILE,
                                                     UPMEM_PROFILE,
                                                     cold_probe_seconds,
                                                     lut_width_bytes,
                                                     make_task_latency_model)
            sizes = index.sizes
            ixp = IndexParams(n_total=int(sizes.sum()), nlist=index.nlist,
                              q=1, d=index.dim, k=spec.k, p=spec.nprobe,
                              m=index.codebook.m, cb=index.codebook.cb,
                              b_lut=lut_width_bytes(spec.lut_dtype))
            model = make_task_latency_model(ixp, UPMEM_PROFILE)
            task_s = model.task_latency(float(sizes.mean()))
            tier = index.tiered_store
            if tier is not None:
                cold_prior = max(
                    0.0, 1.0 - tier.budget_bytes / max(tier.total_bytes, 1))
                task_s += cold_prior * cold_probe_seconds(ixp, NVME_PROFILE)
            return PimPacedEngine(
                engine, nprobe=spec.nprobe, ranks=spec.pim_paced_ranks,
                task_latency_s=task_s)

        if spec.engine == "local":
            cache = make_cache()
            coarse = None
            if spec.coarse_groups:
                # one Coarse2 per handle (replicas share it; routing is
                # deterministic in the index seed)
                coarse = getattr(index, "_coarse2_cache", None)
                if coarse is None:
                    import torch

                    from repro_torch.core.coarse2 import build_coarse2
                    coarse = build_coarse2(
                        torch.Generator().manual_seed(spec.index.seed),
                        index.centroids, n_groups=spec.coarse_groups)
                    index._coarse2_cache = coarse
            # the static handle's search_view is the wrapped IVFPQIndex
            # itself: bit-exact identity with a direct search_ivfpq; a
            # mutable one's is the current generation's lean view, and
            # clusters its current snapshot; a tiered one holds no
            # clusters (the engine fetches probed rows through the tier);
            # use_kernels: the device picks kernel (card) or plain version
            tier = index.tiered_store
            core = LocalEngine(index.search_view,
                               None if tier is not None else index.clusters,
                               SearchParams(nprobe=spec.nprobe, k=spec.k,
                                            strategy=spec.strategy,
                                            use_kernels=True,
                                            lut_dtype=spec.lut_dtype),
                               lut_cache=cache, tiered_store=tier,
                               coarse=coarse,
                               coarse_nprobe1=spec.coarse_nprobe1,
                               meta=index.meta)
            return Replica(ServingRuntime(pace(core), serving_cfg), core,
                           core, cache, None)
        est = None
        if spec.heat_aware_admission or spec.relayout_every > 0:
            from repro_torch.core.layout import estimate_heat
            est = OnlineHeatEstimator(
                index.nlist, seed=estimate_heat(sample_probes, index.nlist))
        cache = make_cache(HeatAwareAdmission(est)
                           if spec.heat_aware_admission else None)
        core = DistributedEngine(index.to_ivfpq(),
                                 EngineConfig(**spec.engine_config_kwargs()),
                                 sample_probes, lut_cache=cache,
                                 heat_estimator=est,
                                 tiered_store=index.tiered_store,
                                 meta=index.meta)
        if spec.tune_tasks_per_shard:
            core.tasks_controller = core.make_tasks_controller()
        adapter = ShardedEngine(core)
        return Replica(ServingRuntime(pace(adapter), serving_cfg), adapter,
                       core, cache, est)

    # -- lifecycle ---------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        """Live replica count (the autoscaler moves this inside
        ``[spec.replicas, spec.replicas_max]``)."""
        return self._live

    @property
    def live_replicas(self) -> List[Replica]:
        return self.replicas[:self._live]

    def core_engine(self, replica: int = 0):
        """The underlying engine (LocalEngine / DistributedEngine) of one
        replica: for layout stats, scheduler inspection, ablations."""
        return self.replicas[replica].core

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("AnnService is shut down")

    def _check_virtual_ok(self, what: str) -> None:
        """Virtual-clock APIs simulate time over the replica batchers;
        once executor workers are live they poll those same batchers on
        the wall clock, so mixing the two would race (and mix clock
        domains in the stats).  Fail loudly instead."""
        if any(ex.running for ex in self._executors):
            raise RuntimeError(
                f"{what} uses the virtual clock, but executor workers "
                f"are live (submit_async / stream(clock='wall') started "
                f"them); use clock='wall', or a service that has not "
                f"gone async")
        self._virtual_used = True

    def _check_wall_ok(self, what: str) -> None:
        """The mirror guard: wall-clock timestamps must not land in stats
        that already hold virtual-clock times."""
        if self._virtual_used:
            raise RuntimeError(
                f"{what} stamps wall-clock times, but this service "
                f"already served virtual-clock traffic (submit/step or "
                f"stream(clock='virtual')); its stats would mix clock "
                f"domains: use a fresh service for wall-clock serving")

    def warmup(self) -> None:
        """Run every bucket shape once on every replica (all-padding
        batches: no cache, heat or router state is touched).  On the card
        this loads the kernel libraries before any executor starts."""
        self._check_open()
        for rep in self.replicas:
            rep.runtime.warmup(self.index.dim)
        self._warmed = True

    def shutdown(self) -> dict:
        """Drain the executors, close the service (subsequent calls
        raise) and return final stats.  A wedged worker does not abort the
        shutdown of the rest of the fleet: it is counted in
        ``stats()['aggregate']['wedged_workers']`` and the first wedge
        error is re-raised after every executor had its chance.  An
        in-flight maintenance cycle is joined first.  A spill directory
        that ``build`` created (tiered storage, no ``storage_dir``) is
        removed."""
        if self.mutator is not None:
            self.mutator.close()
        first_err: Optional[BaseException] = None
        for ex in self._executors:
            try:
                ex.shutdown()
            except RuntimeError as err:       # wedged: keep draining rest
                if first_err is None:
                    first_err = err
        out = self.stats()
        self._closed = True
        if self._own_spill_dir is not None:
            shutil.rmtree(self._own_spill_dir, ignore_errors=True)
        if first_err is not None:
            raise first_err
        return out

    # -- mutation API --------------------------------------------------------
    def _require_mutable(self, what: str):
        if self.mutator is None:
            raise RuntimeError(
                f"AnnService.{what} needs a mutable service -- build with "
                f"ServiceSpec(mutable=True) and the points array")
        return self.mutator

    def upsert(self, ids, vectors, *, tenant=None, tags=None) -> dict:
        """Insert or replace vectors in the live index: assign to the
        nearest centroid, encode with the live PQ codebooks, append to the
        per-cluster code rows, and install the new tensors on every
        replica (centroids / codebooks unchanged, so LUT caches stay
        valid).  Visible to the next search batch.  Returns insert /
        replace counts (see :meth:`Index.upsert`).

        ``tenant`` (name or id) / ``tags`` scope the upserted vectors
        (needs a service built with per-vector metadata); omitting them
        stamps the rows unscoped -- a recycled id never inherits its
        previous owner's scope."""
        self._check_open()
        mut = self._require_mutable("upsert")
        if tenant is None and tags is None:
            return mut.upsert(ids, vectors)
        return mut.upsert(ids, vectors,
                          tenant=self._resolve_tenant(tenant), tags=tags)

    def delete(self, ids) -> int:
        """Remove ids from the live index (swap-compacted out of the scan
        mask: a deleted id can never appear in a result) and install on
        every replica.  Returns how many ids were live."""
        self._check_open()
        return self._require_mutable("delete").delete(ids)

    def run_maintenance(self, force: bool = False, wait: bool = True
                        ) -> dict:
        """Run one cluster-maintenance cycle: split / merge clusters that
        drifted past the spec's size band and retrain the PQ codebooks,
        building the next index generation on a background thread and
        installing it on each engine -- searches never block on the
        rebuild.  ``force=True`` rebuilds even when no cluster is out of
        band; ``wait=False`` returns at once."""
        self._check_open()
        return self._require_mutable("run_maintenance").run_maintenance(
            force=force, wait=wait)

    # -- tenant scoping ------------------------------------------------------
    def _resolve_tenant(self, tenant) -> int:
        """Tenant name / int / None -> int id (-1 = unscoped)."""
        if self.tenancy is not None:
            return self.tenancy.resolve(tenant)
        if tenant is None:
            return -1
        if isinstance(tenant, str):
            raise KeyError(f"tenant names need ServiceSpec.tenants; got "
                           f"{tenant!r} on a spec without a tenants "
                           f"section (pass the int tenant id instead)")
        return int(tenant)

    # -- synchronous batch API ---------------------------------------------
    def search(self, queries, tenant=None,
               terms=()) -> Tuple[np.ndarray, np.ndarray]:
        """One batched search, bypassing the micro-batcher (offline /
        bulk callers).  Batches rotate over live replicas round-robin;
        results are replica-independent.  With 1 replica, a local engine
        and no cache this is exactly ``search_ivfpq``.

        ``tenant`` (name or int id) scopes every query of the batch to
        that tenant's rows; ``terms`` (u32 tags, OR semantics) keeps rows
        carrying any of them.  Needs a service built with per-vector
        metadata.  Quotas do not apply on this offline path (admission
        control guards the online submit paths).  The call runs in the
        span ``drim.service.search`` (:mod:`repro_torch.obs`)."""
        with obs.span("drim.service.search"):
            self._check_open()
            r = self._batch_rr % self.n_replicas
            self._batch_rr += 1
            q = np.asarray(queries, np.float32)
            tid = self._resolve_tenant(tenant)
            if tid < 0 and not len(tuple(terms)):
                return self.replicas[r].engine.search_batch(q)
            tenants_arr = np.full(len(q), tid, np.int32)
            terms_arr = pad_terms([tuple(terms)] * len(q),
                                  self.spec.filter_width)
            return self.replicas[r].engine.search_batch(
                q, tenants=tenants_arr, terms=terms_arr)

    # -- async request lifecycle --------------------------------------------
    def _route_and_submit(self, query, now: float, executor: bool,
                          tenant: int = -1, terms=()) -> SearchFuture:
        """The one submit path: route, enqueue, bind a future.  The future
        is attached under the batcher lock, so an executor worker can
        never serve the request before the future exists.

        On the executor path a pick landing on a replica whose breaker
        does not admit traffic (``ReplicaHealth.allow``) is steered to the
        healthiest shallowest alternative.  With ``spec.queue_bound`` set
        the executor path is admission controlled: once that many
        requests are in flight fleet-wide, submits fail fast with
        :class:`ServiceOverloaded`.

        Per-tenant QoS layers in front: a scoped request first passes its
        tenant's token bucket (over quota: :class:`TenantThrottled`, on
        both clock paths), and with ``spec.qos_wfq`` the executor path
        holds the request in the :class:`WFQScheduler`; routing then
        happens at dispatch time (:meth:`_dispatch_executor`)."""
        q = np.asarray(query, np.float32)
        if tenant >= 0 and self.tenancy is not None \
                and not self.tenancy.admit(tenant, now):
            raise TenantThrottled(
                f"tenant {self.tenancy.name_of(tenant)!r} is over its "
                f"token-bucket quota; shedding")
        bound = self.spec.queue_bound
        if bound and executor:
            depth = sum(rep.queue_depth for rep in self.live_replicas)
            if depth >= bound:
                self._shed += 1
                raise ServiceOverloaded(
                    f"queue_bound={bound} in-flight requests already "
                    f"queued (depth={depth}); shedding")
        if executor and self.wfq is not None:
            fut = SearchFuture()
            fut.add_done_callback(self.wfq.on_complete)

            def dispatch(fut=fut, q=q, now=now, tenant=tenant,
                         terms=terms) -> None:
                try:
                    self._dispatch_executor(q, now, tenant, terms, fut)
                except BaseException as err:    # noqa: BLE001 -- the done
                    fut._fail(err)              # callback frees the slot
            self.wfq.submit(tenant, dispatch)
            return fut
        r = self.router.route(q, tenant=tenant)
        if executor and not self.health.allow(r):
            with self._scale_lock:
                alt = self._retry_target(exclude=r)
            if alt is not None:
                r = alt
        cell: List[SearchFuture] = []

        def attach(req: Request, r=r) -> None:
            cell.append(SearchFuture(req, r))

        if executor:
            self._executors[r].submit(q, now=now, attach=attach,
                                      tenant=tenant, terms=terms)
        else:
            self.replicas[r].runtime.submit(q, now, attach=attach,
                                            tenant=tenant, terms=terms)
        return cell[0]

    def _dispatch_executor(self, q: np.ndarray, now: float, tenant: int,
                           terms, fut: SearchFuture) -> None:
        """WFQ dispatch: route (now, not at submit), steer around open
        breakers, bind the held future to the enqueued request.

        WFQ dispatches route by chunked round-robin instead of the spec's
        policy: the fair queue releases requests one per completion, and
        per-request depth-aware routing would march across the fleet with
        every pick, shredding the batches the micro-batcher wants to
        form.  A bucket's worth of consecutive dispatches goes to one
        replica (full batches), then the anchor moves to the next (even
        spread).  Health steering still applies and pick accounting stays
        complete (``Router.record``)."""
        r, left = self._wfq_anchor
        if not (0 <= r < self._live) or left <= 0:
            r = (r + 1) % self._live
            if not self.health.allow(r):
                with self._scale_lock:
                    alt = self._retry_target(exclude=r)
                if alt is not None:
                    r = alt
            left = max(self.spec.buckets)
        self.router.record(r, tenant=tenant)
        self._wfq_anchor = (r, left - 1)

        def attach(req: Request, r=r) -> None:
            fut._bind(req, r)

        self._executors[r].submit(q, now=now, attach=attach,
                                  tenant=tenant, terms=terms)

    def _ensure_executors(self, upto: Optional[int] = None) -> None:
        """Stand up (or top up, after growth) one executor per replica
        and start the first ``upto`` (default: the live set)."""
        while len(self._executors) < len(self.replicas):
            ridx = len(self._executors)
            self._executors.append(ReplicaExecutor(
                self.replicas[ridx].runtime, ridx,
                on_batch_failure=self._on_batch_failure,
                on_batch_success=self.health.record_success,
                join_timeout_s=self.spec.shutdown_timeout_s,
                device=self.index.device))
        for ex in self._executors[:self._live if upto is None else upto]:
            ex.start()

    def submit_async(self, query, now: Optional[float] = None, *,
                     tenant=None, terms=()) -> SearchFuture:
        """Route one query onto an executor-backed replica; returns a
        :class:`SearchFuture` (``result(timeout)``, ``done()``,
        ``timing()``).  The first call starts the replica workers.
        ``tenant`` (name or id) / ``terms`` scope the request; a scoped
        submit may raise :class:`TenantThrottled` (quota) and, under
        ``spec.qos_wfq``, may be held by the fair queue before it reaches
        a replica."""
        self._check_open()
        self._check_wall_ok("submit_async()")
        self._ensure_executors()
        t = float(now) if now is not None else time.monotonic()
        return self._route_and_submit(query, t, executor=True,
                                      tenant=self._resolve_tenant(tenant),
                                      terms=tuple(terms))

    def submit(self, query, now: float, *, tenant=None,
               terms=()) -> Request:
        """Route one query and enqueue it on the chosen replica's
        micro-batcher under the caller's (virtual) clock.  Returns the
        live Request (stamped when served; its ``future`` resolves then
        too); drive completion with :meth:`step`."""
        self._check_open()
        self._check_virtual_ok("submit()")
        return self._route_and_submit(
            query, now, executor=False,
            tenant=self._resolve_tenant(tenant),
            terms=tuple(terms)).request

    def step(self, now: float, drain: bool = False) -> List[Request]:
        """Advance every live replica's flush policy to time ``now``
        (virtual-clock counterpart of the executor workers)."""
        self._check_open()
        self._check_virtual_ok("step()")
        done: List[Request] = []
        for rep in self.live_replicas:
            done.extend(rep.runtime.step(now, drain=drain))
        return done

    # -- fault tolerance (executor path) ------------------------------------
    def _retry_target(self, exclude: int) -> Optional[int]:
        """Healthy live replica with the shallowest queue, never the one
        that just failed; None when the fleet has nowhere to go."""
        cands = [r for r in self.health.healthy()
                 if r < self._live and r != exclude]
        if not cands:
            return None
        return min(cands, key=lambda r: self.replicas[r].queue_depth)

    def _on_batch_failure(self, ridx: int, batch: MicroBatch,
                          cause: BaseException) -> None:
        """A replica died mid-batch: fail only that batch's requests,
        retrying each on another healthy replica.

        Each request carries its own ``retries`` count; a request is
        retried at most ``spec.max_retries`` times, with exponential
        backoff ``backoff_base_ms * 2^attempt`` plus seeded jitter slept
        once per failed batch (on this worker thread, outside the scale
        lock)."""
        self.health.record_failure(ridx)
        live = [req for req in batch.requests if req.future is not None]
        retryable = [req for req in live
                     if req.retries < self.spec.max_retries]
        if retryable and self.spec.backoff_base_ms > 0:
            attempt = min(req.retries for req in retryable)
            delay = (self.spec.backoff_base_ms * 1e-3 * (2 ** attempt)
                     * (0.5 + 0.5 * float(self._retry_rng.random())))
            time.sleep(delay)
        for req in live:
            fut = req.future
            with self._scale_lock:
                target = (self._retry_target(exclude=ridx)
                          if req.retries < self.spec.max_retries else None)
                if target is None:
                    fut._fail(cause)
                    continue
                self._retries += 1

                def attach(new_req: Request, fut=fut, target=target,
                           n=req.retries + 1) -> None:
                    new_req.retries = n
                    fut._rebind(new_req, target)

                # keep the original arrival stamp: the caller has been
                # waiting since then, and stats/autoscaling must see the
                # failover's real latency (the stale deadline also makes
                # the retry flush immediately); the scope rides along --
                # a retried tenant query stays that tenant's
                self._executors[target].submit(req.query,
                                               now=req.t_arrival,
                                               attach=attach,
                                               tenant=req.tenant,
                                               terms=req.terms)

    # -- autoscaling ---------------------------------------------------------
    def scale_to(self, n: int) -> None:
        """Grow/shrink the live fleet to ``n`` replicas (LIFO).

        Growth reuses parked replicas when available, else builds fresh
        ones from the stashed spec context (warmed if the service was).
        Shrink drains the tail executors (queued requests are served
        before the worker parks) and drops their router heat.  Neighbour
        sets are invariant across scale events."""
        self._check_open()
        lo = self.spec.replicas
        hi = self.spec.replicas_max or max(len(self.replicas), lo)
        n = max(lo, min(int(n), hi))
        if n == self._live:
            return
        if n > self._live:
            # under the scale lock, so a mutation's fan-out sees either the
            # replica already built from the handle's current state, or
            # the replica in the list
            with self._scale_lock, service_construction():
                while len(self.replicas) < n:
                    rep = self._build_replica(
                        self.spec, self.index,
                        self._sample_probes, self._serving_cfg)
                    rep.runtime.replica_idx = len(self.replicas)
                    rep.runtime.faults = self.faults
                    if self._warmed:
                        rep.runtime.warmup(self.index.dim)
                    self.replicas.append(rep)
            self.health.resize(len(self.replicas))
            if self._executors:
                # executors must exist and run before _live admits them
                # as retry targets (worker threads index _executors)
                self._ensure_executors(upto=n)
            with self._scale_lock:
                self._live = n
        else:
            with self._scale_lock:
                old_live = self._live
                self._live = n   # retries must not target the tail...
                tail = list(self._executors[n:old_live])
            for ex in tail:      # ...then drain it outside the lock (a
                ex.shutdown()    # failing worker may be waiting on it)
        self.router.resize(self._live)

    def _autoscale_tick(self) -> None:
        """One between-batches autoscaler evaluation (wall-clock stream
        driver); applies the decision immediately."""
        if self.autoscaler is None or not self._executors:
            return
        lat: List[float] = []
        for rep in self.live_replicas:
            lat.extend(rep.runtime.stats.recent_latencies(64))
        breaker = self.health.stats()["breaker"]
        signals = ScaleSignals(
            queue_depths=[rep.queue_depth for rep in self.live_replicas],
            p99_s=(_percentile(lat, 99) if lat else None),
            open_breakers=self.health.open_count(),
            open_mask=[i < len(breaker) and breaker[i] == "open"
                       for i in range(len(self.live_replicas))])
        target = self.autoscaler.decide(signals)
        if target != self._live:
            self.scale_to(target)

    # -- stream drivers ------------------------------------------------------
    def stream(self, arrivals: Sequence[Tuple],
               clock: str = "virtual") -> List[Request]:
        """Replay (t_arrival, query[, tenant]) arrivals across the fleet.

        One submit loop, two drivers:

          * ``clock="virtual"``: multi-server discrete-event model:
            arrivals are routed in time order, each replica serves its
            own flushed batches on its own server-free clock (measured
            engine wall-clock charged onto the virtual timeline), and
            deadline flushes fire in global time order.  No threads.
          * ``clock="wall"``: the executor path in real time: arrival
            gaps are slept, submits go through :meth:`submit_async`,
            replica workers overlap, and (with ``replicas_max`` set) the
            autoscaler moves the live fleet between batches.

        An arrival may carry a third element, its tenant (name or int
        id).  A tenant over its token-bucket quota has that arrival shed
        (counted in ``stats()['tenants'][name]['shed']``, absent from the
        returned list) rather than aborting the replay.  Returns served
        requests in arrival order (same neighbour sets under either
        clock)."""
        self._check_open()
        if clock not in ("virtual", "wall"):
            raise ValueError(f"stream clock must be 'virtual' or 'wall', "
                             f"got {clock!r}")
        if clock == "virtual":
            self._check_virtual_ok("stream(clock='virtual')")
        else:
            self._check_wall_ok("stream(clock='wall')")
        arrivals = sorted(arrivals, key=lambda a: a[0])
        driver = (_WallStreamDriver(self) if clock == "wall"
                  else _VirtualStreamDriver(self))
        interval = self.spec.autoscale_interval
        for i, arrival in enumerate(arrivals):
            t, query = arrival[0], arrival[1]
            tenant = arrival[2] if len(arrival) > 2 else None
            driver.advance_to(t)
            try:
                driver.submit(query, t, tenant=tenant)
            except TenantThrottled:
                pass                    # shed: counted in tenancy stats
            if clock == "wall" and (i + 1) % interval == 0:
                self._autoscale_tick()
        return driver.finish()

    # -- metrics -------------------------------------------------------------
    def stats(self) -> dict:
        """Per-replica runtime metrics plus a fleet-level rollup:
        aggregate p50/p99 over all served requests, QPS over the global
        span, summed LUT-cache hit rate, the router's pick counts, retry
        and replica-health counters, per-tenant latency and shed counts,
        the fair queue's counters, and the autoscaler's event log."""
        per = [rep.runtime.metrics() for rep in self.replicas]
        lat: List[float] = []
        t0s, t1s = [], []
        hits = lookups = 0
        for rep in self.replicas:
            s = rep.runtime.stats
            lat.extend(s.latencies_s)
            if s.t_first_arrival is not None:
                t0s.append(s.t_first_arrival)
            if s.t_last_done is not None:
                t1s.append(s.t_last_done)
            if rep.cache is not None:
                hits += rep.cache.stats.hits
                lookups += rep.cache.stats.lookups
        span = (max(t1s) - min(t0s)) if t0s and t1s else 0.0
        agg = {
            "requests": len(lat),
            "batches": sum(m["batches"] for m in per),
            "p50_ms": _percentile(lat, 50) * 1e3,
            "p99_ms": _percentile(lat, 99) * 1e3,
            "qps": len(lat) / span if span > 0 else float("nan"),
            "retries": self._retries,
            "shed": self._shed,
            "wedged_workers": sum(1 for ex in self._executors
                                  if ex.wedged),
            "degraded": sum(m.get("degraded_requests", 0) for m in per),
            "deadline_missed": sum(m.get("deadline_missed", 0)
                                   for m in per),
        }
        if lookups:
            agg["lut_hit_rate"] = hits / lookups
        out = {"aggregate": agg, "router": self.router.stats(),
               "health": self.health.stats(), "replicas": per}
        tenants = self._tenant_rollup(span)
        if tenants:
            out["tenants"] = tenants
        if self.wfq is not None:
            out["qos"] = self.wfq.stats()
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        if self.mutator is not None:
            out["mutation"] = self.mutator.stats()
        if self.index.tiered_store is not None:
            out["tier"] = self.index.tiered_store.serving_info()
        return out

    def _tenant_rollup(self, span: float) -> dict:
        """Fleet-wide per-tenant p50 / p99 / QPS / shed: every replica
        runtime's per-tenant latencies merged, then the registry's quota
        shed counts laid over them (a registered tenant appears even if
        every one of its requests was shed)."""
        lat: dict = {}
        for rep in self.replicas:
            with rep.runtime.stats._lock:
                items = [(t, list(ls)) for t, ls in
                         rep.runtime.stats.tenant_latencies.items()]
            for tid, ls in items:
                lat.setdefault(int(tid), []).extend(ls)
        if not lat and self.tenancy is None:
            return {}
        name_of = (self.tenancy.name_of if self.tenancy is not None
                   else lambda t: str(t))
        out = {}
        for tid, ls in sorted(lat.items()):
            out[name_of(tid)] = {
                "id": tid,
                "requests": len(ls),
                "p50_ms": _percentile(ls, 50) * 1e3,
                "p99_ms": _percentile(ls, 99) * 1e3,
                "qps": len(ls) / span if span > 0 else float("nan"),
                "shed": 0,
            }
        if self.tenancy is not None:
            for name, info in self.tenancy.stats().items():
                row = out.setdefault(name, {
                    "id": info["id"], "requests": 0, "p50_ms": 0.0,
                    "p99_ms": 0.0, "qps": 0.0, "shed": 0})
                row["shed"] = info["shed"]
                row["weight"] = info["weight"]
        return out


# ---------------------------------------------------------------------------
# Stream drivers: one submit loop (in AnnService.stream), two clocks.
# ---------------------------------------------------------------------------

class _VirtualStreamDriver:
    """Deterministic multi-server discrete-event replay (no threads):
    per-replica server-free clocks, deadline flushes fired in global
    time order, measured engine time charged onto the virtual
    timeline."""

    def __init__(self, svc: AnnService):
        self.svc = svc
        self.free = [0.0] * svc.n_replicas
        self.reqs: List[Request] = []

    def _serve(self, r: int, batch: MicroBatch) -> None:
        start = max(batch.t_flush, self.free[r])
        served = self.svc.replicas[r].runtime.serve_flushed(batch,
                                                            t_start=start)
        self.free[r] = served[0].t_done

    def _fire_deadlines(self, until: Optional[float] = None) -> None:
        reps = self.svc.live_replicas
        while True:
            pend = [(rep.runtime.batcher.next_deadline(), ri)
                    for ri, rep in enumerate(reps)]
            pend = [(d, ri) for d, ri in pend if d is not None]
            if not pend:
                return
            ddl, ri = min(pend)
            if until is not None and ddl > until:
                return
            batch = reps[ri].runtime.batcher.poll(ddl)
            if batch is None:
                return
            self._serve(ri, batch)

    def advance_to(self, t: float) -> None:
        self._fire_deadlines(until=t)

    def submit(self, query, t: float, tenant=None) -> None:
        req = self.svc._route_and_submit(
            query, t, executor=False,
            tenant=self.svc._resolve_tenant(tenant)).request
        self.reqs.append(req)
        r = req.replica
        batch = self.svc.replicas[r].runtime.batcher.poll(t)  # flush-on-full
        if batch is not None:
            self._serve(r, batch)

    def finish(self) -> List[Request]:
        for ri, rep in enumerate(self.svc.live_replicas):     # drain
            b = rep.runtime.batcher
            while b.depth:
                batch = b.poll(b.next_deadline(), drain=True)
                self._serve(ri, batch)
        return self.reqs


class _WallStreamDriver:
    """Real-time replay through the executor-backed replicas: arrival
    gaps are slept, workers overlap, futures gate completion."""

    def __init__(self, svc: AnnService):
        self.svc = svc
        svc._ensure_executors()
        self.t0 = time.monotonic()
        self.futures: List[SearchFuture] = []

    def advance_to(self, t: float) -> None:
        dt = (self.t0 + t) - time.monotonic()
        if dt > 0:
            time.sleep(dt)

    def submit(self, query, t: float, tenant=None) -> None:
        self.futures.append(self.svc.submit_async(query, tenant=tenant))

    def finish(self) -> List[Request]:
        svc = self.svc
        # WFQ holds a backlog outside the batchers: keep force-flushing so
        # completions keep pulling the queue until it runs dry
        while svc.wfq is not None and svc.wfq.pending:
            for ex in svc._executors[:svc._live]:
                ex.flush()
            time.sleep(0.002)
        for ex in svc._executors[:svc._live]:
            ex.flush()
        for fut in self.futures:
            fut.result(timeout=120.0)
        return [fut.request for fut in self.futures]
