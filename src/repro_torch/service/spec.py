"""Declarative service configuration: one validated config for the whole
DRIM-ANN serving stack.

The port of ``repro/service/spec.py``: the same fields, schema version,
validation and serialized form, so a deploy file written by either
package loads in the other.  Where the two packages differ:

  * ``IndexSpec.build(points, *, device=...)`` builds through the port's
    ``build_ivfpq`` from a ``torch.Generator`` seeded with ``seed``; the
    device is an argument of ``build``, not a spec field;
  * ``engine_overrides`` is checked against the reference's
    ``EngineConfig`` field set (``ENGINE_CONFIG_FIELDS``), which has the
    dataflow switch ``use_kernels`` that the port's ``EngineConfig``
    lacks: in the port the device picks kernel or plain version, so
    ``engine_config_kwargs`` drops such keys when it builds the engine.

A :class:`ServiceSpec` names everything `AnnService.build` needs to stand
up a service — index construction parameters (:class:`IndexSpec`), search
parameters, engine kind (local five-phase pipeline or the UPMEM-style
sharded engine), replica count and router policy, serving-runtime knobs
(batch buckets, deadline), and the cache/heat/relayout policy — replacing
the four separate config objects (``SearchParams``, ``EngineConfig``,
``ServingConfig``, cache kwargs) a caller previously had to thread by
hand.

Validation is eager and total: ``validate()`` (called by
``AnnService.build``) raises ``ValueError`` naming the offending field,
so a mis-wired spec fails at build time, not mid-stream.

Everything is plain data — no engines are constructed here — so specs
are cheap to sweep in benchmarks and trivially printable/loggable.

Specs are also the durable deploy artifact: ``to_dict``/``from_dict``
round-trip losslessly (``from_dict(to_dict(s)) == s``), and
``save``/``load`` write/read JSON or YAML files (by extension), so
``python -m repro_torch.service --spec deploy.json`` boots the fleet a
file describes.
Serialized specs carry ``version``; ``from_dict`` rejects unknown keys
and unknown versions by name, so a typo'd deploy file fails loudly at
load time instead of silently falling back to a default.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Mapping, Optional, Tuple, Union

_ENGINES = ("local", "sharded")
_ROUTERS = ("round_robin", "least_queue", "cache_aware")

#: serialization schema version; bump when fields change incompatibly
#: v1 -> v2: added `mutable` + `mutation_*` knobs (live-index mutation);
#: v2 -> v3: added `storage*` (tiered RAM/disk residency) + `coarse_*`
#: (two-level routing) knobs;
#: v3 -> v4: added the fail-operational knobs (`deadline_ms`,
#: `queue_bound`, retry/breaker policy, `shutdown_timeout_s`,
#: `checksum`);
#: v4 -> v5: added multi-tenant serving (`tenants` namespace section,
#: `filter_width` predicate-term width, `qos_wfq` + `qos_window`
#: weighted-fair-queueing knobs).  Older deploy files load unchanged
#: (the new knobs default to off / legacy behavior), but an old-stamped
#: file carrying newer keys is rejected by name.
SPEC_VERSION = 5

#: fields that did not exist in spec schema v1 (migration guard)
_V2_FIELDS = frozenset({"mutable", "mutation_size_band",
                        "mutation_maintenance_interval",
                        "mutation_compact_threshold"})

#: fields added by spec schema v3 (tiered storage + two-level routing)
_V3_FIELDS = frozenset({"storage", "storage_budget_bytes",
                        "storage_promote_margin", "storage_dir",
                        "coarse_groups", "coarse_nprobe1"})

#: fields added by spec schema v4 (fail-operational serving)
_V4_FIELDS = frozenset({"deadline_ms", "queue_bound", "max_retries",
                        "backoff_base_ms", "breaker_threshold",
                        "breaker_half_open_s", "shutdown_timeout_s",
                        "checksum"})

#: fields added by spec schema v5 (multi-tenant serving)
_V5_FIELDS = frozenset({"tenants", "filter_width", "qos_wfq",
                        "qos_window"})

#: per-tenant config keys inside the serialized ``tenants`` mapping
_TENANT_KEYS = frozenset({"id", "weight", "rate_qps", "burst"})

#: ``EngineConfig`` keys that only pick a dataflow (Pallas kernel or jnp
#: in the reference); in the port the tensors' device picks kernel or
#: plain version, so these are accepted and dropped
DATAFLOW_ONLY_FIELDS = frozenset({"use_kernels"})

#: the sharded engine's ``EngineConfig`` fields, as the reference declares
#: them (``repro/core/sharded_search.py``); ``engine_overrides`` may set
#: any of them that the spec does not itself carry
ENGINE_CONFIG_FIELDS = frozenset({
    "n_shards", "nprobe", "k", "split_max", "dup_budget_bytes",
    "tasks_per_shard", "strategy", "use_kernels", "enable_filter",
    "filter_ratio", "naive_layout", "naive_schedule", "relayout_every",
    "lut_dtype"})


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """How to build the IVF-PQ index from a points array
    (``core.ivf.build_ivfpq`` parameters)."""
    nlist: int = 64
    m: int = 16
    cb: int = 256
    kmeans_iters: int = 12
    pq_iters: int = 12
    opq: bool = False
    train_sample: Optional[int] = None
    seed: int = 0

    def validate(self) -> "IndexSpec":
        if self.nlist < 1:
            raise ValueError(f"IndexSpec.nlist must be >= 1, got {self.nlist}")
        if self.m < 1:
            raise ValueError(f"IndexSpec.m must be >= 1, got {self.m}")
        if self.cb < 2:
            raise ValueError(f"IndexSpec.cb must be >= 2, got {self.cb}")
        return self

    def build(self, points, *, device="cuda", mutable: bool = False,
              storage: str = "resident"):
        """The unified index front door: build an
        :class:`~repro_torch.core.mutable_index.Index` handle from raw
        (N, D) points on ``device`` (default the card; without CUDA that
        raises), drawing from a ``torch.Generator`` seeded with ``seed``.
        ``mutable=True`` keeps the raw points for upserts, deletes and
        generation maintenance; ``storage="tiered"`` (ROADMAP item 7) is
        not ported and raises ``NotImplementedError``."""
        import torch

        from repro_torch.core.mutable_index import Index
        self.validate()
        return Index.build(torch.Generator().manual_seed(self.seed), points,
                           nlist=self.nlist, m=self.m, cb=self.cb,
                           kmeans_iters=self.kmeans_iters,
                           pq_iters=self.pq_iters, opq=self.opq,
                           train_sample=self.train_sample, mutable=mutable,
                           storage=storage, device=device)


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """Everything AnnService needs, in one place.

    Groups (see README §service for the full knob list):
      * search:  ``nprobe``/``k``/``strategy``/``lut_dtype``
        (``SearchParams`` / ``EngineConfig`` fields; ``lut_dtype="uint8"``
        is the quantized-LUT fast path — 16 KiB -> ~4 KiB per LUT at
        M=16, CB=256);
      * engine:  ``engine`` kind plus the sharded-only knobs
        (``n_shards``, ``tasks_per_shard``, ``dup_budget_bytes``,
        ``split_max``, ``relayout_every``, ``tune_tasks_per_shard``) and
        the ``engine_overrides`` escape hatch (extra ``EngineConfig``
        fields, e.g. ``naive_layout`` for ablations);
      * replicas/routing: ``replicas`` engine+runtime copies behind a
        ``router`` policy (round_robin | least_queue | cache_aware);
      * serving: ``buckets``/``max_wait_s`` (``ServingConfig`` fields);
      * cache/heat: ``cache_capacity`` (entry bound) and/or
        ``cache_capacity_bytes`` (byte bound) enable the per-replica
        hot-cluster LUT cache; ``cache_granularity``,
        ``heat_aware_admission`` (sharded only: per-replica
        ``OnlineHeatEstimator`` + ``HeatAwareAdmission``, fed by the
        engine's CL output).
    """

    # -- index build (used when AnnService.build is given raw points) ------
    index: IndexSpec = dataclasses.field(default_factory=IndexSpec)

    # -- search parameters -------------------------------------------------
    nprobe: int = 8
    k: int = 10
    strategy: str = "gather"
    # quantized-LUT fast path: "uint8" carries LUTs as u8 + per-subspace
    # scales through kernels, cache, and engines (default f32 keeps
    # results bit-compatible with the pre-quantization stack)
    lut_dtype: str = "f32"

    # -- engine tier -------------------------------------------------------
    engine: str = "local"                  # "local" | "sharded"
    n_shards: int = 8
    tasks_per_shard: int = 1024
    dup_budget_bytes: int = 0
    split_max: Optional[int] = None
    relayout_every: int = 0                # sharded only; 0 = never
    tune_tasks_per_shard: bool = False     # sharded only
    engine_overrides: Optional[Mapping] = None   # extra EngineConfig fields

    # -- replicas + routing ------------------------------------------------
    replicas: int = 1
    router: str = "round_robin"   # "round_robin" | "least_queue" | "cache_aware"
    router_halflife_batches: float = 64.0  # cache_aware heat decay

    # -- autoscaling (executor-backed streams) -----------------------------
    # replicas_max > replicas arms the Autoscaler: the live fleet floats
    # in [replicas, replicas_max] from queue-depth / p99 signals, applied
    # between batches (results stay invariant across scale events).
    replicas_max: int = 0                  # 0 = autoscaling off
    autoscale_queue_high: float = 4.0      # mean depth/replica: grow above
    autoscale_queue_low: float = 0.5       # ... shrink below
    autoscale_p99_budget_ms: float = 0.0   # 0 = no latency signal
    autoscale_cooldown: int = 8            # eval ticks between scale events
    autoscale_interval: int = 8            # requests between evals

    # -- serving runtime ---------------------------------------------------
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    max_wait_s: float = 2e-3
    # PIM-paced serving (hardware-in-the-loop): > 0 paces every replica's
    # batches to the Eq. 15 modeled latency of a fleet of this many DPU
    # ranks (UPMEM profile), so wall-clock serving experiments measure
    # the modeled hardware's capacity instead of the dev box's cores.
    # Results are unchanged — only service timing is.  0 = off.
    pim_paced_ranks: int = 0

    # -- cache / heat ------------------------------------------------------
    cache_capacity: int = 0                # 0 = no entry bound
    cache_capacity_bytes: int = 0          # 0 = no byte bound
    # the per-replica LUT cache is enabled when either bound is set;
    # at a fixed byte budget lut_dtype="uint8" holds ~4x the entries
    cache_granularity: Optional[float] = None
    heat_aware_admission: bool = False

    # -- live mutation (spec schema v2) ------------------------------------
    # mutable=True builds the service over a mutable Index handle: the
    # raw vectors are retained and AnnService.upsert/delete/
    # run_maintenance come alive (needs the points array at build time).
    mutable: bool = False
    # cluster size band (lo, hi) for the maintenance loop: clusters past
    # hi are split (k-means k=2), clusters under lo merged away.
    # (0, 0) = auto band [mean/4, 4*mean] around the live mean size.
    mutation_size_band: Tuple[int, int] = (0, 0)
    # run a maintenance check every N mutation calls; 0 = manual only
    # (call AnnService.run_maintenance yourself)
    mutation_maintenance_interval: int = 0
    # repack padded cluster capacity once deletes have freed this
    # fraction of the live set (capacity high-water compaction — deleted
    # rows themselves are swap-compacted out immediately, tombstone-free)
    mutation_compact_threshold: float = 0.5

    # -- tiered storage + two-level routing (spec schema v3) ---------------
    # storage="tiered" serves an index bigger than RAM: PQ codes spill to
    # disk as memory-mapped files and only the hottest clusters (by the
    # online heat estimator) stay resident, within storage_budget_bytes.
    # Results match the all-resident index exactly — cold probes fetch
    # codes through the mmap tier before the scan — only latency changes.
    storage: str = "resident"              # "resident" | "tiered"
    storage_budget_bytes: int = 0          # resident bytes cap (tiered)
    # a cold cluster displaces a resident one only when its heat exceeds
    # margin * the coldest resident's heat (anti-thrash hysteresis)
    storage_promote_margin: float = 1.25
    # spill directory; None = a fresh temp dir per build
    storage_dir: Optional[str] = None
    # two-level coarse quantizer (local engine): route via coarse_groups
    # L1 centroids, score only the top coarse_nprobe1 groups' members.
    # 0 = flat CL.  coarse_nprobe1=0 means "all groups" (exact parity).
    coarse_groups: int = 0
    coarse_nprobe1: int = 0

    # -- fail-operational serving (spec schema v4) -------------------------
    # per-request deadline budget, milliseconds from arrival.  When the
    # predicted cold-fetch cost would overrun the remaining budget the
    # tiered engine sheds cold probes and serves a *degraded* result
    # (exact over what was scanned, flagged in future.timing()).  0 = no
    # deadline: every probe is always served.
    deadline_ms: float = 0.0
    # admission bound: reject submits (ServiceOverloaded) once this many
    # requests are in flight, so a burst degrades to fast rejections
    # instead of unbounded queueing.  0 = unbounded (legacy).
    queue_bound: int = 0
    # retry v2: a failed batch is retried up to max_retries times on the
    # healthiest other replica, sleeping backoff_base_ms * 2^attempt
    # (+ seeded jitter) between attempts.  backoff 0 = immediate retry.
    max_retries: int = 1
    backoff_base_ms: float = 0.0
    # circuit breaker: breaker_threshold consecutive batch failures trip
    # a replica's breaker open (no traffic); after breaker_half_open_s a
    # single probe batch is admitted — success closes the breaker,
    # failure re-opens it.  half_open 0 = open until a success (legacy).
    breaker_threshold: int = 3
    breaker_half_open_s: float = 0.0
    # executor shutdown: seconds to wait for each worker thread to drain
    # before declaring it wedged (counted in AnnService.stats()).
    shutdown_timeout_s: float = 30.0
    # tiered-storage integrity: per-cluster CRC32 checksums recorded at
    # spill time, verified on open and on every cold fetch; corrupt
    # clusters are quarantined and rebuilt from the resident copy.
    # False skips checksum compute/verify (trusted local experiments).
    checksum: bool = True

    # -- multi-tenant serving (spec schema v5) -----------------------------
    # namespaces: per-tenant index views over the shared codebooks /
    # clusters.  Each entry is (name, id, weight, rate_qps, burst),
    # sorted by id; the serialized form is a mapping
    # ``{name: {id, weight, rate_qps, burst}}``.  ``weight`` is the WFQ
    # share, ``rate_qps``/``burst`` the token-bucket quota (rate 0 = no
    # quota).  () = single-tenant legacy behavior throughout.
    tenants: Tuple[Tuple, ...] = ()
    # width W of the per-query predicate-term array (u32 terms,
    # NO_TAG-padded): jit shapes for the scoped scans are keyed on it
    filter_width: int = 4
    # per-tenant QoS on the wall-clock executor path: token-bucket
    # admission + weighted fair queueing in front of the router, so a
    # hot tenant's backlog queues in the scheduler instead of ahead of
    # quiet tenants' requests
    qos_wfq: bool = False
    # WFQ in-flight dispatch window; 0 = auto (replicas x largest bucket)
    qos_window: int = 0

    @property
    def cache_enabled(self) -> bool:
        return self.cache_capacity > 0 or self.cache_capacity_bytes > 0

    def validate(self) -> "ServiceSpec":
        self.index.validate()
        if self.engine not in _ENGINES:
            raise ValueError(f"ServiceSpec.engine must be one of {_ENGINES}, "
                             f"got {self.engine!r}")
        if self.router not in _ROUTERS:
            raise ValueError(f"ServiceSpec.router must be one of {_ROUTERS}, "
                             f"got {self.router!r}")
        if self.replicas < 1:
            raise ValueError(f"ServiceSpec.replicas must be >= 1, "
                             f"got {self.replicas}")
        if self.nprobe < 1 or self.k < 1:
            raise ValueError("ServiceSpec.nprobe and .k must be >= 1, got "
                             f"nprobe={self.nprobe} k={self.k}")
        if self.strategy not in ("gather", "onehot"):
            raise ValueError(f"ServiceSpec.strategy must be 'gather' or "
                             f"'onehot', got {self.strategy!r}")
        if self.lut_dtype not in ("f32", "uint8"):
            raise ValueError(f"ServiceSpec.lut_dtype must be 'f32' or "
                             f"'uint8', got {self.lut_dtype!r}")
        if not self.buckets or any(int(b) < 1 for b in self.buckets):
            raise ValueError(f"ServiceSpec.buckets must be non-empty "
                             f"positive ints, got {self.buckets}")
        if self.max_wait_s <= 0:
            raise ValueError(f"ServiceSpec.max_wait_s must be positive, "
                             f"got {self.max_wait_s}")
        if self.cache_capacity < 0:
            raise ValueError(f"ServiceSpec.cache_capacity must be >= 0, "
                             f"got {self.cache_capacity}")
        if self.cache_capacity_bytes < 0:
            raise ValueError(f"ServiceSpec.cache_capacity_bytes must be "
                             f">= 0, got {self.cache_capacity_bytes}")
        if (self.cache_granularity is not None
                and self.cache_granularity <= 0):
            raise ValueError(f"ServiceSpec.cache_granularity must be None "
                             f"or positive, got {self.cache_granularity}")
        if self.heat_aware_admission and not self.cache_enabled:
            raise ValueError("ServiceSpec.heat_aware_admission needs "
                             "cache_capacity or cache_capacity_bytes > 0")
        if self.router_halflife_batches <= 0:
            raise ValueError("ServiceSpec.router_halflife_batches must be "
                             f"positive, got {self.router_halflife_batches}")
        if self.replicas_max < 0:
            raise ValueError(f"ServiceSpec.replicas_max must be >= 0, "
                             f"got {self.replicas_max}")
        if self.replicas_max and self.replicas_max < self.replicas:
            raise ValueError(f"ServiceSpec.replicas_max "
                             f"({self.replicas_max}) must be >= replicas "
                             f"({self.replicas}) (or 0 to disable "
                             f"autoscaling)")
        if self.autoscale_queue_low >= self.autoscale_queue_high:
            raise ValueError(f"ServiceSpec.autoscale_queue_low "
                             f"({self.autoscale_queue_low}) must be < "
                             f"autoscale_queue_high "
                             f"({self.autoscale_queue_high})")
        if self.autoscale_p99_budget_ms < 0:
            raise ValueError("ServiceSpec.autoscale_p99_budget_ms must be "
                             f">= 0, got {self.autoscale_p99_budget_ms}")
        if self.autoscale_cooldown < 1 or self.autoscale_interval < 1:
            raise ValueError("ServiceSpec.autoscale_cooldown and "
                             ".autoscale_interval must be >= 1, got "
                             f"cooldown={self.autoscale_cooldown} "
                             f"interval={self.autoscale_interval}")
        if self.pim_paced_ranks < 0:
            raise ValueError(f"ServiceSpec.pim_paced_ranks must be >= 0, "
                             f"got {self.pim_paced_ranks}")
        band = tuple(self.mutation_size_band)
        if len(band) != 2:
            raise ValueError(f"ServiceSpec.mutation_size_band must be "
                             f"(lo, hi), got {self.mutation_size_band!r}")
        if band != (0, 0) and (band[0] < 1 or band[1] <= band[0]):
            raise ValueError(f"ServiceSpec.mutation_size_band needs "
                             f"1 <= lo < hi (or (0, 0) for the auto "
                             f"band), got {band}")
        if self.mutation_maintenance_interval < 0:
            raise ValueError(f"ServiceSpec.mutation_maintenance_interval "
                             f"must be >= 0, got "
                             f"{self.mutation_maintenance_interval}")
        if self.mutation_compact_threshold <= 0:
            raise ValueError(f"ServiceSpec.mutation_compact_threshold "
                             f"must be positive, got "
                             f"{self.mutation_compact_threshold}")
        if not self.mutable:
            # the mutation knobs all hang off the mutable handle
            if band != (0, 0) or self.mutation_maintenance_interval:
                raise ValueError("ServiceSpec.mutation_size_band / "
                                 ".mutation_maintenance_interval require "
                                 "mutable=True")
        if self.storage not in ("resident", "tiered"):
            raise ValueError(f"ServiceSpec.storage must be 'resident' or "
                             f"'tiered', got {self.storage!r}")
        if self.storage == "tiered":
            if self.storage_budget_bytes < 1:
                raise ValueError(f"ServiceSpec.storage_budget_bytes must be "
                                 f">= 1 with storage='tiered', got "
                                 f"{self.storage_budget_bytes}")
            if self.mutable:
                raise ValueError("ServiceSpec: storage='tiered' requires "
                                 "mutable=False (the tier spills a static "
                                 "snapshot)")
        elif self.storage_budget_bytes:
            raise ValueError("ServiceSpec.storage_budget_bytes requires "
                             "storage='tiered'")
        if self.storage_promote_margin < 1.0:
            raise ValueError(f"ServiceSpec.storage_promote_margin must be "
                             f">= 1, got {self.storage_promote_margin}")
        if self.coarse_groups < 0 or self.coarse_nprobe1 < 0:
            raise ValueError(f"ServiceSpec.coarse_groups/.coarse_nprobe1 "
                             f"must be >= 0, got {self.coarse_groups}/"
                             f"{self.coarse_nprobe1}")
        if self.coarse_nprobe1 and not self.coarse_groups:
            raise ValueError("ServiceSpec.coarse_nprobe1 requires "
                             "coarse_groups > 0")
        if self.coarse_groups and self.engine != "local":
            raise ValueError("ServiceSpec.coarse_groups requires "
                             "engine='local' (the sharded engine routes "
                             "flat)")
        if self.engine != "sharded":
            # these all hang off the sharded engine's online heat loop
            for knob in ("relayout_every", "tune_tasks_per_shard",
                         "heat_aware_admission"):
                if getattr(self, knob):
                    raise ValueError(f"ServiceSpec.{knob} requires "
                                     f"engine='sharded'")
            if self.engine_overrides:
                raise ValueError("ServiceSpec.engine_overrides requires "
                                 "engine='sharded'")
        else:
            if self.n_shards < 1:
                raise ValueError(f"ServiceSpec.n_shards must be >= 1, "
                                 f"got {self.n_shards}")
            if self.tasks_per_shard < 1:
                raise ValueError(f"ServiceSpec.tasks_per_shard must be >= 1,"
                                 f" got {self.tasks_per_shard}")
            if self.engine_overrides:
                known = set(ENGINE_CONFIG_FIELDS)
                bad = set(self.engine_overrides) - known
                if bad:
                    raise ValueError(f"ServiceSpec.engine_overrides has "
                                     f"unknown EngineConfig fields: "
                                     f"{sorted(bad)}")
                # fields that exist on both ServiceSpec and EngineConfig
                # must be set on the spec: an override would bypass the
                # build-time wiring keyed on the spec value (e.g.
                # relayout_every gates the heat estimator)
                shadowed = (set(self.engine_overrides) & known
                            & set(self.__dataclass_fields__))
                if shadowed:
                    raise ValueError(f"ServiceSpec.engine_overrides may "
                                     f"not shadow spec fields "
                                     f"{sorted(shadowed)}; set them on "
                                     f"the ServiceSpec directly")
        if self.relayout_every < 0:
            raise ValueError(f"ServiceSpec.relayout_every must be >= 0, "
                             f"got {self.relayout_every}")
        if self.deadline_ms < 0:
            raise ValueError(f"ServiceSpec.deadline_ms must be >= 0, "
                             f"got {self.deadline_ms}")
        if self.queue_bound < 0:
            raise ValueError(f"ServiceSpec.queue_bound must be >= 0, "
                             f"got {self.queue_bound}")
        if self.max_retries < 0:
            raise ValueError(f"ServiceSpec.max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_base_ms < 0:
            raise ValueError(f"ServiceSpec.backoff_base_ms must be >= 0, "
                             f"got {self.backoff_base_ms}")
        if self.breaker_threshold < 1:
            raise ValueError(f"ServiceSpec.breaker_threshold must be >= 1, "
                             f"got {self.breaker_threshold}")
        if self.breaker_half_open_s < 0:
            raise ValueError(f"ServiceSpec.breaker_half_open_s must be "
                             f">= 0, got {self.breaker_half_open_s}")
        if self.shutdown_timeout_s <= 0:
            raise ValueError(f"ServiceSpec.shutdown_timeout_s must be "
                             f"positive, got {self.shutdown_timeout_s}")
        if self.filter_width < 1:
            raise ValueError(f"ServiceSpec.filter_width must be >= 1, "
                             f"got {self.filter_width}")
        names, ids = set(), set()
        for entry in self.tenants:
            entry = tuple(entry)
            if len(entry) != 5:
                raise ValueError(f"ServiceSpec.tenants entries must be "
                                 f"(name, id, weight, rate_qps, burst), "
                                 f"got {entry!r}")
            name, tid, weight, rate_qps, burst = entry
            if not isinstance(name, str) or not name:
                raise ValueError(f"ServiceSpec.tenants: tenant name must "
                                 f"be a non-empty string, got {name!r}")
            if name in names:
                raise ValueError(f"ServiceSpec.tenants: duplicate tenant "
                                 f"name {name!r}")
            if int(tid) < 0 or int(tid) in ids:
                raise ValueError(f"ServiceSpec.tenants[{name!r}]: id must "
                                 f"be a unique non-negative int, got {tid}")
            if float(weight) <= 0:
                raise ValueError(f"ServiceSpec.tenants[{name!r}]: weight "
                                 f"must be positive, got {weight}")
            if float(rate_qps) < 0:
                raise ValueError(f"ServiceSpec.tenants[{name!r}]: rate_qps "
                                 f"must be >= 0, got {rate_qps}")
            if int(burst) < 1:
                raise ValueError(f"ServiceSpec.tenants[{name!r}]: burst "
                                 f"must be >= 1, got {burst}")
            names.add(name)
            ids.add(int(tid))
        if self.tenants and self.coarse_groups:
            raise ValueError("ServiceSpec.tenants is incompatible with "
                             "coarse_groups > 0 (tenant-masked CL needs "
                             "the flat coarse quantizer)")
        if self.qos_wfq and not self.tenants:
            raise ValueError("ServiceSpec.qos_wfq requires a non-empty "
                             "tenants section")
        if self.qos_window < 0:
            raise ValueError(f"ServiceSpec.qos_window must be >= 0, "
                             f"got {self.qos_window}")
        if self.qos_window and not self.qos_wfq:
            raise ValueError("ServiceSpec.qos_window requires qos_wfq=True")
        return self

    # -- serialization: the durable deploy artifact ------------------------
    def to_dict(self) -> dict:
        """Plain-data form (JSON/YAML-ready), stamped with the schema
        version.  Inverse of :meth:`from_dict`."""
        out = dataclasses.asdict(self)
        out["buckets"] = list(self.buckets)
        out["mutation_size_band"] = list(self.mutation_size_band)
        if self.engine_overrides is not None:
            out["engine_overrides"] = dict(self.engine_overrides)
        out["tenants"] = {
            str(name): {"id": int(tid), "weight": float(weight),
                        "rate_qps": float(rate_qps), "burst": int(burst)}
            for name, tid, weight, rate_qps, burst in self.tenants}
        out["version"] = SPEC_VERSION
        return out

    @classmethod
    def from_dict(cls, data: Mapping) -> "ServiceSpec":
        """Rebuild (and validate) a spec from :meth:`to_dict` output.

        Unknown keys and unknown schema versions are rejected by name —
        a deploy file written against a different field set must fail at
        load, not boot a silently different fleet."""
        data = dict(data)
        version = data.pop("version", SPEC_VERSION)
        if version in (1, 2, 3, 4):
            # migration: every newer-schema field defaults to "off", so a
            # clean old file loads as-is; an old-stamped file that
            # nonetheless carries newer keys is lying about its version
            newer = {1: _V2_FIELDS | _V3_FIELDS | _V4_FIELDS | _V5_FIELDS,
                     2: _V3_FIELDS | _V4_FIELDS | _V5_FIELDS,
                     3: _V4_FIELDS | _V5_FIELDS,
                     4: _V5_FIELDS}[version]
            leaked = sorted(set(data) & newer)
            if leaked:
                raise ValueError(f"ServiceSpec version {version} file "
                                 f"carries newer-schema keys {leaked}; "
                                 f"restamp it version: {SPEC_VERSION}")
        elif version != SPEC_VERSION:
            raise ValueError(f"ServiceSpec version {version!r} is not "
                             f"supported (this build reads version "
                             f"{SPEC_VERSION})")
        index = data.pop("index", None)
        known = set(cls.__dataclass_fields__) - {"index"}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(f"ServiceSpec.from_dict: unknown keys "
                             f"{unknown} (known: {sorted(known)})")
        if index is not None:
            if not isinstance(index, Mapping):
                raise ValueError(f"ServiceSpec.from_dict: 'index' must be "
                                 f"a mapping, got {type(index).__name__}")
            iknown = set(IndexSpec.__dataclass_fields__)
            iunknown = sorted(set(index) - iknown)
            if iunknown:
                raise ValueError(f"ServiceSpec.from_dict: unknown "
                                 f"IndexSpec keys {iunknown}")
            data["index"] = IndexSpec(**index)
        if "buckets" in data:
            data["buckets"] = tuple(int(b) for b in data["buckets"])
        if "mutation_size_band" in data:
            data["mutation_size_band"] = tuple(
                int(b) for b in data["mutation_size_band"])
        if "tenants" in data:
            tenants = data["tenants"]
            entries = []
            if isinstance(tenants, Mapping):
                for name, cfg in tenants.items():
                    if not isinstance(cfg, Mapping):
                        raise ValueError(
                            f"ServiceSpec.from_dict: tenants[{name!r}] "
                            f"must be a mapping, got "
                            f"{type(cfg).__name__}")
                    bad = sorted(set(cfg) - _TENANT_KEYS)
                    if bad:
                        raise ValueError(
                            f"ServiceSpec.from_dict: tenants[{name!r}] "
                            f"has unknown keys {bad} (known: "
                            f"{sorted(_TENANT_KEYS)})")
                    if "id" not in cfg:
                        raise ValueError(
                            f"ServiceSpec.from_dict: tenants[{name!r}] "
                            f"needs an 'id'")
                    entries.append((str(name), int(cfg["id"]),
                                    float(cfg.get("weight", 1.0)),
                                    float(cfg.get("rate_qps", 0.0)),
                                    int(cfg.get("burst", 1))))
            else:   # direct tuple/list-of-entries form
                entries = [tuple(e) for e in tenants]
            data["tenants"] = tuple(sorted(entries, key=lambda e: e[1]))
        return cls(**data).validate()

    def engine_config_kwargs(self) -> dict:
        """Keyword arguments of the port's ``EngineConfig`` for this
        (sharded) spec: the spec's own engine fields, then the overrides,
        less the dataflow-only keys the port does not have."""
        kw = dict(n_shards=self.n_shards, nprobe=self.nprobe, k=self.k,
                  split_max=self.split_max,
                  dup_budget_bytes=self.dup_budget_bytes,
                  tasks_per_shard=self.tasks_per_shard,
                  strategy=self.strategy, lut_dtype=self.lut_dtype,
                  relayout_every=self.relayout_every)
        kw.update({key: val for key, val in
                   dict(self.engine_overrides or {}).items()
                   if key not in DATAFLOW_ONLY_FIELDS})
        return kw

    def save(self, path: Union[str, pathlib.Path]) -> pathlib.Path:
        """Write the spec as a deploy file; format follows the extension
        (``.json``, or ``.yaml``/``.yml`` when PyYAML is available)."""
        path = pathlib.Path(path)
        data = self.to_dict()
        if path.suffix in (".yaml", ".yml"):
            yaml = _require_yaml(path)
            path.write_text(yaml.safe_dump(data, sort_keys=True))
        elif path.suffix == ".json":
            path.write_text(json.dumps(data, indent=1, sort_keys=True)
                            + "\n")
        else:
            raise ValueError(f"ServiceSpec.save: unsupported extension "
                             f"{path.suffix!r} (use .json, .yaml, .yml)")
        return path

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "ServiceSpec":
        """Read a deploy file written by :meth:`save` (or by hand)."""
        path = pathlib.Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            yaml = _require_yaml(path)
            data = yaml.safe_load(text)
        elif path.suffix == ".json":
            data = json.loads(text)
        else:
            raise ValueError(f"ServiceSpec.load: unsupported extension "
                             f"{path.suffix!r} (use .json, .yaml, .yml)")
        if not isinstance(data, Mapping):
            raise ValueError(f"ServiceSpec.load: {path} does not contain "
                             f"a mapping")
        return cls.from_dict(data)


def _require_yaml(path: pathlib.Path):
    try:
        import yaml
    except ImportError as e:              # pragma: no cover - env-dependent
        raise ValueError(f"{path}: YAML specs need PyYAML, which is not "
                         f"installed — use a .json spec instead") from e
    return yaml
