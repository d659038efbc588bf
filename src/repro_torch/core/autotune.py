"""SLO-driven auto-tuner: perf-model DSE -> measured calibration -> spec.

DRIM-ANN's method is systematic tuning of ANNS approximation
configurations against a fine-grained performance model of the PIM
substrate (paper §III-B/C).  This module closes that loop at the
*service* tier: instead of hand-picking ``(m, nprobe, lut_dtype,
buckets, tasks_per_shard, cache_capacity_bytes)`` for every deploy, the
tuner

  1. **models** — enumerates a :class:`TuneSpace` grid and prices every
     candidate with the Eq. 15 serving-batch latency
     (:func:`~repro_torch.core.perf_model.serving_batch_latency` on the UPMEM
     profile — the same cost basis that paces wall-clock serving
     benchmarks), with a cache-hit prior discounting the per-task LUT
     build for byte-budgeted cache candidates;
  2. **prunes** — drops every perf-model-dominated candidate
     (:func:`~repro_torch.core.dse.prune_dominated`): another candidate is
     modeled no slower AND is no worse on the monotone recall surrogate
     ``(m, nprobe, dtype_rank)``.  Recall is monotone non-decreasing in
     ``m`` and ``nprobe`` and f32 >= uint8 LUTs, so pruning is sound
     without measuring a thing — incomparable candidates all survive;
  3. **validates** — walks the survivors cheapest-modeled-first through
     a *real* :class:`~repro_torch.service.AnnService`: measured recall@k
     against a brute-force oracle plus paced p50/p99/QPS on a short
     Zipf calibration stream (``pim_paced_ranks`` makes the latency
     rows modeled-hardware-stable, so the SLO check is reproducible on
     any host);
  4. **emits** — the first candidate meeting the declared :class:`SLO`
     as a fully validated :class:`~repro_torch.service.ServiceSpec` (the
     durable deploy artifact), or raises :class:`SLOInfeasible` with
     the measured frontier attached when nothing in the space meets it.

The whole pipeline is deterministic given ``seed`` (pinned in
tests/test_autotune.py and tests/test_torch_autotune.py).  Entry points::

    from repro_torch.core.autotune import SLO, autotune, autotune_service
    res = autotune(points, SLO(recall_at_k=0.8, p99_ms=50.0))
    res.spec.save("deploy.json")
    svc, res = autotune_service(points, slo=SLO(recall_at_k=0.8))

CLI: ``python -m repro_torch.service --autotune`` runs the same
pipeline end to end.

The port of ``repro/core/autotune.py``.  Stages 1-2 (pricing and
pruning) are pure Python and numpy over the port's copy of the
performance model, unchanged; stages 3-4 measure on the port's
``AnnService`` on ``device`` (default the card), recall through the
port's ``exact_search`` / ``recall_at_k`` on the index's device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dse import prune_dominated
from repro_torch.core.perf_model import (IndexParams, UPMEM_PROFILE,
                                         lut_width_bytes,
                                         serving_batch_latency)

_DTYPE_RANK = {"uint8": 0, "f32": 1}     # recall surrogate: f32 >= uint8


@dataclasses.dataclass(frozen=True)
class SLO:
    """The declared service-level objective the emitted spec must meet,
    measured on the calibration stream: ``recall@k >= recall_at_k`` and
    (when finite) ``paced p99 <= p99_ms``."""
    recall_at_k: float = 0.8
    p99_ms: float = math.inf
    k: int = 10

    def validate(self) -> "SLO":
        if not 0.0 < self.recall_at_k <= 1.0:
            raise ValueError(f"SLO.recall_at_k must be in (0, 1], "
                             f"got {self.recall_at_k}")
        if not self.p99_ms > 0:
            raise ValueError(f"SLO.p99_ms must be positive, "
                             f"got {self.p99_ms}")
        if self.k < 1:
            raise ValueError(f"SLO.k must be >= 1, got {self.k}")
        return self

    def met_by(self, recall: float, p99_ms: float) -> bool:
        return (recall >= self.recall_at_k
                and (not math.isfinite(self.p99_ms)
                     or p99_ms <= self.p99_ms))

    def __str__(self) -> str:
        p99 = (f"p99 <= {self.p99_ms:g}ms" if math.isfinite(self.p99_ms)
               else "p99 unbounded")
        return f"recall@{self.k} >= {self.recall_at_k:g}, {p99}"


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the tuning space — exactly the knobs the ROADMAP
    says are hand-picked today."""
    m: int
    nprobe: int
    lut_dtype: str
    buckets: Tuple[int, ...]
    tasks_per_shard: int
    cache_capacity_bytes: int

    def quality_key(self) -> Tuple[int, int, int]:
        """Monotone recall surrogate, compared componentwise: recall
        never decreases with m or nprobe, and f32 LUTs are never worse
        than uint8.  Serving-only knobs (buckets/tasks/cache) don't
        move recall and stay out of the key."""
        return (self.m, self.nprobe, _DTYPE_RANK[self.lut_dtype])

    def label(self) -> str:
        cache = (f"{self.cache_capacity_bytes >> 10}KiB"
                 if self.cache_capacity_bytes else "off")
        return (f"m={self.m} nprobe={self.nprobe} lut={self.lut_dtype} "
                f"buckets={self.buckets} tasks={self.tasks_per_shard} "
                f"cache={cache}")


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """Candidate values per knob; the grid is their product."""
    m: Sequence[int] = (8, 16, 32)
    nprobe: Sequence[int] = (2, 4, 8, 16, 32)
    lut_dtype: Sequence[str] = ("uint8", "f32")
    buckets: Sequence[Tuple[int, ...]] = ((1, 2, 4, 8),
                                          (1, 2, 4, 8, 16, 32))
    tasks_per_shard: Sequence[int] = (1024,)
    cache_capacity_bytes: Sequence[int] = (0, 1 << 20)

    def validate(self) -> "TuneSpace":
        for name in ("m", "nprobe", "lut_dtype", "buckets",
                     "tasks_per_shard", "cache_capacity_bytes"):
            if not tuple(getattr(self, name)):
                raise ValueError(f"TuneSpace.{name} must be non-empty")
        bad = sorted(set(self.lut_dtype) - set(_DTYPE_RANK))
        if bad:
            raise ValueError(f"TuneSpace.lut_dtype has unknown dtypes "
                             f"{bad} (known: {sorted(_DTYPE_RANK)})")
        return self

    def grid(self):
        for m, p, dt, bk, tps, cb in itertools.product(
                self.m, self.nprobe, self.lut_dtype, self.buckets,
                self.tasks_per_shard, self.cache_capacity_bytes):
            yield Candidate(m, p, dt, tuple(bk), tps, cb)

    def size(self) -> int:
        return (len(self.m) * len(self.nprobe) * len(self.lut_dtype)
                * len(self.buckets) * len(self.tasks_per_shard)
                * len(self.cache_capacity_bytes))


class SLOInfeasible(RuntimeError):
    """No candidate in the space met the SLO on the calibration stream.
    ``frontier`` carries every validated candidate's measured
    (recall, p50/p99, qps) so the caller can see how close the space
    got — and which constraint to relax.  ``modeled``, ``pruned`` and
    ``survivors`` (cheapest-modeled-first) are the shortlist's, as on
    :class:`AutotuneResult`; ``build_s`` and ``indexes`` hold each index
    build's seconds and the index itself, by ``m``."""

    def __init__(self, msg: str, slo: SLO, frontier: List[Dict], *,
                 modeled: int = 0, pruned: int = 0,
                 survivors: Sequence[Candidate] = (),
                 build_s: Optional[Dict[int, float]] = None,
                 indexes: Optional[Dict[int, object]] = None):
        super().__init__(msg)
        self.slo = slo
        self.frontier = frontier
        self.modeled = modeled
        self.pruned = pruned
        self.survivors = list(survivors)
        self.build_s = dict(build_s or {})
        self.indexes = dict(indexes or {})


@dataclasses.dataclass
class AutotuneResult:
    spec: "object"              # the validated ServiceSpec (deploy-ready)
    slo: SLO
    measured: Dict              # winner's {recall, p50_ms, p99_ms, qps}
    frontier: List[Dict]        # every validated candidate, in val order
    modeled: int                # candidates priced by the perf model
    pruned: int                 # dropped as perf-model-dominated
    validated: int              # candidates measured on the real service
    seed: int
    index: Optional[object] = dataclasses.field(default=None, repr=False)
    build_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    # the shortlist, cheapest-modeled-first, and every index built, by m
    survivors: List[Candidate] = dataclasses.field(default_factory=list)
    indexes: Dict[int, object] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    def report(self) -> str:
        lines = [
            f"autotune: modeled {self.modeled} candidates -> "
            f"{self.modeled - self.pruned} survivors "
            f"({self.pruned} perf-model-dominated), "
            f"validated {self.validated} on the calibration stream",
            f"slo: {self.slo}",
            f"winner: m={self.spec.index.m} nprobe={self.spec.nprobe} "
            f"lut={self.spec.lut_dtype} buckets={self.spec.buckets} "
            f"cache_bytes={self.spec.cache_capacity_bytes}",
            f"measured: recall@{self.slo.k}={self.measured['recall']:.3f} "
            f"p50={self.measured['p50_ms']:.2f}ms "
            f"p99={self.measured['p99_ms']:.2f}ms "
            f"qps={self.measured['qps']:.0f}",
        ]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Stage 1+2: perf-model pricing and dominance pruning.
# ---------------------------------------------------------------------------

def _model_hit_rate(cand: Candidate, nlist: int) -> float:
    """Ranking prior for the hot-cluster LUT cache: the fraction of
    per-task LUT builds the cache is expected to absorb.  Scales with
    how many (m * cb * width)-byte entries fit relative to the cluster
    count, capped at 0.5 (LUTs are per-(query, cluster); only repeated
    hot queries hit, so full coverage never means hit rate 1.0).  This
    only *ranks* candidates — validation measures the real hit rate."""
    if cand.cache_capacity_bytes <= 0:
        return 0.0
    entry = cand.m * 256 * lut_width_bytes(cand.lut_dtype)
    entries = cand.cache_capacity_bytes // entry
    if entries < 1:
        return 0.0
    return 0.5 * min(1.0, entries / float(nlist))


def predicted_latency_ms(cand: Candidate, *, n_total: int, nlist: int,
                         d: int, k: int, ranks: int, qps: float,
                         max_wait_s: float, cb: int = 256,
                         cold_fraction: float = 0.0,
                         disk=None) -> float:
    """Modeled serving-batch latency (ms) for one candidate: Eq. 15 on
    the UPMEM profile at the expected batch occupancy (offered load x
    batching window, clipped to the candidate's largest bucket), LUT
    bytes priced per ``lut_dtype``, cache candidates discounted by the
    hit prior.  Used only to *order* candidates and prune dominated
    ones — the SLO itself is checked against measured latency.

    ``cold_fraction``/``disk`` price a tiered deploy's disk tier (see
    :func:`~repro_torch.core.perf_model.cold_probe_seconds`): pass the
    expected RAM-miss share (e.g. ``1 - budget/total``) so the
    shortlist ranks candidates under tiering, not just all-resident."""
    occupancy = int(min(max(cand.buckets),
                        max(1, round(qps * max_wait_s))))
    ix = IndexParams(n_total=n_total, nlist=nlist, q=1, d=d, k=k,
                     p=cand.nprobe, m=cand.m, cb=cb,
                     b_lut=lut_width_bytes(cand.lut_dtype))
    if cold_fraction > 0.0 and disk is None:
        from repro_torch.core.perf_model import NVME_PROFILE
        disk = NVME_PROFILE
    t = serving_batch_latency(ix, UPMEM_PROFILE, ranks=ranks,
                              batch=occupancy,
                              lut_hit_rate=_model_hit_rate(cand, nlist),
                              cold_fraction=cold_fraction, disk=disk)
    return t * 1e3


def _shortlist(space: TuneSpace, time_fn: Callable[[Candidate], float]
               ) -> Tuple[List[Candidate], int, List[float]]:
    """Grid -> (survivors sorted cheapest-modeled-first, n_pruned,
    survivor predicted ms).  Sorting is stable (grid order breaks
    float ties), so the shortlist is deterministic."""
    cands = list(space.validate().grid())
    survivors, pruned = prune_dominated(
        cands, time_fn=time_fn, quality_fn=Candidate.quality_key)
    survivors = sorted(survivors, key=time_fn)
    return survivors, len(pruned), [time_fn(c) for c in survivors]


# ---------------------------------------------------------------------------
# Stage 3: measured validation on a real AnnService.
# ---------------------------------------------------------------------------

def candidate_spec(cand: Candidate, *, nlist: int, cb: int = 256,
                   kmeans_iters: int = 8, pq_iters: int = 8,
                   engine: str = "local", n_shards: int = 8,
                   replicas: int = 1, router: str = "round_robin",
                   ranks: int = 4, max_wait_s: float = 2e-3,
                   k: int = 10, seed: int = 0):
    """The spec a candidate deploys as — every spec the tuner emits goes
    through this one constructor, so full ``ServiceSpec.validate()``
    coverage of its output is a finite property (tests sweep the grid).
    ``pim_paced_ranks`` stays in the emitted artifact: the SLO was
    validated in modeled-hardware time, and the deploy file records
    exactly the configuration that met it."""
    from repro_torch.service.spec import IndexSpec, ServiceSpec
    return ServiceSpec(
        index=IndexSpec(nlist=nlist, m=cand.m, cb=cb,
                        kmeans_iters=kmeans_iters, pq_iters=pq_iters,
                        seed=seed),
        engine=engine, n_shards=n_shards,
        tasks_per_shard=cand.tasks_per_shard,
        replicas=replicas, router=router,
        nprobe=cand.nprobe, k=k, lut_dtype=cand.lut_dtype,
        buckets=tuple(cand.buckets), max_wait_s=max_wait_s,
        cache_capacity_bytes=cand.cache_capacity_bytes,
        pim_paced_ranks=ranks).validate()


def measure_spec(spec, index, queries: np.ndarray,
                 groundtruth: np.ndarray, *, k: int,
                 n_requests: int, qps: float, skew: float,
                 seed: int, sample_queries=None) -> Dict:
    """Measured truth for one spec over a prebuilt index: recall@k of a
    direct batched search against the oracle ids, then paced
    p50/p99/QPS of a Zipf calibration stream replayed on the virtual
    clock (arrival gaps are simulated, but each batch is charged its
    real — PIM-paced — service time, so the numbers are modeled-
    hardware-stable and the run sleeps no arrival gaps).  Recall is
    taken on the index's device."""
    from repro_torch.core.search import recall_at_k
    from repro_torch.data import make_query_stream
    from repro_torch.service.service import AnnService

    svc = AnnService.build(spec, index=index,
                           sample_queries=sample_queries)
    try:
        svc.warmup()
        _, ids = svc.search(queries)
        dev = svc.index.device
        recall = float(recall_at_k(
            torch.from_numpy(np.asarray(ids)).to(dev),
            torch.from_numpy(np.asarray(groundtruth)[:, :k]).to(dev)))
        stream = make_query_stream(queries, n_requests, qps, seed=seed,
                                   skew=skew)
        svc.stream(stream, clock="virtual")
        agg = svc.stats()["aggregate"]
        return {"recall": recall, "p50_ms": float(agg["p50_ms"]),
                "p99_ms": float(agg["p99_ms"]), "qps": float(agg["qps"])}
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# The tuner.
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def autotune(points, slo: SLO = SLO(), *, queries=None, groundtruth=None,
             space: TuneSpace = TuneSpace(), engine: str = "local",
             nlist: Optional[int] = None, cb: int = 256,
             kmeans_iters: int = 8, pq_iters: int = 8,
             n_shards: int = 8, replicas: int = 1,
             router: str = "round_robin", ranks: int = 4,
             calibration_requests: int = 64,
             calibration_qps: float = 4000.0,
             calibration_skew: float = 1.2, max_wait_s: float = 2e-3,
             validate_budget: int = 8, seed: int = 0,
             device="cuda") -> AutotuneResult:
    """Search ``space`` for the cheapest configuration meeting ``slo``.

    ``queries``/``groundtruth`` form the calibration set; omitted, a
    seeded sample of the corpus self-queries against a brute-force
    oracle.  At most ``validate_budget`` survivors are measured,
    cheapest-modeled-first, stopping at the first SLO pass (so the
    winner is the model's cheapest *validated* feasible point).  Raises
    :class:`SLOInfeasible` — frontier attached — when the budget is
    exhausted without a pass.  Deterministic given ``seed``.

    ``points`` is a host array or a tensor; the indexes are built, and
    the brute-force oracle runs, on ``device`` (default the card)."""
    from repro_torch.core.search import exact_search
    from repro_torch.service.spec import IndexSpec
    from repro_torch.util import resolve_device

    slo.validate()
    if validate_budget < 1:
        raise ValueError(f"validate_budget must be >= 1, "
                         f"got {validate_budget}")
    dev = resolve_device(device)
    if not isinstance(points, torch.Tensor):
        points = np.asarray(points)
    n, d = points.shape
    if nlist is None:
        nlist = max(8, min(128, n // 250))
    rng = np.random.default_rng(seed)
    if queries is None:
        qidx = rng.choice(n, size=min(64, max(8, n // 32)), replace=False)
        queries = points[qidx]
    queries = _host(queries).astype(np.float32)
    if groundtruth is None:
        pts = torch.as_tensor(points).to(dev)
        _, groundtruth = exact_search(pts, torch.from_numpy(queries).to(dev),
                                      k=slo.k)
    groundtruth = _host(groundtruth)
    if groundtruth.shape[1] < slo.k:
        raise ValueError(f"groundtruth has {groundtruth.shape[1]} "
                         f"neighbors/query but the SLO checks "
                         f"recall@{slo.k}")

    def time_fn(cand: Candidate) -> float:
        return predicted_latency_ms(
            cand, n_total=n, nlist=nlist, d=d, k=slo.k, ranks=ranks,
            qps=calibration_qps, max_wait_s=max_wait_s, cb=cb)

    survivors, n_pruned, _ = _shortlist(space, time_fn)
    modeled = space.size()

    index_cache: Dict[int, object] = {}
    build_s: Dict[int, float] = {}

    def index_for(m: int):
        if m not in index_cache:
            t0 = time.perf_counter()
            index_cache[m] = IndexSpec(
                nlist=nlist, m=m, cb=cb, kmeans_iters=kmeans_iters,
                pq_iters=pq_iters, seed=seed).build(points, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            build_s[m] = time.perf_counter() - t0
        return index_cache[m]

    frontier: List[Dict] = []
    for cand in survivors[:validate_budget]:
        spec = candidate_spec(
            cand, nlist=nlist, cb=cb, kmeans_iters=kmeans_iters,
            pq_iters=pq_iters, engine=engine, n_shards=n_shards,
            replicas=replicas, router=router, ranks=ranks,
            max_wait_s=max_wait_s, k=slo.k, seed=seed)
        measured = measure_spec(
            spec, index_for(cand.m), queries, groundtruth, k=slo.k,
            n_requests=calibration_requests, qps=calibration_qps,
            skew=calibration_skew, seed=seed + 1,
            sample_queries=queries if engine == "sharded" else None)
        entry = dict(dataclasses.asdict(cand),
                     predicted_ms=time_fn(cand), **measured,
                     meets_slo=slo.met_by(measured["recall"],
                                          measured["p99_ms"]))
        frontier.append(entry)
        if entry["meets_slo"]:
            return AutotuneResult(
                spec=spec, slo=slo, measured=measured, frontier=frontier,
                modeled=modeled, pruned=n_pruned,
                validated=len(frontier), seed=seed,
                index=index_cache[cand.m], build_s=build_s,
                survivors=survivors, indexes=index_cache)

    best = (max(frontier, key=lambda e: (e["recall"], -e["p99_ms"]))
            if frontier else None)
    detail = ""
    if best is not None:
        label = (f"m={best['m']} nprobe={best['nprobe']} "
                 f"lut={best['lut_dtype']}")
        detail = (f"; closest: recall@{slo.k}={best['recall']:.3f} "
                  f"p99={best['p99_ms']:.2f}ms ({label})")
    raise SLOInfeasible(
        f"no candidate met the SLO ({slo}) after validating "
        f"{len(frontier)}/{min(validate_budget, len(survivors))} "
        f"survivors of {modeled} modeled{detail}", slo, frontier,
        modeled=modeled, pruned=n_pruned, survivors=survivors,
        build_s=build_s, indexes=index_cache)


def autotune_service(points, slo: SLO = SLO(), **kwargs):
    """One-call deploy: tune, then stand the winning fleet up.  Returns
    ``(service, result)`` — the service is built over the index the
    validation stage already trained (no rebuild), warmed, and ready;
    ``result.spec.save(path)`` persists the deploy artifact."""
    from repro_torch.service.service import AnnService

    result = autotune(points, slo, **kwargs)
    svc = AnnService.build(result.spec, index=result.index)
    svc.warmup()
    return svc, result
