"""Chaos harness: drive a fault-injected fleet and measure what survives.

The port of ``repro/service/chaos.py``.  The fail-operational claim is
only testable under faults, so this module owns the one canonical
experiment (shared by ``python -m repro_torch.service --selftest-chaos``,
tests/test_torch_chaos.py and ``chip_smoke.py``): build a tiered-storage
fleet, arm a seeded :class:`~repro_torch.runtime.faults.FaultPlan`
(replica batch crashes, cold-read IOErrors, a straggler delay, and one
corrupted spill cluster), stream a Zipf-skewed query trace through the
wall-clock executor path, and report

  * **availability** -- answered / submitted (failed + shed count
    against it);
  * **correctness** -- every *non-degraded* answer must be bit-identical
    to the same spec's fault-free run (``corrupt_results`` == 0 is the
    hard floor: faults may cost probes, never wrong bytes);
  * **degraded accounting** -- degraded answers are flagged in
    ``future.timing()`` and exact over what was scanned (recall is
    reported so the cost of degradation is visible);
  * **integrity** -- the corrupted spill cluster is caught by the CRC
    path and rebuilt from the resident copy on the card (demote-time
    heal or the end-of-run ``verify(repair=True)`` scrub).

:func:`run_chaos` is the reference's experiment at the reference's size
(n = 4,000, d = 16); :func:`chaos_experiment` runs the same fleet, plan
and stream over any prebuilt index and query pool (the smoke runs it at
N = 10M on the card).  A request that fails for any reason other than
an injected fault (a kernel or CUDA error, a timeout) is not counted as
the plan's: it lands in ``errors``, and :func:`selftest_chaos` requires
that list to be empty.

Determinism: the injector's per-site decision *sequences* are pure
functions of the plan seed (see :mod:`repro_torch.runtime.faults`);
which request a firing lands on depends on wall-clock batch composition,
so the assertions are interleaving-invariant (floors and exactness sets,
not exact counts).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Optional

import numpy as np

from repro_torch.runtime.faults import (FaultInjector, FaultPlan, FaultRule,
                                        InjectedFault)


def zipf_stream(n_queries: int, pool_size: int, seed: int,
                exponent: float = 1.1) -> np.ndarray:
    """Zipf-skewed query indices: rank r drawn with p ~ 1/(r+1)^exp."""
    p = 1.0 / np.power(np.arange(1, pool_size + 1), exponent)
    p /= p.sum()
    rng = np.random.default_rng(seed)
    return rng.choice(pool_size, size=int(n_queries), p=p)


def default_plan(seed: int = 0, *, batch_fail_rate: float = 0.02,
                 cold_read_rate: float = 0.05,
                 straggler_rate: float = 0.05,
                 straggler_delay_s: float = 5e-3) -> FaultPlan:
    """The canonical chaos plan: replica crashes + cold-read IOErrors +
    stragglers + exactly one corrupted spill cluster."""
    return FaultPlan(seed=seed, rules=(
        FaultRule("engine.batch", rate=batch_fail_rate),
        FaultRule("tier.cold_read", rate=cold_read_rate),
        FaultRule("engine.straggler", rate=straggler_rate,
                  delay_s=straggler_delay_s),
        FaultRule("tier.spill_corrupt", count=1, after=4),
    ))


def injected(err: BaseException) -> bool:
    """True when ``err`` (or what it wraps) is an :class:`InjectedFault`
    (the tier's injected cold-read ``IOError`` is one too)."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, InjectedFault):
            return True
        err = getattr(err, "cause", None) or err.__cause__
    return False


def chaos_spec(*, replicas: int = 2, deadline_ms: float = 50.0,
               budget_bytes: int = 1, storage_dir=None, nprobe: int = 8,
               k: int = 10, lut_dtype: str = "f32",
               promote_margin: float = 1.25):
    """The harness's fleet: tiered local replicas, deadline-bounded,
    with retries, a circuit breaker and checksums armed.
    ``promote_margin`` is the tier's anti-thrash hysteresis (the spec's
    default 1.25)."""
    from repro_torch.service.spec import ServiceSpec
    return ServiceSpec(
        engine="local", replicas=replicas, nprobe=nprobe, k=k,
        lut_dtype=lut_dtype, buckets=(1, 2, 4, 8), max_wait_s=1e-3,
        storage="tiered", storage_dir=storage_dir,
        storage_budget_bytes=budget_bytes,
        storage_promote_margin=promote_margin, deadline_ms=deadline_ms, max_retries=2, backoff_base_ms=1.0,
        breaker_threshold=3, breaker_half_open_s=0.05, checksum=True)


def chaos_experiment(index, pool: np.ndarray, groundtruth: np.ndarray, *,
                     seed: int = 0, n_queries: int = 1000,
                     replicas: int = 2, deadline_ms: float = 50.0,
                     interval_s: float = 5e-4,
                     plan: Optional[FaultPlan] = None,
                     budget_bytes: Optional[int] = None,
                     lut_dtype: str = "f32", nprobe: int = 8, k: int = 10,
                     skew: float = 1.1, promote_margin: float = 1.25,
                     spill_root=None, verbose: bool = False) -> dict:
    """The canonical experiment over a prebuilt ``index`` (an
    ``IVFPQIndex``; the fleets run on its device) and a query ``pool``
    ((Q, D) f32, host); ``groundtruth`` (Q, >= k) holds the exact ids of
    every pool row the stream draws.  The stream is
    ``zipf_stream(n_queries, Q, seed, skew)``: the reference's Zipf(1.1)
    by default, uniform draws at ``skew`` 0.

    Every batch's CL output is observed, and its cold probes promoted,
    before its own gather; at the default ``promote_margin`` a cold
    cluster displaces any resident one whose decayed heat is below
    1/1.25 of its own, so a batch whose probes fit the slab meets no cold
    row and never reaches ``tier.cold_read``.  A large margin (1e6) lets
    a probed cluster displace only never-probed residents: once those are
    gone, a hot set past the budget is read from the host.

    ``budget_bytes`` None sizes the tier as the reference does, a
    quarter of the padded clusters (at least one).  Each fleet spills
    into a fresh directory under ``spill_root`` (default: the system's
    temporary directory), removed when the fleet shuts down.

    Pure measurement -- callers assert their own floors on the report.
    Keys: ``submitted``, ``answered``, ``failed``, ``shed``,
    ``availability``, ``degraded``, ``deadline_missed``,
    ``corrupt_results``, ``recall``, ``recall_non_degraded``,
    ``rebuilds``, ``quarantined``, ``fault_stats``, ``verify``, and the
    port's ``errors`` (requests failed for non-injected reasons),
    ``batch_failures`` (batches the executors saw fail), ``corrupted`` (the
    clusters ``tier.spill_corrupt`` rotted), ``healed_by`` ("demote",
    "verify" or None), ``degraded_gathers`` / ``dropped_probes`` (the
    armed tier's ``TierStats``), ``p50_ms`` / ``p99_ms`` (wall, answered
    requests) and ``wall_s``."""
    from repro_torch.service import AnnService, ServiceOverloaded

    pool = np.asarray(pool, np.float32)
    gt = np.asarray(groundtruth)
    dirs = []

    def build(budget, injector=None):
        d = tempfile.mkdtemp(prefix="chaos_tier_", dir=spill_root)
        dirs.append(d)
        spec = chaos_spec(replicas=replicas, deadline_ms=deadline_ms,
                          budget_bytes=budget, storage_dir=d, nprobe=nprobe,
                          k=k, lut_dtype=lut_dtype,
                          promote_margin=promote_margin)
        return AnnService.build(spec, index=index, fault_injector=injector)

    try:
        if budget_bytes is None:
            # size the tier so a real cold set exists: ~1/4 resident
            probe = build(1)
            tier = probe.index.tiered_store
            budget_bytes = max(tier.total_bytes // 4, tier.bytes_per_cluster)
            probe.shutdown()
            shutil.rmtree(dirs.pop(), ignore_errors=True)

        # -- fault-free reference: the bit-exactness oracle ---------------
        ref = build(budget_bytes)
        _, ref_ids = ref.search(pool)
        ref_ids = np.asarray(ref_ids)
        ref.shutdown()
        shutil.rmtree(dirs.pop(), ignore_errors=True)

        # -- armed fleet ---------------------------------------------------
        plan = plan if plan is not None else default_plan(seed)
        injector = FaultInjector(plan)
        svc = build(budget_bytes, injector)
        svc.warmup()

        qidx = zipf_stream(n_queries, len(pool), seed, skew)
        futures = []          # (pool_idx, future)
        shed = 0
        t0 = time.monotonic()
        for i, qi in enumerate(qidx):
            target = t0 + i * interval_s
            dt = target - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            try:
                futures.append((int(qi), svc.submit_async(pool[qi])))
            except ServiceOverloaded:
                shed += 1

        answered = failed = degraded = missed = corrupt = 0
        recalls, recalls_nd, lat, errors = [], [], [], []
        for qi, fut in futures:
            try:
                _, ids = fut.result(timeout=60.0)
            except Exception as e:                       # noqa: BLE001
                if injected(e):
                    failed += 1
                else:
                    errors.append(repr(e))
                continue
            answered += 1
            t = fut.timing()
            lat.append(t["total_s"])
            r = len(set(np.asarray(ids).tolist())
                    & set(gt[qi, :k].tolist())) / float(k)
            recalls.append(r)
            if t["degraded"]:
                degraded += 1
            else:
                recalls_nd.append(r)
                if not np.array_equal(np.asarray(ids), ref_ids[qi]):
                    corrupt += 1
            if t["deadline_missed"]:
                missed += 1
        wall_s = time.monotonic() - t0

        tier = svc.index.tiered_store
        rebuilds_before = int(tier.stats.rebuilds)
        verify = tier.verify(repair=True)
        rebuilds = int(tier.stats.rebuilds)
        quarantined = sorted(tier.quarantined)
        corrupted = list(tier.fault_corrupted)
        tier_stats = (int(tier.stats.degraded_gathers),
                      int(tier.stats.dropped_probes))
        stats = svc.stats()
        batch_failures = sum(ex.failures for ex in svc._executors)
        try:
            svc.shutdown()
        except RuntimeError:
            pass                  # a wedged worker must not eat the report
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)

    healed_by = None
    if corrupted:
        if any(c in verify["rebuilt"] for c in corrupted):
            healed_by = "verify"
        elif rebuilds_before > 0:
            healed_by = "demote"
    report = {
        "seed": seed,
        "submitted": int(n_queries),
        "answered": answered,
        "failed": failed,
        "shed": shed,
        "availability": answered / max(n_queries, 1),
        "degraded": degraded,
        "deadline_missed": missed,
        "corrupt_results": corrupt,
        "recall": float(np.mean(recalls)) if recalls else 0.0,
        "recall_non_degraded": (float(np.mean(recalls_nd))
                                if recalls_nd else 0.0),
        "rebuilds": rebuilds,
        "quarantined": quarantined,
        "verify": verify,
        "fault_stats": injector.stats(),
        "retries": stats["aggregate"]["retries"],
        "breaker": stats["health"]["breaker"],
        "errors": errors,
        "batch_failures": batch_failures,
        "corrupted": corrupted,
        "healed_by": healed_by,
        "degraded_gathers": tier_stats[0],
        "dropped_probes": tier_stats[1],
        "p50_ms": float(np.percentile(lat, 50)) * 1e3 if lat else 0.0,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3 if lat else 0.0,
        "wall_s": wall_s,
    }
    if verbose:
        for key in ("availability", "answered", "failed", "degraded",
                    "deadline_missed", "corrupt_results", "recall",
                    "recall_non_degraded", "rebuilds", "quarantined",
                    "retries", "errors"):
            print(f"[chaos] {key} = {report[key]}")
        print(f"[chaos] fault_stats = {report['fault_stats']}")
    return report


def run_chaos(*, seed: int = 0, n_queries: int = 1000, replicas: int = 2,
              deadline_ms: float = 50.0, interval_s: float = 5e-4,
              plan: Optional[FaultPlan] = None, verbose: bool = False,
              device="cuda") -> dict:
    """Run the canonical experiment at the reference's size on
    ``device``; returns the report dict (see :func:`chaos_experiment`)."""
    import torch

    from repro_torch.core import build_ivfpq
    from repro_torch.data import make_clustered_corpus

    ds = make_clustered_corpus(seed, 4000, 16, n_queries=64,
                               n_components=8, k_gt=10, device=device)
    index = build_ivfpq(torch.Generator().manual_seed(seed), ds.points,
                        nlist=32, m=8, cb=32, kmeans_iters=4, pq_iters=4,
                        device=device)
    return chaos_experiment(
        index, ds.queries.float().cpu().numpy(),
        ds.groundtruth.cpu().numpy(), seed=seed, n_queries=n_queries,
        replicas=replicas, deadline_ms=deadline_ms, interval_s=interval_s,
        plan=plan, verbose=verbose)


def check_floors(report: dict, *, degraded: bool = False) -> None:
    """The reference's floors on a chaos report (``selftest_chaos``),
    plus the port's: no request and no batch failed for a non-injected
    reason.  ``degraded`` (a run whose hot set exceeds the resident
    budget) also requires that ``tier.cold_read`` fired, that the tier
    dropped probes and that answers came back degraded.  Raises
    ``RuntimeError`` naming the first floor missed."""
    fs = report["fault_stats"]
    fired = fs.get("engine.batch", {}).get("fires", 0)
    floors = () if not degraded else (
        (fs.get("tier.cold_read", {}).get("fires", 0) > 0,
         f"tier.cold_read never fired: {fs.get('tier.cold_read')}"),
        (report["dropped_probes"] > 0, "the tier dropped no probe"),
        (report["degraded"] > 0, "no answer came back degraded"),
    )
    floors += (
        (report["availability"] >= 0.95,
         f"availability {report['availability']:.3f} < 0.95"),
        (report["corrupt_results"] == 0,
         f"{report['corrupt_results']} non-degraded results diverged from "
         f"the fault-free run"),
        (not report["errors"],
         f"requests failed for non-injected reasons: "
         f"{report['errors'][:3]}"),
        # a batch retried elsewhere after a real (kernel, CUDA) error
        # would still be answered: every failed batch must be injected
        (report["batch_failures"] == fired,
         f"{report['batch_failures']} batches failed, {fired} injected"),
        (fired > 0, "chaos plan never fired engine.batch -- harness is "
                    "not armed"),
        (fs.get("tier.spill_corrupt", {}).get("fires", 0) == 1,
         f"tier.spill_corrupt did not fire exactly once: {fs}"),
        (report["rebuilds"] > 0 or len(report["verify"]["rebuilt"]) > 0,
         f"corrupted spill cluster was never rebuilt: {report['verify']}"),
        (not report["quarantined"] or bool(report["verify"]["corrupt"]),
         f"quarantined {report['quarantined']} without corruption seen by "
         f"verify"),
    )
    for ok, msg in floors:
        if not ok:
            raise RuntimeError(f"chaos floor missed: {msg}")


def selftest_chaos(seed: int = 0, n_queries: int = 1000,
                   device="cuda") -> int:
    """CI gate: run the canonical experiment and assert the floors."""
    report = run_chaos(seed=seed, n_queries=n_queries, verbose=True,
                       device=device)
    check_floors(report)
    print(f"[selftest-chaos] availability="
          f"{report['availability']:.3f} degraded={report['degraded']} "
          f"recall={report['recall']:.3f} rebuilds={report['rebuilds']} "
          f"corrupt_results=0: OK (device={device})")
    return 0
