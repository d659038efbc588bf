"""Self-contained service-layer smoke: ``python -m repro_torch.service
--selftest``.

Builds a tiny corpus and index on ``--device`` (default the card), stands
up AnnService five times and asserts the service invariants end to end:

  * 1-replica local search == direct ``search_ivfpq`` (same bits);
  * 2 replicas behind the cache-aware router with the LUT cache: streamed
    per-request results match the direct batch per query, under the
    virtual-clock simulator or the wall-clock executor path (``--clock
    virtual|wall``); every request was routed (pick counts sum to the
    request count);
  * the uint8 spec with a byte-budgeted cache: neighbour overlap with f32
    >= 0.8, every streamed request served, the cache within its budget;
  * the live index (``ServiceSpec(mutable=True)``, 2 replicas): upserted
    ids retrieve themselves, deleted ids never surface, before or after a
    forced maintenance generation; then the skewed stream on ``--clock``
    over the new generation equals a direct batch;
  * tiered storage (``ServiceSpec(storage="tiered")``, a budget a quarter
    of the index): search equals the all-resident service bit for bit,
    before and after residency churn, the resident bytes stay within the
    budget and cold fetches happened; then the skewed stream on
    ``--clock`` equals a direct batch.

``--selftest-tenants`` runs the multi-tenant smoke instead: two tenants
with disjoint halves of the corpus on one shared index (isolation, the
predicate filter, quotas and weighted fair queueing; see
:func:`selftest_tenants`).  ``--spec deploy.json`` boots the smoke fleet
from a deploy file instead (the same schema as ``repro.service``).
``--selftest-chaos`` runs the fault-injection chaos smoke (a Zipf stream
over an armed two-replica tiered fleet; see :mod:`repro_torch.service.
chaos`).  ``--autotune`` derives a spec for a small corpus with the
SLO-driven auto-tuner and prints its report (``--save-spec out.json``
persists the winning spec; exit 1 when the SLO is infeasible).  Each
runs on ``--device``.

Exit code 0 on success.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"selftest failed: {msg}")


def _corpus_and_index(device: str):
    import torch

    from repro_torch.core import build_ivfpq
    from repro_torch.data import make_clustered_corpus

    ds = make_clustered_corpus(0, 2000, 16, n_queries=16, n_components=8,
                               device=device)
    index = build_ivfpq(torch.Generator().manual_seed(0), ds.points,
                        nlist=16, m=8, cb=32, kmeans_iters=4, pq_iters=4,
                        device=device)
    return ds, index


def _stream(queries: np.ndarray):
    """24 requests every 0.5 ms over a hot pool of 4 queries."""
    pool = np.arange(24) % 4
    return pool, [(i * 5e-4, queries[pool[i]]) for i in range(24)]


def selftest(clock: str = "virtual", device: str = "cuda") -> int:
    import torch

    from repro_torch.core import SearchParams, pad_clusters, search_ivfpq
    from repro_torch.service import AnnService, ServiceSpec

    ds, index = _corpus_and_index(device)
    queries = ds.queries.float().cpu().numpy()

    # -- 1 replica, no cache: facade == direct pipeline -------------------
    spec1 = ServiceSpec(engine="local", replicas=1, nprobe=4, k=5,
                        buckets=(1, 2, 4), max_wait_s=1e-3)
    svc1 = AnnService.build(spec1, index=index)
    d_s, i_s = svc1.search(queries)
    d_d, i_d = (x.cpu().numpy() for x in search_ivfpq(
        index, pad_clusters(index), torch.from_numpy(queries).to(device),
        SearchParams(nprobe=4, k=5, use_kernels=True)))
    _check(np.array_equal(i_s, i_d) and np.array_equal(d_s, d_d),
           "1-replica search differs from search_ivfpq")
    svc1.shutdown()
    print("[selftest] 1-replica search == search_ivfpq: OK")

    # -- 2 replicas, cache-aware router, skewed stream --------------------
    spec2 = ServiceSpec(engine="local", replicas=2, router="cache_aware",
                        nprobe=4, k=5, cache_capacity=512,
                        buckets=(1, 2, 4), max_wait_s=1e-3)
    svc2 = AnnService.build(spec2, index=index)
    svc2.warmup()
    _, direct_i = svc2.search(queries)
    pool, stream = _stream(queries)
    reqs = svc2.stream(stream, clock=clock)
    for i, r in enumerate(reqs):
        _check(np.array_equal(r.ids, direct_i[pool[i]]),
               f"streamed request {i} differs from the direct batch")
    st = svc2.stats()
    _check(sum(st["router"]["picks"]) == len(reqs), f"{st['router']}")
    _check(st["aggregate"]["requests"] == len(reqs), "request count")
    print(f"[selftest] streamed {len(reqs)} requests over 2 replicas "
          f"(clock={clock} router={st['router']['policy']} "
          f"picks={st['router']['picks']} "
          f"lut_hit_rate={st['aggregate'].get('lut_hit_rate', 0.0):.2f}): OK")
    svc2.shutdown()

    # -- quantized-LUT fast path: uint8 spec, byte-budgeted cache ---------
    spec3 = ServiceSpec(engine="local", replicas=1, nprobe=4, k=5,
                        lut_dtype="uint8", cache_capacity_bytes=1 << 20,
                        buckets=(1, 2, 4), max_wait_s=1e-3)
    svc3 = AnnService.build(spec3, index=index)
    svc3.warmup()
    _, i_q = svc3.search(queries)
    # quantized distances are compared via neighbour overlap, not values
    overlap = np.mean([len(set(i_q[r]) & set(i_d[r])) / 5.0
                       for r in range(len(queries))])
    _check(overlap >= 0.8, f"u8-vs-f32 neighbour overlap {overlap:.2f}")
    reqs3 = svc3.stream(stream, clock=clock)
    _check(all(r.ids is not None and len(r.ids) == 5 for r in reqs3),
           "uint8 stream left requests unserved")
    st3 = svc3.stats()
    cache_bytes = st3["replicas"][0]["lut_cache"]["bytes"]
    _check(0 < cache_bytes <= (1 << 20), f"cache bytes {cache_bytes}")
    print(f"[selftest] uint8 spec: overlap={overlap:.2f} "
          f"hit_rate={st3['aggregate'].get('lut_hit_rate', 0.0):.2f} "
          f"cache_bytes={cache_bytes}: OK")
    svc3.shutdown()

    # -- live-index mutation: upsert / delete / maintenance ---------------
    spec4 = ServiceSpec(engine="local", replicas=2, nprobe=4, k=5,
                        mutable=True, buckets=(1, 2, 4), max_wait_s=1e-3)
    points = ds.points.float().cpu().numpy()
    svc4 = AnnService.build(spec4, points=points, device=device)
    new_ids = np.arange(2000, 2064)
    new_vecs = points[:64] + 1e-2
    svc4.upsert(new_ids, new_vecs)
    _, i_m = svc4.search(new_vecs)
    overlap = float(np.mean([new_ids[r] in i_m[r]
                             for r in range(len(new_ids))]))
    _check(overlap >= 0.9, f"upsert self-retrieval overlap {overlap:.2f}")
    gone = new_ids[:32]
    svc4.delete(gone)
    _, i_d2 = svc4.search(new_vecs)
    _check(not np.isin(i_d2, gone).any(), "deleted ids surfaced in results")
    kept = new_ids[32:]
    kept_hits = float(np.mean([kept[r] in i_d2[32 + r]
                               for r in range(len(kept))]))
    _check(kept_hits >= 0.9, f"survivor retrieval {kept_hits:.2f}")
    maint = svc4.run_maintenance(force=True)
    _check(maint["ran"], f"maintenance did not run: {maint}")
    _, i_g = svc4.search(new_vecs)
    _check(not np.isin(i_g, gone).any(),
           "deleted ids resurfaced after maintenance")
    mstats = svc4.stats()["mutation"]
    _check(mstats["generation"] >= 1 and mstats["deletes"] == len(gone),
           f"mutation stats {mstats}")
    _, direct4 = svc4.search(queries)
    reqs4 = svc4.stream(stream, clock=clock)
    for i, r in enumerate(reqs4):
        _check(np.array_equal(r.ids, direct4[pool[i]]),
               f"streamed request {i} differs from the direct batch after "
               f"the generation swap")
    print(f"[selftest] mutation: upserted {len(new_ids)} "
          f"(overlap={overlap:.2f}), deleted {len(gone)}, "
          f"maintenance gen={mstats['generation']} "
          f"nlist={mstats['nlist']}, streamed {len(reqs4)} requests "
          f"(clock={clock}): OK")
    svc4.shutdown()

    # -- tiered storage: beyond-memory serving, results unchanged ---------
    import shutil
    import tempfile

    spec5_kw = dict(engine="local", replicas=1, nprobe=4, k=5,
                    buckets=(1, 2, 4), max_wait_s=1e-3)
    ref5 = AnnService.build(ServiceSpec(**spec5_kw), index=index)
    d_r5, i_r5 = ref5.search(queries)
    ref5.shutdown()
    tdir = tempfile.mkdtemp(prefix="selftest_tier_")
    try:
        spec5 = ServiceSpec(storage="tiered", storage_dir=tdir,
                            storage_budget_bytes=1, **spec5_kw)  # all cold
        svc5 = AnnService.build(spec5, index=index)
        tier = svc5.index.tiered_store
        budget = max(tier.total_bytes // 4, tier.bytes_per_cluster)
        svc5.shutdown()
        spec5 = ServiceSpec(storage="tiered", storage_dir=tdir + "/q",
                            storage_budget_bytes=budget, **spec5_kw)
        svc5 = AnnService.build(spec5, index=index)
        tier = svc5.index.tiered_store
        _check(tier.total_bytes >= 4 * tier.budget_bytes >= 4,
               f"budget {tier.budget_bytes} of {tier.total_bytes}")
        d_t5, i_t5 = svc5.search(queries)
        _check(np.array_equal(i_t5, i_r5) and np.array_equal(d_t5, d_r5),
               "tiered search differs from the all-resident service")
        for _ in range(4):                   # churn residency; stay exact
            svc5.search(queries)
        d_t6, i_t6 = svc5.search(queries)
        _check(np.array_equal(i_t6, i_r5) and np.array_equal(d_t6, d_r5),
               "tiered search differs after residency churn")
        _check(tier.resident_bytes <= tier.budget_bytes,
               f"resident {tier.resident_bytes} B over the budget")
        reqs5 = svc5.stream(stream, clock=clock)
        for i, r in enumerate(reqs5):
            _check(np.array_equal(r.ids, i_r5[pool[i]]),
                   f"streamed request {i} differs from the direct batch "
                   f"on the tiered service")
        tinfo = svc5.stats()["tier"]
        _check(tinfo["cold_fetches"] > 0, f"no cold fetch: {tinfo}")
        print(f"[selftest] tiered: {tinfo['total_bytes']}B index under "
              f"{tinfo['budget_bytes']}B budget "
              f"(resident={tinfo['resident_clusters']}/{index.nlist} "
              f"hot_rate={tinfo['hot_rate']:.2f}), streamed {len(reqs5)} "
              f"requests (clock={clock}); results == all-resident: OK")
        svc5.shutdown()
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    print(f"[selftest] repro_torch.service OK (clock={clock} "
          f"device={device})")
    return 0


def _same_up_to_ties(d1, i1, d2, i2, rtol=1e-5, atol=1e-5) -> bool:
    """(Q, k) results agree: distances within tolerance (an (inf, -1)
    tail on both sides), ids equal except among rows tied at the k-th
    distance (the top-k's tie order is the implementation's)."""
    def fin(d):
        return np.where(np.isfinite(d), d, 0.0)
    if not (np.array_equal(np.isfinite(d1), np.isfinite(d2))
            and np.allclose(fin(d1), fin(d2), rtol=rtol, atol=atol)):
        return False
    for r in np.nonzero((i1 != i2).any(axis=1))[0]:
        tied = np.isclose(fin(d2[r]), fin(d2[r, -1]), rtol=rtol, atol=atol)
        if set(i1[r][~tied].tolist()) != set(i2[r][~tied].tolist()):
            return False
    return True


def selftest_tenants(device: str = "cuda") -> int:
    """Multi-tenant serving smoke: two tenants with disjoint halves of the
    corpus on one shared index.  Asserts isolation (a tenant's results
    never hold the other's rows, and equal a dedicated single-tenant
    index over the same rows, up to ties at the k-th place), the
    predicate filter against the host-side reference mask, quotas (the
    rate-limited tenant is shed, the unlimited one never), and the fair
    queue's accounting in ``stats()``."""
    import time

    import torch

    from repro_torch.core import SearchParams, pad_clusters, search_ivfpq
    from repro_torch.core.filter import tenant_subindex
    from repro_torch.service import AnnService, ServiceSpec, TenantThrottled

    ds, index = _corpus_and_index(device)
    queries = ds.queries.float().cpu().numpy()
    n = len(ds.points)
    tenants = np.zeros(n, np.int32)
    tenants[n // 2:] = 1                        # disjoint halves
    tags = (np.arange(n, dtype=np.uint32) % 3)[:, None]

    spec = ServiceSpec(engine="local", replicas=2, nprobe=4, k=5,
                       buckets=(1, 2, 4), max_wait_s=1e-3,
                       tenants=(("anna", 0, 4.0, 0.0, 1),
                                ("zoe", 1, 1.0, 25.0, 2)),
                       qos_wfq=True)
    svc = AnnService.build(spec, index=index, points=ds.points.cpu().numpy(),
                           tenants=tenants, tags=tags)
    svc.warmup()
    meta = svc.index.meta

    # isolation: scoped == dedicated single-tenant index
    for name, tid in (("anna", 0), ("zoe", 1)):
        d_s, i_s = svc.search(queries, tenant=name)
        live = i_s[i_s >= 0]
        _check(live.size > 0 and bool(np.all(tenants[live] == tid)),
               f"tenant {name}: result holds another tenant's rows")
        sub, members = tenant_subindex(index, meta, tid)
        p = min(4, len(members))
        d_ref, i_ref = (x.cpu().numpy() for x in search_ivfpq(
            sub, pad_clusters(sub), torch.from_numpy(queries).to(device),
            SearchParams(nprobe=p, k=5, use_kernels=True)))
        _check(_same_up_to_ties(d_s, i_s, d_ref, i_ref),
               f"tenant {name}: scoped search differs from the dedicated "
               f"sub-index")
    print("[tenants] isolation: scoped == dedicated subindex (both "
          "tenants): OK")

    # predicate filtering: every returned row carries a requested term
    _, i_f = svc.search(queries, tenant="anna", terms=(1,))
    live = i_f[i_f >= 0]
    _check(live.size > 0
           and bool(np.all(meta.match_host(live, tenant=0, terms=(1,)))),
           "filtered result row fails the predicate")
    print("[tenants] predicate filter (tag==1 under tenant anna): OK")

    # quotas + WFQ on the executor path: anna unlimited, zoe 25 qps
    shed = 0
    futs = []
    for j in range(150):
        who = "anna" if j % 2 else "zoe"
        try:
            futs.append((who, svc.submit_async(queries[j % len(queries)],
                                               tenant=who)))
        except TenantThrottled:
            shed += 1
    for _, f in futs:
        f.result(timeout=60.0)
    deadline = time.monotonic() + 10.0     # the done callbacks run last
    while svc.wfq.stats()["in_flight"] and time.monotonic() < deadline:
        time.sleep(0.001)
    st = svc.stats()
    ten = st["tenants"]
    _check(ten["anna"]["shed"] == 0, f"{ten}")
    _check(ten["zoe"]["shed"] == shed > 0, f"shed {shed}, {ten}")
    _check(ten["anna"]["requests"] + ten["zoe"]["requests"] == len(futs),
           f"{ten}")
    _check(st["qos"]["queued"] == 0 and st["qos"]["in_flight"] == 0,
           f"{st['qos']}")
    _check({w for w, _ in futs} == {"anna", "zoe"}, "a tenant went unserved")
    print(f"[tenants] quotas: zoe shed {shed} over-rate submits, anna 0; "
          f"WFQ dispatched {st['qos']['dispatched']}: OK")
    svc.shutdown()
    print(f"[tenants] multi-tenant serving OK (device={device})")
    return 0


def spec_smoke(spec_path: str, clock: str, device: str = "cuda") -> int:
    """Boot the selftest fleet from a durable deploy file and stream the
    same skewed trace through it."""
    from repro_torch.service import AnnService, ServiceSpec

    spec = ServiceSpec.load(spec_path)
    ds, _ = _corpus_and_index(device)
    queries = ds.queries.float().cpu().numpy()
    svc = AnnService.build(spec, points=ds.points.cpu().numpy(),
                           sample_queries=queries, device=device)
    svc.warmup()
    _, direct_i = svc.search(queries)
    pool, stream = _stream(queries)
    reqs = svc.stream(stream, clock=clock)
    for i, r in enumerate(reqs):
        _check(set(r.ids.tolist()) == set(direct_i[pool[i]].tolist()),
               f"streamed request {i} differs from the direct batch")
    st = svc.stats()
    _check(sum(st["router"]["picks"]) == len(reqs), f"{st['router']}")
    print(f"[spec] {spec_path}: booted {svc.n_replicas} replica(s) "
          f"engine={spec.engine} router={st['router']['policy']}, "
          f"streamed {len(reqs)} requests (clock={clock}): OK")
    svc.shutdown()
    return 0


def autotune_smoke(slo_recall: float, slo_p99_ms: float,
                   save_spec: Optional[str], device: str = "cuda") -> int:
    """Derive a deploy spec for the smoke corpus: run the SLO-driven
    auto-tuner (perf-model shortlist -> measured calibration) and print
    its report; ``save_spec`` persists the winning ServiceSpec."""
    from repro_torch.data import make_clustered_corpus
    from repro_torch.service import SLO, SLOInfeasible, TuneSpace, autotune

    ds = make_clustered_corpus(0, 3000, 16, n_queries=48, n_components=12,
                               k_gt=10, device=device)
    space = TuneSpace(m=(4, 8), nprobe=(2, 4, 8),
                      lut_dtype=("uint8", "f32"), buckets=((1, 2, 4, 8),),
                      tasks_per_shard=(1024,),
                      cache_capacity_bytes=(0, 1 << 19))
    slo = SLO(recall_at_k=slo_recall, p99_ms=slo_p99_ms)
    try:
        res = autotune(ds.points, slo, queries=ds.queries,
                       groundtruth=ds.groundtruth, space=space, nlist=16,
                       calibration_requests=48, validate_budget=6, seed=0,
                       device=device)
    except SLOInfeasible as e:
        print(f"[autotune] INFEASIBLE: {e}")
        for entry in e.frontier:
            print(f"[autotune]   frontier: m={entry['m']} "
                  f"nprobe={entry['nprobe']} lut={entry['lut_dtype']} "
                  f"recall={entry['recall']:.3f} "
                  f"p99={entry['p99_ms']:.2f}ms")
        return 1
    for line in res.report().splitlines():
        print(f"[autotune] {line}")
    if save_spec:
        path = res.spec.save(save_spec)
        print(f"[autotune] spec saved -> {path} "
              f"(boot it with --spec {path})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.service",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true",
                    help="run the end-to-end service smoke test")
    ap.add_argument("--clock", choices=("virtual", "wall"),
                    default="virtual",
                    help="stream driver for the smoke: discrete-event "
                         "simulation or wall-clock executors")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the smoke's index and engines live")
    ap.add_argument("--selftest-tenants", action="store_true",
                    help="run the multi-tenant serving smoke test")
    ap.add_argument("--selftest-chaos", action="store_true",
                    help="run the fault-injection chaos smoke: Zipf "
                         "stream over an armed fleet; asserts "
                         "availability >= 0.95, zero corrupt results, "
                         "and corrupted-spill rebuild")
    ap.add_argument("--chaos-queries", type=int, default=1000,
                    help="chaos smoke: stream length (default 1000)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="chaos smoke: FaultPlan / stream seed")
    ap.add_argument("--spec", metavar="PATH",
                    help="boot the smoke fleet from a ServiceSpec deploy "
                         "file (.json/.yaml) instead of built-in specs")
    ap.add_argument("--autotune", action="store_true",
                    help="derive a spec for the smoke corpus with the "
                         "SLO-driven auto-tuner and print its report")
    ap.add_argument("--slo-recall", type=float, default=0.8,
                    help="autotune: required recall@10 (default 0.8)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="autotune: paced p99 budget in ms (default 50)")
    ap.add_argument("--save-spec", metavar="PATH",
                    help="autotune: persist the winning ServiceSpec as a "
                         "deploy file (.json/.yaml)")
    args = ap.parse_args(argv)
    if args.selftest_chaos:
        from repro_torch.service.chaos import selftest_chaos
        return selftest_chaos(seed=args.chaos_seed,
                              n_queries=args.chaos_queries,
                              device=args.device)
    if args.selftest_tenants:
        return selftest_tenants(args.device)
    if args.autotune:
        return autotune_smoke(args.slo_recall, args.slo_p99_ms,
                              args.save_spec, args.device)
    if args.spec:
        return spec_smoke(args.spec, args.clock, args.device)
    if not args.selftest:
        ap.print_help()
        return 2
    return selftest(args.clock, args.device)


if __name__ == "__main__":
    sys.exit(main())
