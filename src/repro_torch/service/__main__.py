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

``--spec deploy.json`` boots the smoke fleet from a deploy
file instead (the same schema as ``repro.service``).  The reference CLI's
``--selftest-chaos``, ``--selftest-tenants`` and ``--autotune`` are not
ported; asking for one prints the ROADMAP item it waits for and exits 2.

Exit code 0 on success.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

#: what the reference CLI offers and this one does not run yet
NOT_PORTED = {
    "selftest_chaos": ("--selftest-chaos (fault-injection smoke)", 9),
    "selftest_tenants": ("--selftest-tenants (multi-tenant smoke)", 8),
    "autotune": ("--autotune (SLO-driven auto-tuner)", 10),
}


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
    ap.add_argument("--spec", metavar="PATH",
                    help="boot the smoke fleet from a ServiceSpec deploy "
                         "file (.json/.yaml) instead of built-in specs")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help=f"not ported yet (ROADMAP item "
                             f"{NOT_PORTED[flag][1]})")
    args = ap.parse_args(argv)
    for flag, (what, item) in NOT_PORTED.items():
        if getattr(args, flag):
            print(f"{what} is not ported to repro_torch yet: it waits for "
                  f"ROADMAP item {item}", file=sys.stderr)
            return 2
    if args.spec:
        return spec_smoke(args.spec, args.clock, args.device)
    if not args.selftest:
        ap.print_help()
        return 2
    return selftest(args.clock, args.device)


if __name__ == "__main__":
    sys.exit(main())
