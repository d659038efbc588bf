"""Port parity for the live index: the mutable ``Index``, the engines'
install and generation-swap hooks, ``MutationCoordinator`` and
``AnnService(mutable=True)``.

Exact tests start both packages from one reference-built handle carried
across by ``convert.py`` and apply the same operations: store rows, ids,
sizes, locator, counters, plans and search results must agree (ids as
sets, distances at rtol 1e-4 / atol 1e-3).  Generations the port builds
itself draw from a ``torch.Generator`` where the reference draws from
``jax.random``, so they are held to the oracle instead: brute force over
the live set, no dead id at any nprobe, every live id in exactly one
scanned row, and churned recall no further below a rebuild's than the
reference's own gap plus 0.01 (the reference's 0.0035 bound fails on the
reference itself, ROADMAP §3).

Everything here runs on the CPU, where ``kernels.ops`` runs the kernels'
plain versions.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Index as RefIndex
from repro.core import SearchParams as RefParams
from repro.core import build_ivfpq as ref_build
from repro.core import pad_clusters as ref_pad
from repro.core import search_ivfpq as ref_search
from repro.core import sharded_search as ref_ss
from repro.core.search import cluster_locate as ref_locate
from repro.data import make_clustered_corpus
from repro.runtime import LocalEngine as RefLocalEngine
from repro.service import AnnService as RefService
from repro.service import IndexSpec as RefIndexSpec
from repro.service import ServiceSpec as RefSpec

from repro_torch.convert import (generation_from_reference,
                                 index_from_numpy,
                                 mutable_index_from_reference)
from repro_torch.core import (SearchParams, build_ivfpq, exact_search,
                              pad_clusters, recall_at_k, search_ivfpq)
from repro_torch.core import sharded_search as ss
from repro_torch.core.mutable_index import Index
from repro_torch.runtime import (HotClusterLUTCache, LocalEngine,
                                 OnlineHeatEstimator)
from repro_torch.service import AnnService, IndexSpec, ServiceSpec
from repro_torch.service.router import CacheAwarePolicy

torch.set_num_threads(1)
NPROBE, K = 8, 10
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def churn_corpus():
    # the reference fixture: the first 4,000 points are the base index,
    # the tail is the insert pool
    return make_clustered_corpus(3, n=5000, d=16, n_queries=32,
                                 n_components=24, k_gt=K)


@pytest.fixture(scope="module")
def points(churn_corpus):
    return np.asarray(churn_corpus.points, np.float32)


@pytest.fixture(scope="module")
def queries(churn_corpus):
    return np.asarray(churn_corpus.queries, np.float32)


@pytest.fixture(scope="module")
def ref_ivf(points):
    return ref_build(jax.random.PRNGKey(0), points[:4000], nlist=32, m=8,
                     cb=64, kmeans_iters=4, pq_iters=4)


def _pair(ref_ivf, points, n=4000):
    """A fresh reference mutable handle and the port's copy of it."""
    ref = RefIndex(ref_ivf, points=points[:n], mutable=True)
    return ref, mutable_index_from_reference(ref, device="cpu")


def _assert_same_state(ref, port, tag=""):
    rs, ps = ref._store, port._store
    assert rs.cap == ps.cap, tag
    np.testing.assert_array_equal(np.asarray(rs.sizes), ps.sizes, tag)
    np.testing.assert_array_equal(rs.ids, ps.ids_h, tag)
    np.testing.assert_array_equal(rs.ids, ps.ids.numpy(), tag)
    np.testing.assert_array_equal(rs.codes, ps.codes.numpy(), tag)
    live = ref.live_ids()
    np.testing.assert_array_equal(live, port.live_ids(), tag)
    want = np.array([rs.loc[int(p)] for p in live], np.int32).reshape(-1, 2)
    np.testing.assert_array_equal(ps.loc.get_many(live), want, tag)
    assert ref.stats.as_dict() == port.stats.as_dict(), tag
    assert ref._touched == port._touched, tag
    assert ref.generation == port.generation and len(ref) == len(port)
    assert ref.size_band() == port.size_band()
    assert ref.maintenance_plan() == port.maintenance_plan()
    assert ref.maintenance_plan((20, 150)) == port.maintenance_plan(
        (20, 150))


def _assert_same_search(ref, port, queries, nprobe=NPROBE):
    rd, ri = ref.search(queries, nprobe=nprobe, k=K)
    pd_, pi = port.search(queries, nprobe=nprobe, k=K)
    np.testing.assert_allclose(pd_, rd, rtol=RTOL, atol=ATOL)
    for a, b in zip(np.asarray(ri), pi):
        assert set(a.tolist()) == set(b.tolist())


def _live_rows(port):
    st = port._store
    rows = np.arange(st.cap)[None, :] < st.sizes[:, None]
    return st.ids_h[rows], st.ids_h[~rows], st.codes.numpy()[~rows]


# ---------------------------------------------------------------------------
# Exact: the same operations on the same state give the same state
# ---------------------------------------------------------------------------

def test_mutations_match_reference_exactly(ref_ivf, points, queries):
    ref, port = _pair(ref_ivf, points)
    _assert_same_state(ref, port, "wrapped")
    rng = np.random.default_rng(0)
    for step in range(4):
        base = 4000 + 50 * step
        # new ids, re-upserts of live ids, and a repeated id in one call
        ids = np.concatenate([np.arange(base, base + 40),
                              rng.integers(0, 4000, 8), [base + 3, base]])
        vecs = points[4000 + rng.integers(0, 1000, len(ids))] + 0.01
        assert ref.upsert(ids, vecs) == port.upsert(ids, vecs)
        _assert_same_state(ref, port, f"upsert {step}")
        np.testing.assert_array_equal(ref.vector(base), port.vector(base))
        # live and absent ids, including one far past the dense locator
        dels = np.concatenate([rng.choice(ref.live_ids(), 50, replace=False),
                               [10 ** 6, 2 ** 31 - 1, base + 100]])
        assert ref.delete(dels) == port.delete(dels)
        _assert_same_state(ref, port, f"delete {step}")
    # a tight blob on one centroid grows the padded width (x1.5) ...
    blob = np.asarray(ref.centroids)[0] + rng.normal(
        0, 1e-3, (400, points.shape[1])).astype(np.float32)
    far = np.arange(2 ** 31 - 400, 2 ** 31)
    assert ref.upsert(far, blob) == port.upsert(far, blob)
    _assert_same_state(ref, port, "grown")
    assert 2 ** 31 - 1 in port and 2 ** 31 - 1 in port._store.loc.far
    _assert_same_search(ref, port, np.concatenate([queries, blob[:8]]))
    # ... and deleting past the threshold compacts it back
    dels = np.concatenate([far, rng.choice(np.arange(4000), 1600,
                                           replace=False)])
    assert ref.delete(dels) == port.delete(dels)
    _assert_same_state(ref, port, "compacted")
    assert port.stats.compactions == 1
    _assert_same_search(ref, port, queries)
    # the CSR view the sharded engine materializes from
    rc, pc = ref.to_ivfpq(), port.to_ivfpq()
    for a, b in ((rc.codes, pc.codes), (rc.ids, pc.ids),
                 (rc.offsets, pc.offsets)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_validation_matches_reference(ref_ivf, points):
    ref, port = _pair(ref_ivf, points)
    for h in (ref, port):
        with pytest.raises(ValueError):
            h.upsert([-1], points[:1])
        with pytest.raises(ValueError):
            h.upsert([2 ** 31], points[:1])
        with pytest.raises(ValueError):
            h.upsert([0, 1], points[:1])
        with pytest.raises(ValueError):
            h.size_band((5, 2))
        assert h.upsert([], np.zeros((0, 16), np.float32))["n"] == 0
    static = Index(index_from_numpy(
        ref_ivf.centroids, ref_ivf.codebook.codebooks,
        ref_ivf.codebook.sqnorms, ref_ivf.codes, ref_ivf.ids,
        ref_ivf.offsets, device="cpu"))
    assert not static.mutable and 17 in static and len(static) == 4000
    for call in (lambda: static.upsert([0], points[:1]),
                 lambda: static.delete([0]),
                 lambda: static.build_generation()):
        with pytest.raises(RuntimeError, match="mutable"):
            call()
    with pytest.raises(ValueError, match="raw points"):
        Index(static.ivf, mutable=True)
    # tenancy is ported (ROADMAP item 8): a scoped upsert needs a meta
    # table on the handle, as in the reference
    for h in (ref, port):
        with pytest.raises(ValueError, match="meta"):
            h.upsert([0], points[:1], tenant=0)


@pytest.mark.parametrize("band", [None, (40, 200)])
def test_install_generation_matches_reference(ref_ivf, points, queries,
                                              band):
    """The same built generation installs to the same store, with the
    same reconcile counts, after mutations that landed past its
    snapshot: new ids, re-upserted snapshot ids, deletes of both."""
    ref, _ = _pair(ref_ivf, points)
    ref.delete(np.arange(0, 4000, 7))
    gen = ref.build_generation(band, seed=3)           # snapshot here
    port = mutable_index_from_reference(ref, device="cpu")
    pgen = generation_from_reference(gen, device="cpu")
    late = np.arange(4000, 4024)
    for h in (ref, port):
        h.upsert(late, points[4000:4024] + 0.25)
        h.upsert([5, 6], points[10:12])
        h.delete(np.concatenate([np.arange(100, 130), late[:4]]))
    info = ref.install_generation(gen)
    assert port.install_generation(pgen) == info
    assert info["reconciled_upserts"] == 22 and info["reconciled_deletes"]
    if band is not None:
        assert info["splits"] and info["merges"]
    _assert_same_state(ref, port, "installed")
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids))
    _assert_same_search(ref, port, queries)


# ---------------------------------------------------------------------------
# Oracle: generations the port builds itself
# ---------------------------------------------------------------------------

def _oracle_recall(port, ids, queries):
    live = port.live_ids()
    vecs = torch.from_numpy(np.stack([port.vector(p) for p in live]))
    _, gt = exact_search(vecs, torch.from_numpy(queries), K)
    gt_ids = torch.from_numpy(live[gt.numpy()])
    return recall_at_k(torch.from_numpy(ids).long(), gt_ids)


def test_generation_keeps_live_ids_and_drops_dead(ref_ivf, points,
                                                  queries):
    ref, port = _pair(ref_ivf, points)
    dead = np.random.default_rng(1).choice(4000, size=800, replace=False)
    port.delete(dead)
    for nprobe in (1, 8, 32):
        assert not np.isin(port.search(queries, nprobe=nprobe, k=K)[1],
                           dead).any()
    out = port.run_maintenance(force=True)
    assert out["ran"] and out["retrained"] and port.generation == 1
    live, pad_ids, pad_codes = _live_rows(port)
    assert np.array_equal(np.sort(live), port.live_ids())   # once each
    assert (pad_ids == -1).all() and (pad_codes == 0).all()
    for nprobe in (1, 4, port.nlist):
        _, ids = port.search(queries, nprobe=nprobe, k=K)
        assert not np.isin(ids, dead).any()
    rec = _oracle_recall(port, port.search(queries, nprobe=NPROBE, k=K)[1],
                         queries)
    assert rec >= 0.7, rec


def test_splits_and_merges_follow_the_plan(ref_ivf, points, queries):
    """A blob makes one cluster oversized, an explicit band makes small
    ones undersized: the generation splits and merges exactly the
    planned clusters, and fewer clusters sit outside the band after."""
    _, port = _pair(ref_ivf, points)
    blob = port.centroids[0].numpy() + np.random.default_rng(2).normal(
        0, 1e-3, (600, points.shape[1])).astype(np.float32)
    port.upsert(np.arange(4000, 4600), blob)
    band = (60, 400)
    plan = port.maintenance_plan(band)
    assert plan["split"] and plan["merge"]
    out = port.run_maintenance(band)
    assert (out["splits"], out["merges"]) == (len(plan["split"]),
                                              len(plan["merge"]))
    assert port.nlist == 32 + out["splits"] - out["merges"]
    after = port.maintenance_plan(band)
    assert (len(after["split"]) + len(after["merge"])
            < len(plan["split"]) + len(plan["merge"]))
    _, ids = port.search(blob[:16], nprobe=NPROBE, k=K)
    assert np.mean([4000 + q in ids[q] for q in range(16)]) >= 0.5


def _churn(h, pool, queries, rng, maint_seed):
    """The reference's churn stream: Zipf-skewed deletes, fresh inserts,
    a forced maintenance cycle mid-stream; no dead id mid-churn."""
    next_id, live = 4000, set(range(4000))
    for step in range(8):
        take = rng.integers(0, pool.shape[0], 32)
        ids = np.arange(next_id, next_id + 32)
        h.upsert(ids, pool[take])
        live.update(ids.tolist())
        next_id += 32
        victims = np.asarray(sorted(live))
        w = 1.0 / (1.0 + np.arange(victims.shape[0]))
        kill = rng.choice(victims, size=16, replace=False, p=w / w.sum())
        h.delete(kill)
        live.difference_update(int(v) for v in kill)
        _, i_mid = h.search(queries[:8], nprobe=NPROBE, k=K)
        assert set(np.asarray(i_mid).reshape(-1).tolist()) <= live
        if step == 4:
            h.run_maintenance(force=True, seed=maint_seed)
    assert set(int(p) for p in h.live_ids()) == live
    return np.asarray(sorted(live))


def _overlap(found, gt_ids):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                          for a, b in zip(np.asarray(found), gt_ids)]))


def test_churn_recall_gap_no_worse_than_reference(ref_ivf, points, queries):
    ref, port = _pair(ref_ivf, points)
    pool = points[4000:]
    alive = _churn(ref, pool, queries, np.random.default_rng(0), 7)
    assert np.array_equal(_churn(port, pool, queries,
                                 np.random.default_rng(0), 7), alive)
    vecs = np.stack([ref.vector(int(p)) for p in alive])
    np.testing.assert_array_equal(
        vecs, np.stack([port.vector(int(p)) for p in alive]))
    d2 = ((queries ** 2).sum(1)[:, None] + (vecs ** 2).sum(1)[None, :]
          - 2.0 * queries @ vecs.T)
    gt_ids = alive[np.argsort(d2, axis=1)[:, :K]]
    rebuilt = ref_build(jax.random.PRNGKey(0), vecs, nlist=32, m=8, cb=64,
                        kmeans_iters=4, pq_iters=4)
    _, i_reb = ref_search(rebuilt, ref_pad(rebuilt), jnp.asarray(queries),
                          RefParams(nprobe=NPROBE, k=K))
    ref_gap = (_overlap(alive[np.asarray(i_reb)], gt_ids)
               - _overlap(ref.search(queries, nprobe=NPROBE, k=K)[1],
                          gt_ids))
    mine = build_ivfpq(torch.Generator().manual_seed(0),
                       torch.from_numpy(vecs), nlist=32, m=8, cb=64,
                       kmeans_iters=4, pq_iters=4, device="cpu")
    _, i_mine = search_ivfpq(mine, pad_clusters(mine),
                             torch.from_numpy(queries),
                             SearchParams(nprobe=NPROBE, k=K))
    port_gap = (_overlap(alive[i_mine.numpy()], gt_ids)
                - _overlap(port.search(queries, nprobe=NPROBE, k=K)[1],
                           gt_ids))
    assert port_gap <= ref_gap + 0.01, (port_gap, ref_gap)


def test_nlist_below_nprobe_raises_in_both(ref_ivf, points, queries):
    """Merges can leave fewer clusters than nprobe; a search probing more
    clusters than exist raises in both packages (``lax.top_k`` /
    ``torch.topk``), as ROADMAP §3 records."""
    ref = RefIndex.build(jax.random.PRNGKey(0), points[:2000], nlist=16,
                         m=8, cb=64, kmeans_iters=4, pq_iters=4,
                         mutable=True)
    port = mutable_index_from_reference(ref, device="cpu")
    dead = np.random.default_rng(1).choice(2000, size=400, replace=False)
    for h, seed in ((ref, 0), (port, 0)):
        h.delete(dead)
        h.run_maintenance(force=True, seed=seed)
    assert ref.nlist < 16 and port.nlist < 16
    for h in (ref, port):
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            h.search(queries, nprobe=16, k=K)
        h.search(queries, nprobe=h.nlist, k=K)


def test_concurrent_upserts_lose_nothing(ref_ivf, points):
    """Writers on more threads than cores, with a generation install in
    between: every upsert lands, counters add up, nothing is lost."""
    _, port = _pair(ref_ivf, points)
    n_threads, per = 8, 6
    errors = []

    def writer(t):
        try:
            for j in range(per):
                base = 10_000 + 100 * (t * per + j)
                port.upsert(np.arange(base, base + 4), points[:4] + t)
                port.delete([base + 3])
        except Exception as e:                 # noqa: BLE001 -- asserted
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        port.run_maintenance(force=True, retrain_pq=False)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    n = n_threads * per
    assert port.stats.upserts == 4 * n and port.stats.deletes == n
    assert len(port) == 4000 + 3 * n
    live, _, _ = _live_rows(port)
    assert np.array_equal(np.sort(live), port.live_ids())


# ---------------------------------------------------------------------------
# Engines: LocalEngine.install / view generation, the sharded swaps
# ---------------------------------------------------------------------------

def test_local_engine_install_and_view_generation(ref_ivf, points, queries):
    ref, port = _pair(ref_ivf, points)
    cache = HotClusterLUTCache(capacity=4096)
    eng = LocalEngine(port.search_view, port.clusters,
                      SearchParams(nprobe=NPROBE, k=K), lut_cache=cache)
    rng_eng = RefLocalEngine(ref.search_view, ref.clusters,
                             RefParams(nprobe=NPROBE, k=K))
    eng.search_batch(queries)
    assert eng.view_generation == rng_eng.view_generation == 0
    port.upsert(np.arange(4000, 4032), points[4000:4032])
    eng.install(clusters=port.clusters)             # data only
    rng_eng.install(clusters=ref.clusters)
    assert eng.view_generation == rng_eng.view_generation == 0
    hits0 = cache.stats.hits
    d, i = eng.search_batch(queries)                # cache still valid
    assert cache.stats.hits - hits0 == len(queries) * NPROBE
    dd, di = search_ivfpq(port.search_view, port.clusters,
                          torch.from_numpy(queries),
                          SearchParams(nprobe=NPROBE, k=K))
    np.testing.assert_array_equal(d, dd.numpy())
    np.testing.assert_array_equal(i, di.numpy())
    port.run_maintenance(force=True)
    eng.install(index=port.search_view, clusters=port.clusters)
    rng_eng.install(index=ref.search_view, clusters=ref.clusters)
    assert eng.view_generation == rng_eng.view_generation == 1
    hits0, entries = cache.stats.hits, len(cache)
    d, i = eng.search_batch(queries)      # old generation's entries: no hit
    assert cache.stats.hits == hits0 and len(cache) > entries
    dd, di = search_ivfpq(port.search_view, port.clusters,
                          torch.from_numpy(queries),
                          SearchParams(nprobe=NPROBE, k=K))
    np.testing.assert_array_equal(d, dd.numpy())
    np.testing.assert_array_equal(i, di.numpy())
    eng.index = port.search_view                    # the setter installs
    assert eng.view_generation == 2


def _cfg(module, **kw):
    return module.EngineConfig(n_shards=4, nprobe=NPROBE, k=K,
                               tasks_per_shard=512, strategy="gather",
                               dup_budget_bytes=1 << 14, **kw)


def _port_csr(ivf):
    return index_from_numpy(ivf.centroids, ivf.codebook.codebooks,
                            ivf.codebook.sqnorms, ivf.codes, ivf.ids,
                            ivf.offsets, device="cpu")


def test_sharded_generation_swaps_match_reference(ref_ivf, points, queries):
    """install_index / stage_index on a mutated and on a re-clustered
    index: the same layout as the reference's, the same results, and the
    per-generation invalidation (LUT cache cleared, heat estimator reset
    to the new cluster count, generations counted)."""
    ref, _ = _pair(ref_ivf, points)
    probes = np.asarray(ref_locate(jnp.asarray(queries), ref.centroids,
                                   NPROBE)[0])
    want = ref_ss.DistributedEngine(ref.to_ivfpq(), _cfg(ref_ss), probes)
    est = OnlineHeatEstimator(32)
    mine = ss.DistributedEngine(_port_csr(ref.to_ivfpq()), _cfg(ss), probes,
                                lut_cache=HotClusterLUTCache(capacity=512),
                                heat_estimator=est)
    mine.search(queries)
    ref.upsert(np.arange(4000, 4064), points[4000:4064])
    ref.delete(np.arange(0, 400, 3))
    ref.run_maintenance((60, 200), seed=1)
    new = ref.to_ivfpq()
    a = want.install_index(new)
    b = mine.install_index(_port_csr(new))
    assert a == b
    assert ([dataclasses.astuple(x) for x in mine.layout.instances]
            == [dataclasses.astuple(x) for x in want.layout.instances])
    assert mine.generations == want.generations == 1
    assert len(mine.lut_cache) == 0 and est.nlist == ref.nlist
    assert mine.latency.task_latency(100) == want.latency.task_latency(100)
    d0, i0, _ = want.search(queries)
    d1, i1, _ = mine.search(queries)
    np.testing.assert_allclose(d1, np.asarray(d0), rtol=RTOL, atol=ATOL)
    for x, y in zip(np.asarray(i0), i1):
        assert set(x.tolist()) == set(y.tolist())
    # staged: installed at the next batch start, not before
    ref.upsert(np.arange(5000, 5016), points[4100:4116])
    csr = _port_csr(ref.to_ivfpq())
    mine.stage_index(csr)
    assert mine.index is not csr and mine.generations == 1
    mine.search(queries[:4])
    assert mine.index is csr and mine.generations == 2


def test_router_scores_a_next_generation_cluster_cold():
    """The router's probe reads the handle's centroids, which a
    generation install swaps before ``invalidate_clusters`` resizes the
    policy: a cluster id past the estimators' count scores cold instead
    of raising."""
    policy = CacheAwarePolicy(nlist=4, n_replicas=2)
    policy.observe(0, np.array([1, 2]))
    assert policy.expected_hit_rate(0, np.array([1, 6])) == pytest.approx(
        0.5 * min(policy.estimators[0].heat_of(1), 1.0))
    assert policy.pick(None, np.array([5, 6]), [0, 0]) in (0, 1)
    policy.invalidate_clusters(8)
    assert policy.estimators[1].nlist == 8


# ---------------------------------------------------------------------------
# The service: AnnService(mutable=True), local and sharded
# ---------------------------------------------------------------------------

def _spec(engine="local", ref=False, **kw):
    """The reference tests' mutable spec, in either package."""
    spec, index_spec = ((RefSpec, RefIndexSpec) if ref
                        else (ServiceSpec, IndexSpec))
    return spec(index=index_spec(nlist=16, m=8, cb=32, kmeans_iters=4,
                                 pq_iters=4),
                engine=engine, nprobe=NPROBE, k=K, mutable=True,
                buckets=(1, 2, 4, 8), max_wait_s=1e-3, **kw)


@pytest.mark.parametrize("engine", ["local", "sharded"])
def test_mutable_service_matches_reference(points, engine):
    kw = dict(replicas=2) if engine == "local" else dict(replicas=1,
                                                         n_shards=4)
    pts = points[:2000]
    ref_svc = RefService.build(_spec(engine, ref=True, **kw), points=pts)
    port_h = mutable_index_from_reference(ref_svc.index, device="cpu")
    svc = AnnService.build(_spec(engine, **kw), index=port_h,
                           sample_queries=pts[:256], device="cpu")
    try:
        new_ids, probe = np.arange(2000, 2032), pts[:32] + 0.01
        for s in (ref_svc, svc):
            assert s.upsert(new_ids, probe)["inserted"] == 32
            assert s.delete(new_ids[:16]) == 16
        rd, ri = ref_svc.search(probe)
        d, i = svc.search(probe)
        np.testing.assert_allclose(d, np.asarray(rd), rtol=RTOL, atol=ATOL)
        for x, y in zip(np.asarray(ri), i):
            assert set(x.tolist()) == set(y.tolist())
        assert not np.isin(i, new_ids[:16]).any()
        assert np.mean([new_ids[16 + r] in i[16 + r]
                        for r in range(16)]) >= 0.9
        if engine == "local":
            hd, hi = port_h.search(probe, nprobe=NPROBE, k=K)
            np.testing.assert_array_equal(d, hd)
            np.testing.assert_array_equal(i, hi)
        out = svc.run_maintenance(force=True)
        assert out["ran"] and out["generation"] == 1
        d, i = svc.search(probe)
        assert not np.isin(i, new_ids[:16]).any()
        assert np.mean([new_ids[16 + r] in i[16 + r]
                        for r in range(16)]) >= 0.9
        st = svc.stats()["mutation"]
        assert (st["upserts"], st["deletes"], st["generation"],
                st["maintenance_runs"]) == (32, 16, 1, 1)
        assert st["n_live"] == len(port_h) == 2016
        if engine == "sharded":
            assert svc.core_engine().serving_info()["generations"] >= 1
    finally:
        svc.shutdown()
        ref_svc.shutdown()


def test_service_requires_mutable_flag(points):
    svc = AnnService.build(ServiceSpec(
        index=IndexSpec(nlist=8, m=8, cb=32, kmeans_iters=3, pq_iters=3),
        engine="local", replicas=1, nprobe=4, k=5), points=points[:1000],
        device="cpu")
    try:
        for call in (lambda: svc.upsert([1000], points[:1]),
                     lambda: svc.delete([0]),
                     lambda: svc.run_maintenance()):
            with pytest.raises(RuntimeError, match="mutable"):
                call()
        with pytest.raises(ValueError, match="mutable"):
            AnnService.build(_spec(), index=svc.index)
    finally:
        svc.shutdown()


def test_maintenance_swap_preserves_inflight_futures(points, queries):
    svc = AnnService.build(_spec(replicas=2), points=points[:2000],
                           device="cpu")
    try:
        svc.warmup()
        futs = [svc.submit_async(queries[q % len(queries)])
                for q in range(24)]
        out = svc.run_maintenance(force=True, wait=False)
        assert out["ran"] and out["async"]
        more = [svc.submit_async(queries[q]) for q in range(8)]
        svc.mutator.close()
        live = set(int(p) for p in svc.index.live_ids())
        for f in futs + more:
            d, i = f.result(timeout=30.0)
            assert i.shape == (K,) and np.isfinite(d).all()
            assert set(int(p) for p in i) <= live
        assert svc.stats()["mutation"]["generation"] == 1
        assert all(rep.core.view_generation == 1 for rep in svc.replicas)
    finally:
        svc.shutdown()


def test_maintenance_error_surfaces_on_next_call(points):
    svc = AnnService.build(_spec(replicas=1), points=points[:2000],
                           device="cpu")
    try:
        def boom(*a, **kw):
            raise ValueError("boom")
        svc.index.build_generation = boom
        assert svc.run_maintenance(force=True, wait=False)["ran"]
        svc.mutator.close()
        assert "boom" in svc.stats()["mutation"]["error"]
        with pytest.raises(RuntimeError, match="maintenance failed"):
            svc.upsert([5000], points[:1])
        svc.upsert([5000], points[:1])          # the error is cleared
    finally:
        svc.shutdown()


def test_scale_out_builds_from_the_current_generation(points, queries):
    svc = AnnService.build(_spec(replicas=1, replicas_max=2),
                           points=points[:2000], device="cpu")
    try:
        svc.upsert(np.arange(2000, 2016), points[:16] + 0.01)
        svc.run_maintenance(force=True)
        svc.delete(np.arange(0, 50))
        svc.scale_to(2)
        a = svc.replicas[0].engine.search_batch(queries)
        b = svc.replicas[1].engine.search_batch(queries)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert svc.replicas[1].core.index is svc.index.search_view
        assert not np.isin(b[1], np.arange(0, 50)).any()
    finally:
        svc.shutdown()
