"""Port parity for the main path: ``search_ivfpq`` on a reference-built
index carried across through numpy, and the serving runtime over it.

f32: distances allclose (rtol 1e-4 / atol 1e-3, float sums in another
order) and neighbour ids equal as per-query sets, apart from distance
ties at the k-th place.  uint8: held to recall, never to distances.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import SearchParams as RefParams
from repro.core import recall_at_k as ref_recall
from repro.core import search_ivfpq as ref_search
from repro.runtime import LocalEngine as RefEngine
from repro.runtime import ServingConfig as RefConfig
from repro.runtime import ServingRuntime as RefRuntime

from repro_torch.convert import clusters_from_numpy, index_from_numpy
from repro_torch.core import SearchParams, recall_at_k, search_ivfpq
from repro_torch.data import make_query_stream
from repro_torch.kernels import ops
from repro_torch.runtime import (BatchServeError, HotClusterLUTCache,
                                 LocalEngine, ServingConfig, ServingRuntime)

torch.set_num_threads(1)
K = 10


@pytest.fixture(scope="module")
def port(small_index, small_clusters):
    idx = index_from_numpy(small_index.centroids,
                           small_index.codebook.codebooks,
                           small_index.codebook.sqnorms, small_index.codes,
                           small_index.ids, small_index.offsets,
                           device="cpu")
    cl = clusters_from_numpy(small_clusters.codes, small_clusters.ids,
                             small_clusters.sizes, device="cpu")
    return idx, cl


def assert_same_neighbours(pd, pi, rd, ri, k=K, rtol=1e-4, atol=1e-3):
    """Port (pd, pi) with k columns against reference (rd, ri) with k+1:
    id sets equal per query, except where the reference's k-th and
    (k+1)-th distances tie; there only ids strictly closer than the tie
    must agree."""
    for q in range(pi.shape[0]):
        got, want = set(pi[q].tolist()), set(ri[q, :k].tolist())
        if got == want:
            continue
        kth, nxt = rd[q, k - 1], rd[q, k]
        assert np.isclose(kth, nxt, rtol=rtol, atol=atol), (q, got, want)
        sure = {i for i, d in zip(ri[q, :k], rd[q, :k])
                if d < kth - (atol + rtol * abs(kth))}
        assert sure <= got, (q, sure - got)


@pytest.mark.parametrize("nprobe", [1, 8, 32])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_search_f32_matches_reference(port, small_index, small_clusters,
                                      small_corpus, nprobe, use_kernels):
    idx, cl = port
    queries = np.array(small_corpus.queries)
    rd, ri = ref_search(small_index, small_clusters, small_corpus.queries,
                        RefParams(nprobe=nprobe, k=K + 1, query_chunk=32))
    rd, ri = np.asarray(rd), np.asarray(ri)
    pd, pi = search_ivfpq(idx, cl, torch.from_numpy(queries),
                          SearchParams(nprobe=nprobe, k=K, query_chunk=24,
                                       use_kernels=use_kernels))
    assert pd.shape == (queries.shape[0], K) and pi.dtype == torch.int32
    np.testing.assert_allclose(pd.numpy(), rd[:, :K], rtol=1e-4, atol=1e-3)
    assert_same_neighbours(pd.numpy(), pi.numpy(), rd, ri)
    # padding is (+inf, -1) on every path
    pad = np.isinf(pd.numpy())
    assert (pi.numpy()[pad] == -1).all()


@pytest.mark.parametrize("nprobe", [1, 8, 32])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_search_uint8_recall_matches_reference(port, small_index,
                                               small_clusters, small_corpus,
                                               nprobe, use_kernels):
    idx, cl = port
    gt = small_corpus.groundtruth
    _, ri = ref_search(small_index, small_clusters, small_corpus.queries,
                       RefParams(nprobe=nprobe, k=K, query_chunk=32,
                                 lut_dtype="uint8"))
    ref_r = float(ref_recall(ri, gt))
    _, pi = search_ivfpq(idx, cl, torch.from_numpy(np.array(
        small_corpus.queries)), SearchParams(nprobe=nprobe, k=K,
                                             use_kernels=use_kernels,
                                             lut_dtype="uint8"))
    port_r = recall_at_k(pi, torch.from_numpy(np.array(gt)))
    assert port_r >= ref_r - 0.01, (port_r, ref_r)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_short_probes_pad_with_inf_and_minus_one(use_kernels, lut_dtype):
    """A query whose probes hold fewer than k valid rows (one cluster is
    empty) gets (+inf, -1) in the tail, as in the reference."""
    import jax.numpy as jnp
    from repro.core import IVFPQIndex, PQCodebook, pad_clusters
    rng = np.random.default_rng(9)
    cents = (np.arange(4)[:, None] * 50.0 + np.zeros((4, 8))
             ).astype(np.float32)
    books = rng.normal(size=(2, 4, 4)).astype(np.float32)
    sizes = np.array([1, 2, 3, 0])
    codes = rng.integers(0, 4, (6, 2)).astype(np.uint8)
    ids = np.arange(6, dtype=np.int32)[::-1].copy()
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    ref_idx = IVFPQIndex(jnp.asarray(cents), PQCodebook(
        jnp.asarray(books), jnp.asarray((books ** 2).sum(-1))),
        jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(offsets))
    ref_cl = pad_clusters(ref_idx)
    qs = (cents[[0, 1, 2, 3]] + 1.0).astype(np.float32)
    rd, ri = ref_search(ref_idx, ref_cl, jnp.asarray(qs),
                        RefParams(nprobe=2, k=5, lut_dtype=lut_dtype))
    idx = index_from_numpy(cents, books, (books ** 2).sum(-1), codes, ids,
                           offsets, device="cpu")
    cl = clusters_from_numpy(ref_cl.codes, ref_cl.ids, ref_cl.sizes,
                             device="cpu")
    pd, pi = search_ivfpq(idx, cl, torch.from_numpy(qs), SearchParams(
        nprobe=2, k=5, use_kernels=use_kernels, lut_dtype=lut_dtype))
    rd, ri = np.asarray(rd), np.asarray(ri)
    np.testing.assert_array_equal(np.isinf(pd.numpy()), np.isinf(rd))
    np.testing.assert_array_equal(pi.numpy()[np.isinf(rd)], -1)
    assert np.isinf(rd).any()
    for q in range(4):
        assert set(pi[q].tolist()) == set(ri[q].tolist())


def test_search_rejects_unknown_lut_dtype(port, small_corpus):
    idx, cl = port
    with pytest.raises(ValueError):
        search_ivfpq(idx, cl, torch.zeros(2, idx.dim),
                     SearchParams(nprobe=2, k=3, lut_dtype="bf16"))


def _trace(small_corpus, n=120):
    return make_query_stream(np.array(small_corpus.queries), n, qps=2000.0,
                             seed=5)


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_served_results_equal_direct_search(port, small_corpus, lut_dtype):
    """De-padded served rows equal a direct search on the same queries."""
    idx, cl = port
    params = SearchParams(nprobe=8, k=K, use_kernels=True,
                          lut_dtype=lut_dtype)
    rt = ServingRuntime(LocalEngine(idx, cl, params),
                        ServingConfig(buckets=(1, 2, 4, 8, 16, 32)))
    rt.warmup(idx.dim)
    reqs = rt.run_stream(_trace(small_corpus))
    assert all(r.done for r in reqs)
    qs = torch.from_numpy(np.stack([r.query for r in reqs]))
    dd, di = search_ivfpq(idx, cl, qs, params)
    for r, d, i in zip(reqs, dd.numpy(), di.numpy()):
        assert set(r.ids.tolist()) == set(i.tolist())
        np.testing.assert_allclose(r.dists, d, rtol=1e-5, atol=1e-4)
    m = rt.metrics()
    assert m["requests"] == len(reqs) and m["engine"]["engine"] == "local"
    assert 0 < m["avg_batch_occupancy"] <= 1
    assert m["p99_ms"] >= m["p50_ms"] > 0


def test_served_results_match_reference_runtime(port, small_index,
                                                small_clusters,
                                                small_corpus):
    """The port's runtime and the reference's, fed one trace, serve the
    same neighbour sets."""
    idx, cl = port
    trace = _trace(small_corpus, 80)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref_rt = RefRuntime(RefEngine(small_index, small_clusters,
                                      RefParams(nprobe=8, k=K + 1)),
                            RefConfig())
    ref_reqs = ref_rt.run_stream(trace)
    rt = ServingRuntime(LocalEngine(idx, cl, SearchParams(nprobe=8, k=K)))
    reqs = rt.run_stream(trace)
    assert len(reqs) == len(ref_reqs)
    assert_same_neighbours(np.stack([r.dists for r in reqs]),
                           np.stack([r.ids for r in reqs]),
                           np.stack([r.dists for r in ref_reqs]),
                           np.stack([r.ids for r in ref_reqs]))


def test_online_submit_step_and_errors(port, small_corpus):
    idx, cl = port
    rt = ServingRuntime(LocalEngine(idx, cl, SearchParams(nprobe=4, k=K)),
                        ServingConfig(buckets=(1, 4), max_wait_s=1e-3))
    qs = np.array(small_corpus.queries[:3])
    for j, q in enumerate(qs):
        rt.submit(q, now=j * 1e-4)
    assert rt.step(now=0.0) == []                # nothing due yet
    done = rt.step(now=1.0)
    assert [r.req_id for r in done] == [0, 1, 2] and done[0].bucket == 4
    assert set(done[0].timing()) == {"queue_s", "batch_s", "engine_s",
                                     "total_s", "degraded",
                                     "deadline_missed"}
    bad = ServingRuntime(LocalEngine(idx, cl, SearchParams(nprobe=4, k=10**6)))
    bad.submit(qs[0], now=0.0)
    with pytest.raises(BatchServeError):
        bad.step(now=1.0, drain=True)


def test_batcher_flush_policy():
    from repro_torch.runtime import BucketPolicy, MicroBatcher
    pol = BucketPolicy([8, 1, 4, 2])
    assert pol.buckets == (1, 2, 4, 8) and pol.bucket_for(3) == 4
    assert pol.bucket_for(99) == 8
    with pytest.raises(ValueError):
        BucketPolicy([0, 4])
    b = MicroBatcher(pol, max_wait_s=0.01, max_batch=4)
    for j in range(5):
        b.submit(np.full(3, j, np.float32), now=0.001 * j)
    full = b.poll(0.004)
    assert full.reason == "full" and full.n_valid == 4 and full.bucket == 4
    assert b.poll(0.005) is None and b.next_deadline() == pytest.approx(0.014)
    late = b.poll(0.02)
    assert late.reason == "deadline" and late.bucket == 1
    assert late.queries[0, 0] == 4 and b.depth == 0
    b.submit(np.zeros(3, np.float32), now=1.0)
    drained = b.poll(1.0, drain=True)
    assert drained.reason == "drain" and drained.n_valid == 1


def test_unported_engine_options_raise(port):
    idx, cl = port
    p = SearchParams(nprobe=2, k=3)
    # tiered storage and the two-level CL are ported (ROADMAP item 7):
    # only a tier may stand in for the clusters
    with pytest.raises(ValueError, match="tiered_store"):
        LocalEngine(idx, None, p)
    # the LUT cache is ported; its dtype must match the scan's
    with pytest.raises(ValueError, match="lut_dtype"):
        LocalEngine(idx, cl, p, lut_cache=HotClusterLUTCache(
            capacity=8, lut_dtype="uint8"))
    # tenancy is ported (ROADMAP item 8): scoped search needs an engine
    # built with per-vector metadata, as in the reference
    eng = LocalEngine(idx, cl, p)
    with pytest.raises(ValueError, match="meta=None"):
        eng.search_batch(np.zeros((1, idx.dim), np.float32),
                         tenants=np.zeros(1, np.int32))


def test_cpu_search_with_kernels_counts_no_launches(port, small_corpus):
    idx, cl = port
    ops.reset_launches()
    search_ivfpq(idx, cl, torch.from_numpy(np.array(small_corpus.queries)),
                 SearchParams(nprobe=4, k=K, use_kernels=True))
    assert all(v == 0 for v in ops.launches.values())
