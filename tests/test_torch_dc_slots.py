"""DC by slot on the main path: ``core.search.dc_ts`` reads each probed
cluster where it lies in the ``PaddedClusters`` (the DC kernels' slot
form; the plain version from a copy) and TS looks its winners' ids up,
so no copy of the padded codes and ids is made on the unscoped path.

The oracle is the gather it replaced, built here: the probed clusters'
codes, ids and sizes copied with ``index_select`` and scanned by
``dc_ts_tasks``.  ``dc_ts`` must equal it bit for bit, ties and padding
included, with and without a scope mask; so must ``LocalEngine``'s plain,
cached and scoped answers, chunk by chunk.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import SearchParams
from repro_torch.core.filter import NO_TAG, Scope
from repro_torch.core.search import (cl_rc, cluster_locate,
                                     cluster_locate_masked, dc_ts,
                                     dc_ts_tasks, lc, rc_from_probes)
from repro_torch.data.vectors import make_clustered_corpus
from repro_torch.service import AnnService, ServiceSpec

torch.set_num_threads(1)
N_QUERIES = 600                   # three chunks of 256, the last partial
NPROBE, K = 4, 5
N_TENANTS, TAG_MOD = 3, 5


@pytest.fixture(scope="module")
def corpus():
    c = make_clustered_corpus(3, 4000, 16, n_queries=N_QUERIES,
                              device="cpu")
    return np.asarray(c.points, np.float32), np.asarray(c.queries,
                                                        np.float32)


def _meta_arrays(n):
    tenants = (np.arange(n) % N_TENANTS).astype(np.int32)
    tags = (np.arange(n) % TAG_MOD).astype(np.uint32)[:, None]
    return tenants, tags


def _spec(lut_dtype="f32", **kw):
    return ServiceSpec.from_dict({"index": {"nlist": 32, "m": 4, "cb": 16},
                                  "nprobe": NPROBE, "k": K,
                                  "lut_dtype": lut_dtype, "engine": "local",
                                  **kw})


@pytest.fixture(scope="module")
def index(corpus):
    svc = AnnService.build(_spec(), points=torch.from_numpy(corpus[0]),
                           device="cpu")
    idx = svc.replicas[0].engine.index
    svc.shutdown()
    return idx


@pytest.fixture(scope="module")
def scoped(index, corpus):
    """A service whose engine holds the corpus's tenants and tags; its
    engine's clusters, meta and per-query scope."""
    tenants, tags = _meta_arrays(len(corpus[0]))
    svc = AnnService.build(_spec(), index=index,
                           tenants=tenants, tags=tags, device="cpu")
    eng = svc.replicas[0].engine
    q_tenants = (np.arange(N_QUERIES) % (N_TENANTS + 1) - 1).astype(np.int32)
    q_terms = np.full((N_QUERIES, 1), NO_TAG, np.uint32)
    q_terms[::3, 0] = np.arange(0, N_QUERIES, 3) % TAG_MOD
    yield eng, q_tenants, q_terms
    svc.shutdown()


def _gathered(clusters, probes):
    """The copy ``dc_ts`` no longer makes: the probed clusters' codes,
    ids and sizes, one task per (query, probe)."""
    flat = probes.reshape(-1)
    return (clusters.codes.index_select(0, flat),
            clusters.ids.index_select(0, flat),
            clusters.sizes.index_select(0, flat))


def _oracle(engine, queries, tenants=None, terms=None):
    """The engine's pipeline chunk by chunk, with DC + TS on the gathered
    copy: CL on the fixed block (masked by the scope), RC, LC, the copy,
    ``dc_ts_tasks``."""
    p = engine.params
    index, clusters = engine.index, engine.clusters
    scope = Scope.make(engine.meta, tenants, terms, len(queries), "cpu")
    q_all = torch.from_numpy(queries)
    dd, ii = [], []
    for s in range(0, len(queries), p.query_chunk):
        q = q_all[s:s + p.query_chunk]
        rows = slice(s, s + len(q))
        if scope is None:
            probes = cluster_locate(q, index.centroids, p.nprobe,
                                    block=p.query_chunk)[0]
            mask = None
        else:
            probes = cluster_locate_masked(
                q, index.centroids, p.nprobe,
                scope.allowed(rows, index.centroids.shape[0]),
                block=p.query_chunk)[0]
            mask = scope.masker(rows)
        lut = lc(rc_from_probes(q, index.centroids, index.rotation, probes),
                 index.codebook, p)
        d, i = dc_ts_tasks(lut, *_gathered(clusters, probes), len(q), p,
                           mask)
        dd.append(d.numpy())
        ii.append(i.numpy())
    return np.concatenate(dd), np.concatenate(ii)


def _assert_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
@pytest.mark.parametrize("scope", [False, True])
@pytest.mark.parametrize("k", [K, NPROBE * 64])
def test_dc_ts_equals_dc_ts_tasks_on_the_gathered_copy(
        index, corpus, scoped, use_kernels, lut_dtype, scope, k):
    """One chunk, bit for bit, ties and padding included: k = 5, and k
    past every probe's valid rows, so padding rows (+inf, -1) win.  DC
    counts the same rows either way."""
    engine, q_tenants, q_terms = scoped
    clusters = engine.clusters
    k = min(k, NPROBE * clusters.cmax)
    p = SearchParams(nprobe=NPROBE, k=k, use_kernels=use_kernels,
                     lut_dtype=lut_dtype)
    q = torch.from_numpy(corpus[1][:256])
    probes, flat_res = cl_rc(q, index.centroids, index.rotation, p)
    lut = lc(flat_res, index.codebook, p)
    mask = None
    if scope:
        mask = Scope.make(engine.meta, q_tenants, q_terms, N_QUERIES,
                          "cpu").masker(slice(0, len(q)))
    obs.reset()
    got = dc_ts(lut, probes, clusters, p, mask)
    rows = obs.counts["dc.rows_scanned"]
    want = dc_ts_tasks(lut, *_gathered(clusters, probes), len(q), p, mask)
    assert rows == obs.counts["dc.rows_scanned"] - rows
    assert rows == probes.numel() * clusters.cmax
    _assert_equal(got, want)
    assert got[1].dtype == torch.int32
    if k > K:
        assert bool(torch.isinf(got[0]).any())
        assert bool((got[1][torch.isinf(got[0])] == -1).all())


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
@pytest.mark.parametrize("path", ["plain", "cached"])
def test_local_engine_unscoped_answers_equal_the_gathered_oracle(
        index, corpus, lut_dtype, path):
    kw = {"cache_capacity": 4096} if path == "cached" else {}
    svc = AnnService.build(_spec(lut_dtype, **kw), index=index, device="cpu")
    try:
        engine = svc.replicas[0].engine
        assert (engine.lut_cache is not None) == (path == "cached")
        want = _oracle(engine, corpus[1])
        _assert_equal(engine.search_batch(corpus[1]), want)
        if path == "cached":              # the second pass hits the cache
            _assert_equal(engine.search_batch(corpus[1]), want)
    finally:
        svc.shutdown()


def test_local_engine_scoped_answers_equal_the_gathered_oracle(scoped,
                                                               corpus):
    engine, q_tenants, q_terms = scoped
    want = _oracle(engine, corpus[1], q_tenants, q_terms)
    got = engine.search_batch(corpus[1], tenants=q_tenants, terms=q_terms)
    _assert_equal(got, want)
