"""Port parity for the two-level coarse quantizer (``core/coarse2.py``).

A reference-built ``Coarse2`` (``jax.random`` k-means) is carried across
by ``convert.coarse2_from_numpy``, so both packages route with the same
grouping: the same queries must give the same probe sets.  The port's
own build is held to the contract (members partition the clusters, full
fan-out equals flat CL) and served through ``LocalEngine`` and
``AnnService(coarse_groups=...)``.  Everything runs on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster_locate as ref_locate
from repro.core.coarse2 import build_coarse2 as ref_build
from repro.core.coarse2 import coarse2_locate as ref_coarse2_locate
from repro.core.coarse2 import routing_rows_touched as ref_rows

from repro_torch.convert import coarse2_from_numpy, index_from_numpy
from repro_torch.core import SearchParams, pad_clusters, search_ivfpq
from repro_torch.core.coarse2 import (build_coarse2, coarse2_locate,
                                      routing_rows_touched)
from repro_torch.core.search import cluster_locate
from repro_torch.runtime import LocalEngine
from repro_torch.service import AnnService, ServiceSpec
from repro_torch.storage import TieredStore

torch.set_num_threads(1)
K = 10

pytestmark = pytest.mark.filterwarnings(
    r"ignore:Direct \w+\(\.\.\.\) construction:DeprecationWarning")


@pytest.fixture(scope="module")
def port_index(small_index):
    return index_from_numpy(small_index.centroids,
                            small_index.codebook.codebooks,
                            small_index.codebook.sqnorms, small_index.codes,
                            small_index.ids, small_index.offsets,
                            device="cpu")


@pytest.fixture(scope="module")
def queries(small_corpus):
    return np.array(small_corpus.queries, np.float32)


@pytest.fixture(scope="module")
def ref_coarse(small_index):
    return ref_build(jax.random.PRNGKey(0), small_index.centroids,
                     n_groups=8)


def _sets(probes):
    return [set(r.tolist()) for r in np.asarray(probes)]


@pytest.mark.parametrize("nprobe1", [1, 2, 5, 8])
def test_locate_matches_reference_on_its_grouping(ref_coarse, queries,
                                                  nprobe1):
    port = coarse2_from_numpy(*(np.asarray(a) for a in ref_coarse),
                              device="cpu")
    want, wd = ref_coarse2_locate(ref_coarse, jnp.asarray(queries),
                                  nprobe=8, nprobe1=nprobe1)
    got, gd = coarse2_locate(port, torch.from_numpy(queries), nprobe=8,
                             nprobe1=nprobe1)
    assert _sets(got) == _sets(want)
    # the expansion ||q||^2 - 2 q.c + ||c||^2 cancels terms near 7e5 here
    # (uint8-range queries, D=32): f32 rounding of those is ~0.1 absolute,
    # so the two packages' summation orders agree to ~1e-4 relative
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-3)


@pytest.mark.parametrize("nprobe", [1, 8, 16])
def test_full_fanout_equals_flat_locate(port_index, queries, nprobe):
    coarse = build_coarse2(torch.Generator().manual_seed(0),
                           port_index.centroids, n_groups=6)
    flat, _ = cluster_locate(torch.from_numpy(queries),
                             port_index.centroids, nprobe)
    two, _ = coarse2_locate(coarse, torch.from_numpy(queries),
                            nprobe=nprobe, nprobe1=coarse.n_groups)
    assert _sets(two) == _sets(flat)


@pytest.mark.parametrize("n_groups", [1, 8, 64])
def test_members_partition_clusters(port_index, n_groups):
    coarse = build_coarse2(torch.Generator().manual_seed(1),
                           port_index.centroids, n_groups=n_groups)
    members = coarse.members.numpy()
    live = members[members >= 0]
    assert sorted(live.tolist()) == list(range(port_index.nlist))
    for row in members:                       # ascending ids, pad last
        ids = row[row >= 0]
        assert (np.diff(ids) > 0).all() and (row[len(ids):] == -1).all()
    cents = port_index.centroids.numpy()
    mc = coarse.member_centroids.numpy()
    np.testing.assert_array_equal(mc[members >= 0], cents[live])
    assert (mc[members < 0] == 0).all()


def test_build_defaults_and_validation(port_index):
    gen = torch.Generator().manual_seed(0)
    nlist = port_index.nlist
    coarse = build_coarse2(gen, port_index.centroids)
    assert coarse.n_groups == math.ceil(math.sqrt(nlist))
    assert build_coarse2(gen, port_index.centroids,
                         n_groups=10 * nlist).n_groups == nlist
    with pytest.raises(ValueError, match="n_groups"):
        build_coarse2(gen, port_index.centroids, n_groups=-3)
    ref = ref_build(jax.random.PRNGKey(0), np.asarray(port_index.centroids))
    assert ref.n_groups == coarse.n_groups


@pytest.mark.parametrize("args", [(4096, 64, 80, 4), (16384, 128, 400, 8),
                                  (100, 1, 100, 1)])
def test_routing_rows_touched_matches_reference(args):
    assert routing_rows_touched(*args) == ref_rows(*args)


def test_probes_do_not_depend_on_the_batch(ref_coarse, queries,
                                           monkeypatch):
    """Blocks are zero-padded to one row count, so a query's probes are
    the same alone or in a batch, and when the byte budget splits the
    batch into several blocks."""
    port = coarse2_from_numpy(*(np.asarray(a) for a in ref_coarse),
                              device="cpu")
    q = torch.from_numpy(queries)
    full, _ = coarse2_locate(port, q, nprobe=8, nprobe1=3, block=16)
    for s in (0, 5, 17, 63):
        one, _ = coarse2_locate(port, q[s:s + 1], nprobe=8, nprobe1=3,
                                block=16)
        assert torch.equal(one[0], full[s])
    import repro_torch.core.coarse2 as mod
    monkeypatch.setattr(mod, "BLOCK_BYTES", 3 * 32 * port.gmax * 4)
    small, _ = coarse2_locate(port, q, nprobe=8, nprobe1=3, block=16)
    assert _sets(small) == _sets(full)


def test_engine_with_coarse_equals_flat_at_full_fanout(port_index, queries,
                                                       tmp_path):
    p = SearchParams(nprobe=8, k=K, use_kernels=True)
    cl = pad_clusters(port_index)
    fd, fi = (x.numpy() for x in search_ivfpq(
        port_index, cl, torch.from_numpy(queries), p))
    coarse = build_coarse2(torch.Generator().manual_seed(0),
                           port_index.centroids, n_groups=6)
    eng = LocalEngine(port_index, cl, p, coarse=coarse)
    assert eng.coarse_nprobe1 == 6
    d, i = eng.search_batch(queries)
    assert _sets(i) == _sets(fi)
    np.testing.assert_allclose(d, fd, rtol=1e-5, atol=1e-4)
    # two-level CL over a tier: the same rows
    tier = TieredStore.from_index(port_index, tmp_path, budget_bytes=1 << 14,
                                  device="cpu")
    teng = LocalEngine(port_index, None, p, tiered_store=tier, coarse=coarse)
    td, ti = teng.search_batch(queries)
    np.testing.assert_array_equal(td, d)
    np.testing.assert_array_equal(ti, i)
    info = teng.serving_info()
    assert info["coarse"] == {"n_groups": 6, "nprobe1": 6} and "tier" in info


def test_service_coarse_groups(port_index, queries):
    """``coarse_groups`` on the local engine: one Coarse2 per handle shared
    by the replicas; full fan-out serves flat CL's neighbours, a narrow
    fan-out still serves k results per query."""
    kw = dict(engine="local", nprobe=8, k=K, buckets=(1, 2, 4),
              max_wait_s=1e-3)
    flat = AnnService.build(ServiceSpec(**kw), index=port_index)
    fd, fi = flat.search(queries)
    flat.shutdown()
    svc = AnnService.build(ServiceSpec(coarse_groups=6, replicas=2, **kw),
                           index=port_index)
    cores = [svc.core_engine(r) for r in range(2)]
    assert cores[0].coarse is cores[1].coarse is svc.index._coarse2_cache
    d, i = svc.search(queries)
    assert _sets(i) == _sets(fi)
    reqs = svc.stream([(j * 5e-4, queries[j % 8]) for j in range(16)])
    for j, r in enumerate(reqs):
        np.testing.assert_array_equal(r.ids, i[j % 8])
    assert svc.stats()["replicas"][0]["engine"]["coarse"]["n_groups"] == 6
    svc.shutdown()
    narrow = AnnService.build(ServiceSpec(coarse_groups=6, coarse_nprobe1=2,
                                          **kw), index=port_index)
    _, ni = narrow.search(queries)
    assert ni.shape == (len(queries), K) and (ni >= 0).all()
    recall = np.mean([len(a & b) / K for a, b in zip(_sets(ni), _sets(fi))])
    assert recall >= 0.5
    narrow.shutdown()


def test_reference_probe_sets_at_full_fanout(small_index, ref_coarse,
                                             queries):
    """The reference's own anchor, through the port: its grouping at full
    fan-out gives flat CL's probe sets."""
    port = coarse2_from_numpy(*(np.asarray(a) for a in ref_coarse),
                              device="cpu")
    flat, _ = ref_locate(jnp.asarray(queries), small_index.centroids, 8)
    two, _ = coarse2_locate(port, torch.from_numpy(queries), nprobe=8,
                            nprobe1=port.n_groups)
    assert _sets(two) == _sets(flat)
