"""Port parity for multi-tenant serving: ``core.filter`` (``VectorMeta``,
the scope mask, ``pad_terms``, ``tenant_subindex``), ``service.tenancy``
(token buckets, the registry, weighted fair queueing), and scoped search
on the local, sharded and tiered engines and on a live index, held to the
reference package on one reference-built index carried across by
``convert.py``, and to the port's own isolation and brute-force
post-filter oracles.

Everything here runs on the CPU, where ``kernels.ops`` runs the kernels'
plain versions.  Tolerances:

  * the metadata tables, the bitmap, ``allowed_for``, the scope mask,
    ``tenant_subindex``'s arrays and the QoS decisions: exactly equal;
  * scoped results against the reference's: f32 distances at rtol 1e-4 /
    atol 1e-3 (the (inf, -1) tail at the same places), ids as sets up to
    ties at the k-th distance; uint8 by recall against the scoped brute
    force, within 0.01 of the reference's;
  * the isolation oracle (scoped == ``search_ivfpq`` over the port's
    ``tenant_subindex``): ids equal, distances at rtol 1e-5 / atol 1e-5,
    the reference's own rule (tests/test_tenancy.py);
  * the brute-force post-filter oracle: distances at rtol 1e-5 / atol
    1e-5, ids as sets up to ties at the k-th distance (``torch.topk``
    breaks ties in another order than ``lax.top_k``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Index as RefIndex
from repro.core import SearchParams as RefParams
from repro.core import filter as ref_filter
from repro.runtime import LocalEngine as RefLocalEngine
from repro.service import AnnService as RefService
from repro.service import ServiceSpec as RefSpec
from repro.service import tenancy as ref_tenancy

from repro_torch.convert import (generation_from_reference, index_from_numpy,
                                 mutable_index_from_reference,
                                 vector_meta_from_reference)
from repro_torch.core import SearchParams, pad_clusters, search_ivfpq
from repro_torch.core import filter as flt
from repro_torch.core.search import cluster_locate, cluster_locate_masked
from repro_torch.runtime import LocalEngine
from repro_torch.service import AnnService, IndexSpec, ServiceSpec
from repro_torch.service import __main__ as cli
from repro_torch.service import tenancy

torch.set_num_threads(1)
K = 10
N_TENANTS, TAG_MOD = 3, 5
RTOL, ATOL = 1e-4, 1e-3          # port vs reference, f32
ORACLE_TOL = 1e-5                # the isolation / post-filter oracles


def _meta_arrays(n):
    """Tenants striped over N_TENANTS; one tag column cycling mod TAG_MOD
    (every tenant holds every tag value) -- the reference test's."""
    tenants = (np.arange(n) % N_TENANTS).astype(np.int32)
    tags = (np.arange(n) % TAG_MOD).astype(np.uint32)[:, None]
    return tenants, tags


@pytest.fixture(scope="module")
def port_index(small_index):
    return index_from_numpy(small_index.centroids,
                            small_index.codebook.codebooks,
                            small_index.codebook.sqnorms, small_index.codes,
                            small_index.ids, small_index.offsets,
                            device="cpu")


@pytest.fixture(scope="module")
def points(small_corpus):
    return np.asarray(small_corpus.points, np.float32)


@pytest.fixture(scope="module")
def queries(small_corpus):
    return np.asarray(small_corpus.queries, np.float32)


def _fin(d):
    return np.where(np.isfinite(d), d, 0.0)


def _assert_close_up_to_ties(pd, pi, rd, ri, rtol, atol):
    """Distances within tolerance with the (inf, -1) tail at the same
    places; ids equal as sets, except that an id found on one side only
    must sit at that side's k-th distance."""
    pd, pi, rd, ri = (np.asarray(x) for x in (pd, pi, rd, ri))
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    np.testing.assert_array_equal(pi < 0, ri < 0)
    np.testing.assert_allclose(_fin(pd), _fin(rd), rtol=rtol, atol=atol)
    k = pi.shape[1]
    for q in np.nonzero((np.sort(pi, 1) != np.sort(ri, 1)).any(1))[0]:
        a, b = set(pi[q].tolist()), set(ri[q].tolist())
        for ids, d, only in ((pi[q], pd[q], a - b), (ri[q], rd[q], b - a)):
            for j in np.nonzero(np.isin(ids, list(only)))[0]:
                assert np.isclose(d[j], d[k - 1], rtol=rtol, atol=atol), \
                    (q, a ^ b)


def _assert_isolation(d_got, i_got, d_ref, i_ref):
    """The reference's isolation rule: ids equal, distances close."""
    np.testing.assert_array_equal(np.asarray(i_got), np.asarray(i_ref))
    np.testing.assert_allclose(_fin(np.asarray(d_got)),
                               _fin(np.asarray(d_ref)), rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)


def _scoped_truth(points, queries, meta, tenant=-1, terms=(), k=K):
    """Exact neighbours among the rows in scope (brute force)."""
    ok = meta.match_host(np.arange(len(points)), tenant=tenant, terms=terms)
    rows = np.nonzero(ok)[0]
    d = ((queries[:, None, :] - points[None, rows, :]) ** 2).sum(-1)
    return rows[np.argsort(d, axis=1, kind="stable")[:, :k]]


def _recall(found, truth):
    return float(np.mean([len(set(f.tolist()) & set(t.tolist())) / K
                          for f, t in zip(found, truth)]))


# ---------------------------------------------------------------------------
# core.filter: tables, mask, pad_terms, tenant_subindex
# ---------------------------------------------------------------------------

def _apply_meta_ops(mod, tag_fields, seed, clusters):
    """One seeded sequence of VectorMeta writes, in either package."""
    rng = np.random.default_rng(seed)
    meta = mod.VectorMeta(capacity=16, tag_fields=tag_fields)
    n = 300
    meta.set(np.arange(n), tenant=rng.integers(-1, 4, n).astype(np.int32))
    if tag_fields:
        meta.set(np.arange(0, n, 2), tags=rng.integers(
            0, 9, (n // 2, tag_fields)).astype(np.uint32))
        meta.set([5, 7], tags=[3])                  # shorter rows pad
    meta.set(rng.integers(0, 500, 40), tenant=6, cluster=2)   # grows
    meta.set([1000], tenant=1)
    meta.rebuild_clusters(*clusters)
    meta.set(np.arange(20), cluster=rng.integers(0, 8, 20).astype(np.int32))
    return meta


@pytest.mark.parametrize("tag_fields", [0, 2, 4])
def test_vector_meta_matches_reference(small_clusters, tag_fields):
    """The same writes leave the same tables, version, tenant count,
    bitmap, CL mask and host match in both packages."""
    clusters = (np.asarray(small_clusters.ids),
                np.asarray(small_clusters.sizes))
    ref = _apply_meta_ops(ref_filter, tag_fields, 3, clusters)
    port = _apply_meta_ops(flt, tag_fields, 3, clusters)
    for a in ("tenant_of", "tags", "cluster_of"):
        np.testing.assert_array_equal(getattr(port, a), getattr(ref, a), a)
        assert getattr(port, a).dtype == getattr(ref, a).dtype, a
    assert port.version == ref.version and port.n_tenants == ref.n_tenants
    nlist = small_clusters.ids.shape[0]
    np.testing.assert_array_equal(port.bitmap(nlist), ref.bitmap(nlist))
    tenants = np.array([-1, 0, 1, 3, 6, 9, 2])
    np.testing.assert_array_equal(port.allowed_for(tenants, nlist),
                                  ref.allowed_for(tenants, nlist))
    np.testing.assert_array_equal(
        port.allowed_on(tenants, nlist, "cpu").numpy(),
        ref.allowed_for(tenants, nlist))
    ids = np.array([[-1, 0, 5, 7, 299], [1000, 1001, 4, 2, 6]])
    for tenant, terms in ((-1, ()), (1, ()), (-1, (3,)), (2, (3, 4)),
                          (0, (flt.NO_TAG,))):
        np.testing.assert_array_equal(
            port.match_host(ids, tenant=tenant, terms=terms),
            ref.match_host(ids, tenant=tenant, terms=terms))
    # the converter carries the tables, version and tag_fields across
    conv = vector_meta_from_reference(ref)
    assert conv.version == ref.version and conv.tag_fields == tag_fields
    np.testing.assert_array_equal(conv.tags, ref.tags)
    np.testing.assert_array_equal(conv.bitmap(nlist), ref.bitmap(nlist))


def _mask_case(case):
    """(meta tables (tenant, tags u32), row ids, q tenants, q terms u32)."""
    rng = np.random.default_rng(11)
    n, f = (40, 0) if case == "tag_fields_0" else (40, 3)
    tenant = rng.integers(-1, 3, n).astype(np.int32)
    tags = rng.integers(0, 6, (n, f)).astype(np.uint32)
    tags[rng.random((n, f)) < 0.3] = flt.NO_TAG
    r, c, w = 6, 9, 2
    rows = rng.integers(-1, n + 5, (r, c)).astype(np.int32)  # pad + oob ids
    q_ten = rng.integers(-1, 3, r).astype(np.int32)
    q_terms = rng.integers(0, 6, (r, w)).astype(np.uint32)
    q_terms[rng.random((r, w)) < 0.4] = flt.NO_TAG
    if case == "no_terms":
        q_terms[:] = flt.NO_TAG
    if case == "out_of_range":                # mutated after the snapshot
        rows = np.where(rows >= 0, rows + n, rows)
    return tenant, tags, rows, q_ten, q_terms


@pytest.mark.parametrize("case", ["random", "no_terms", "tag_fields_0",
                                  "out_of_range"])
def test_scope_mask_matches_reference(case):
    """The mask over padding ids, ids past the tables, all-NO_TAG terms
    and tag_fields 0 equals the reference's (R, C, F, W) grid."""
    tenant, tags, rows, q_ten, q_terms = _mask_case(case)
    want = np.asarray(ref_filter.scope_mask(
        jnp.asarray(rows), jnp.asarray(tenant), jnp.asarray(tags),
        jnp.asarray(q_ten), jnp.asarray(q_terms)))
    got = flt.scope_mask(torch.from_numpy(rows), torch.from_numpy(tenant),
                         torch.from_numpy(tags.view(np.int32)),
                         torch.from_numpy(q_ten),
                         torch.from_numpy(flt.terms_bits(q_terms)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[torch.from_numpy(rows) < 0].any()
    d = np.random.default_rng(2).random(rows.shape).astype(np.float32)
    np.testing.assert_array_equal(
        flt.mask_scoped_distances(
            torch.from_numpy(d), torch.from_numpy(rows),
            torch.from_numpy(tenant), torch.from_numpy(tags.view(np.int32)),
            torch.from_numpy(q_ten),
            torch.from_numpy(flt.terms_bits(q_terms))).numpy(),
        np.where(want, d, np.inf))


@pytest.mark.parametrize("rows,width", [([(1,), (), (2, 3)], 3),
                                        ([(1, 2, 3, 4)], 3), ([()], 1),
                                        ([(7, 8)], 1)])
def test_pad_terms_matches_reference(rows, width):
    try:
        want = ref_filter.pad_terms(rows, width)
    except ValueError:
        with pytest.raises(ValueError, match="filter_width"):
            flt.pad_terms(rows, width)
        return
    got = flt.pad_terms(rows, width)
    assert got.dtype == np.uint32 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tenant", [0, 1, 2, 7])
def test_tenant_subindex_matches_reference(small_index, port_index,
                                           small_clusters, tenant):
    tenants, tags = _meta_arrays(small_index.ids.shape[0])
    metas = []
    for mod in (ref_filter, flt):
        m = mod.VectorMeta(tag_fields=2)
        m.set(np.arange(len(tenants)), tenant=tenants, tags=tags)
        m.set(np.arange(0, 40, 3), tenant=7)        # a scarce tenant
        m.rebuild_clusters(np.asarray(small_clusters.ids),
                           np.asarray(small_clusters.sizes))
        metas.append(m)
    rsub, rmem = ref_filter.tenant_subindex(small_index, metas[0], tenant)
    psub, pmem = flt.tenant_subindex(port_index, metas[1], tenant)
    np.testing.assert_array_equal(pmem, rmem)
    for a in ("centroids", "codes", "ids", "offsets"):
        np.testing.assert_array_equal(getattr(psub, a).numpy(),
                                      np.asarray(getattr(rsub, a)), a)
    assert psub.codebook is port_index.codebook
    with pytest.raises(ValueError, match="no rows"):
        flt.tenant_subindex(port_index, metas[1], 99)


def test_masked_cl_all_true_equals_plain_cl(port_index, queries):
    """An all-true row of ``allowed`` gives plain CL's probes and
    distances bit for bit (same fixed block)."""
    q = torch.from_numpy(queries[:20])
    allowed = torch.ones((20, port_index.nlist), dtype=torch.bool)
    allowed[5:10, ::2] = False
    pi, pd = cluster_locate(q, port_index.centroids, 8, block=32)
    mi, md = cluster_locate_masked(q, port_index.centroids, 8, allowed,
                                   block=32)
    keep = np.r_[0:5, 10:20]
    assert torch.equal(mi[keep], pi[keep]) and torch.equal(md[keep],
                                                           pd[keep])
    assert bool((mi[5:10] % 2 == 1).all())


# ---------------------------------------------------------------------------
# service.tenancy: the same decisions on the same call sequence
# ---------------------------------------------------------------------------

def _qos_trace(mod):
    out = []
    b = mod.TokenBucket(rate_qps=3.0, burst=2)
    for t in (0.0, 0.0, 0.0, 0.2, 0.4, 0.5, 1.0, 9.0, 9.0, 9.0):
        out.append(b.take(t))
    reg = mod.TenantRegistry((("a", 0, 2.0, 0.0, 1), ("b", 2, 1.0, 4.0, 3),
                              ("c", 5, 0.5, 1.0, 1)))
    out += [reg.resolve(None), reg.resolve("b"), reg.resolve(5),
            reg.resolve(42), reg.weight_of(5), reg.weight_of(9),
            reg.name_of(2), reg.name_of(9)]
    rng = np.random.default_rng(5)
    for t, tid in zip(np.cumsum(rng.exponential(0.1, 40)),
                      rng.choice([0, 2, 5, 9], 40)):
        out.append(reg.admit(int(tid), float(t)))
    out.append(reg.stats())
    wfq = mod.WFQScheduler(reg, window=2)
    order = []
    for j, tid in enumerate(rng.choice([0, 2, 5, -1], 30)):
        wfq.submit(int(tid), lambda j=j, tid=tid: order.append((j, int(tid))))
        if j % 4 == 3:
            wfq.on_complete()
    out.append(wfq.pending)
    while wfq.pending:
        wfq.on_complete()
    out += [order, wfq.stats()]
    return out


def test_qos_decisions_match_reference():
    assert _qos_trace(tenancy) == _qos_trace(ref_tenancy)
    with pytest.raises(KeyError, match="unknown tenant"):
        tenancy.TenantRegistry((("a", 0, 1.0, 0.0, 1),)).resolve("z")
    with pytest.raises(ValueError, match="window"):
        tenancy.WFQScheduler(tenancy.TenantRegistry(), 0)


# ---------------------------------------------------------------------------
# AnnService(tenants=, tags=) against the reference's
# ---------------------------------------------------------------------------

ENGINES = {
    "local": {"engine": "local"},
    "sharded": {"engine": "sharded", "n_shards": 4},
    "tiered": {"engine": "local", "storage": "tiered",
               "storage_budget_bytes": 1 << 16},
}


def _services(small_index, port_index, points, nprobe, lut_dtype, engine,
              tmp_path):
    kw = dict(ENGINES[engine], replicas=1, nprobe=nprobe, k=K,
              lut_dtype=lut_dtype, buckets=(1, 2, 4), max_wait_s=1e-3)
    tenants, tags = _meta_arrays(len(points))
    extra = ({"sample_queries": points[:32]} if engine == "sharded"
             else {})
    out = []
    for pkg, spec_cls, idx in (("ref", RefSpec, small_index),
                               ("port", ServiceSpec, port_index)):
        if engine == "tiered":
            kw["storage_dir"] = str(tmp_path / pkg)
        svc_cls = RefService if pkg == "ref" else AnnService
        out.append(svc_cls.build(spec_cls(**kw), index=idx, tenants=tenants,
                                 tags=tags, **extra))
    return out


SCOPES = [("tenant 0", 0, ()), ("tenant 2", 2, ()), ("terms", None, (1, 3)),
          ("tenant 1 + term", 1, (2,))]


@pytest.mark.parametrize("engine,nprobe,lut_dtype", [
    ("local", 1, "f32"), ("local", 4, "f32"), ("local", 16, "f32"),
    ("local", 1, "uint8"), ("local", 4, "uint8"), ("local", 16, "uint8"),
    ("sharded", 4, "f32"), ("sharded", 16, "uint8"),
    ("tiered", 4, "f32"), ("tiered", 4, "uint8")])
def test_scoped_service_matches_reference(small_index, port_index, points,
                                          queries, engine, nprobe, lut_dtype,
                                          tmp_path):
    ref, port = _services(small_index, port_index, points, nprobe,
                          lut_dtype, engine, tmp_path)
    try:
        np.testing.assert_array_equal(port.index.meta.cluster_of,
                                      ref.index.meta.cluster_of)
        for label, tenant, terms in SCOPES:
            rd, ri = (np.asarray(x) for x in ref.search(
                queries, tenant=tenant, terms=terms))
            pd_, pi = port.search(queries, tenant=tenant, terms=terms)
            live = pi[pi >= 0]
            assert live.size and np.all(port.index.meta.match_host(
                live, tenant=-1 if tenant is None else tenant, terms=terms))
            if lut_dtype == "f32":
                _assert_close_up_to_ties(pd_, pi, rd, ri, RTOL, ATOL)
            else:
                truth = _scoped_truth(points, queries, port.index.meta,
                                      -1 if tenant is None else tenant,
                                      terms)
                assert abs(_recall(pi, truth) - _recall(ri, truth)) <= 0.01, \
                    label
        # a mixed batch: per-row tenants and terms, unscoped rows included
        rows = np.array([-1, 0, 1, 2, -1, 7] * 4, np.int32)
        terms = flt.pad_terms([(), (), (4,), (), (0, 2), ()] * 4, 4)
        q = queries[:24]
        rd, ri = (np.asarray(x) for x in ref.replicas[0].engine.search_batch(
            q, tenants=rows, terms=terms))
        pd_, pi = port.replicas[0].engine.search_batch(q, tenants=rows,
                                                       terms=terms)
        assert np.all(pi[5::6] == -1)          # tenant 7 has no rows
        if lut_dtype == "f32":
            _assert_close_up_to_ties(pd_, pi, rd, ri, RTOL, ATOL)
        else:
            assert np.mean(pi == ri) >= 0.9
    finally:
        ref.shutdown()
        port.shutdown()


def test_unscoped_rows_of_a_mixed_batch_equal_unscoped_search(port_index,
                                                              points,
                                                              queries):
    tenants, tags = _meta_arrays(len(points))
    spec = ServiceSpec(engine="local", replicas=1, nprobe=8, k=K,
                       buckets=(1, 2, 4))
    svc = AnnService.build(spec, index=port_index, tenants=tenants,
                           tags=tags)
    rows = np.array([-1, 1, -1, 2] * 16, np.int32)
    d, i = svc.replicas[0].engine.search_batch(queries, tenants=rows)
    ud, ui = (x.numpy() for x in search_ivfpq(
        port_index, pad_clusters(port_index), torch.from_numpy(queries),
        SearchParams(nprobe=8, k=K, use_kernels=True)))
    free = rows < 0
    assert np.array_equal(d[free], ud[free]) and np.array_equal(i[free],
                                                                ui[free])
    assert np.all(tenants[i[~free]] == rows[~free][:, None])
    svc.shutdown()


# ---------------------------------------------------------------------------
# The port's own oracles
# ---------------------------------------------------------------------------

def _port_service(port_index, points, nprobe, lut_dtype, **kw):
    tenants, tags = _meta_arrays(len(points))
    kw.setdefault("engine", "local")
    spec = ServiceSpec(replicas=1, nprobe=nprobe, k=K, lut_dtype=lut_dtype,
                       buckets=(1, 2, 4), max_wait_s=1e-3, **kw)
    return AnnService.build(spec, index=port_index, tenants=tenants,
                            tags=tags,
                            **({"sample_queries": points[:32]}
                               if kw["engine"] == "sharded" else {}))


def _dedicated(port_index, meta, tid, queries, nprobe, lut_dtype):
    sub, members = flt.tenant_subindex(port_index, meta, tid)
    d, i = search_ivfpq(sub, pad_clusters(sub), torch.from_numpy(queries),
                        SearchParams(nprobe=min(nprobe, len(members)), k=K,
                                     lut_dtype=lut_dtype, use_kernels=True))
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_scoped_equals_dedicated_subindex(port_index, points, queries,
                                          nprobe, lut_dtype):
    svc = _port_service(port_index, points, nprobe, lut_dtype)
    tenants, _ = _meta_arrays(len(points))
    for tid in range(N_TENANTS):
        d_s, i_s = svc.search(queries, tenant=tid)
        live = i_s[i_s >= 0]
        assert live.size and np.all(tenants[live] == tid)
        _assert_isolation(d_s, i_s, *_dedicated(
            port_index, svc.index.meta, tid, queries, nprobe, lut_dtype))
    svc.shutdown()


@pytest.mark.parametrize("engine", ["sharded", "tiered"])
def test_isolation_holds_across_engines(port_index, points, queries, engine,
                                        tmp_path):
    kw = dict(ENGINES[engine])
    if engine == "tiered":
        kw["storage_dir"] = str(tmp_path)
    svc = _port_service(port_index, points, 4, "f32", **kw)
    for tid in range(N_TENANTS):
        d_s, i_s = svc.search(queries[:16], tenant=tid)
        d_r, i_r = _dedicated(port_index, svc.index.meta, tid, queries[:16],
                              4, "f32")
        if engine == "sharded":   # per-task TS, then the host merge
            _assert_close_up_to_ties(d_s, i_s, d_r, i_r, RTOL, ATOL)
        else:
            _assert_isolation(d_s, i_s, d_r, i_r)
    svc.shutdown()


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_filtered_equals_brute_force_post_filter(port_index, points, queries,
                                                 nprobe, lut_dtype):
    """Rank every candidate of the same probes, drop rows failing the
    host mask, keep k: the filtered search must give that."""
    svc = _port_service(port_index, points, nprobe, lut_dtype)
    meta, terms = svc.index.meta, (1, 3)
    d_f, i_f = svc.search(queries, terms=terms)
    clusters = pad_clusters(port_index)
    d_all, i_all = (x.numpy() for x in search_ivfpq(
        port_index, clusters, torch.from_numpy(queries),
        SearchParams(nprobe=nprobe, k=nprobe * clusters.cmax,
                     lut_dtype=lut_dtype, use_kernels=True)))
    keep = meta.match_host(i_all, terms=terms)
    d_ref = np.full((len(queries), K), np.inf, np.float32)
    i_ref = np.full((len(queries), K), -1, np.int32)
    for q in range(len(queries)):
        sel = np.flatnonzero(keep[q])[:K]
        d_ref[q, :sel.size], i_ref[q, :sel.size] = d_all[q, sel], i_all[q,
                                                                         sel]
    _assert_close_up_to_ties(d_f, i_f, d_ref, i_ref, ORACLE_TOL, ORACLE_TOL)
    assert np.all(meta.match_host(i_f[i_f >= 0], terms=terms))
    svc.shutdown()


def test_tenant_and_predicate_compose_and_scarce_tail(port_index, points,
                                                      queries):
    svc = _port_service(port_index, points, 4, "f32")
    meta = svc.index.meta
    _, i_f = svc.search(queries[:16], tenant=1, terms=(2,))
    live = i_f[i_f >= 0]
    assert live.size and np.all(meta.match_host(live, tenant=1, terms=(2,)))
    scarce = np.array([5, 17, 29])
    meta.set(scarce, tenant=7)                   # 3 rows < k
    d_s, i_s = svc.search(queries[:16], tenant=7)
    assert set(i_s[i_s >= 0].tolist()) <= set(scarce.tolist())
    live_n = (i_s >= 0).sum(axis=1)
    for q in range(16):
        n = int(live_n[q])
        assert np.all(i_s[q, :n] >= 0) and np.all(i_s[q, n:] == -1)
        assert np.all(np.isinf(d_s[q, n:])) and np.all(np.isfinite(
            d_s[q, :n]))
    svc.shutdown()


def test_scope_refusals_match_reference(port_index, queries):
    eng = LocalEngine(port_index, pad_clusters(port_index),
                      SearchParams(nprobe=4, k=K))
    with pytest.raises(ValueError, match="meta=None"):
        eng.search_batch(queries[:2], tenants=np.zeros(2, np.int32))
    svc = AnnService.build(ServiceSpec(engine="local", nprobe=4, k=K,
                                       buckets=(1, 2)), index=port_index)
    with pytest.raises(KeyError, match="tenants section"):
        svc.search(queries[:2], tenant="anna")
    svc.shutdown()
    with pytest.raises(ValueError, match="coarse"):
        ServiceSpec(engine="local", nprobe=4, k=K, coarse_groups=4,
                    tenants=(("a", 0, 1.0, 0.0, 1),)).validate()


# ---------------------------------------------------------------------------
# Quotas and the fair queue through the service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clock", ["virtual", "wall"])
def test_stream_quotas_and_wfq(port_index, points, queries, clock):
    tenants, tags = _meta_arrays(len(points))
    spec = ServiceSpec(engine="local", replicas=2, nprobe=4, k=K,
                       buckets=(1, 2, 4), max_wait_s=1e-3,
                       tenants=(("t0", 0, 4.0, 0.0, 1),
                                ("t1", 1, 1.0, 0.0, 1),
                                ("t2", 2, 1.0, 50.0, 2)),
                       qos_wfq=clock == "wall")
    svc = AnnService.build(spec, index=port_index, tenants=tenants,
                           tags=tags)
    svc.warmup()
    who = np.arange(60) % 3
    trace = [(j * 2e-3, queries[j % len(queries)], ["t0", "t1", "t2"][w])
             for j, w in enumerate(who)]
    reqs = svc.stream(trace, clock=clock)
    st = svc.stats()
    ten = st["tenants"]
    assert ten["t0"]["shed"] == ten["t1"]["shed"] == 0
    assert ten["t2"]["shed"] > 0
    assert len(reqs) == 60 - ten["t2"]["shed"]
    for r in reqs:                       # == the direct scoped search
        d, i = svc.search(r.query[None], tenant=r.tenant)
        assert np.array_equal(r.ids, i[0]) and np.array_equal(r.dists, d[0])
        assert np.all(tenants[r.ids[r.ids >= 0]] == r.tenant)
    assert sum(ten[t]["requests"] for t in ("t0", "t1", "t2")) == len(reqs)
    assert sorted(st["router"]["tenant_picks"]) == [0, 1, 2]
    if clock == "wall":
        assert sum(st["qos"]["dispatched"].values()) == len(reqs)
        assert st["qos"]["queued"] == 0
    svc.shutdown()


# ---------------------------------------------------------------------------
# The live index with tenants
# ---------------------------------------------------------------------------

def test_live_index_scoped_matches_reference(small_index, points, queries):
    """Tagged upserts, an untagged re-upsert (no scope carried over) and a
    generation with a tagged upsert past its snapshot leave the same
    tables in both packages, and the scoped engines agree."""
    tenants, tags = _meta_arrays(len(points))
    ref = RefIndex(small_index, points=points, mutable=True)
    RefService._attach_meta(RefSpec(filter_width=2), ref, tenants, tags)
    port = mutable_index_from_reference(ref, device="cpu")
    new = np.arange(len(points), len(points) + 64)
    vecs = points[:64] + 0.5
    for h in (ref, port):
        h.upsert(new, vecs, tenant=2, tags=[[4, 9]])
        h.upsert(new[:8], vecs[:8])                 # re-upsert: unscoped
        h.delete(np.arange(0, 300, 3))
    for a in ("tenant_of", "tags", "cluster_of"):
        np.testing.assert_array_equal(getattr(port.meta, a),
                                      getattr(ref.meta, a), a)
    assert np.all(port.meta.tenant_of[new[:8]] == -1)
    # a generation built on the reference (snapshot here), carried across
    # with the handle, then one more tagged upsert past the snapshot
    gen = ref.build_generation(seed=1)
    port = mutable_index_from_reference(ref, device="cpu")
    pgen = generation_from_reference(gen, device="cpu")
    for h in (ref, port):
        h.upsert(new[8:16], vecs[8:16], tenant=1)
    assert port.install_generation(pgen) == ref.install_generation(gen)
    for a in ("tenant_of", "tags", "cluster_of"):
        np.testing.assert_array_equal(getattr(port.meta, a),
                                      getattr(ref.meta, a), a)
    assert port.meta.version == ref.meta.version
    reng = RefLocalEngine(ref.search_view, ref.clusters,
                          RefParams(nprobe=8, k=K), meta=ref.meta)
    peng = LocalEngine(port.search_view, port.clusters,
                       SearchParams(nprobe=8, k=K, use_kernels=True),
                       meta=port.meta)
    q = np.concatenate([queries[:24], vecs[16:24]])
    for tid, terms in ((2, ()), (1, ()), (0, (3,)), (-1, (9,))):
        t = np.full(len(q), tid, np.int32)
        g = flt.pad_terms([terms] * len(q), 2)
        rd, ri = (np.asarray(x) for x in reng.search_batch(q, tenants=t,
                                                            terms=g))
        pd_, pi = peng.search_batch(q, tenants=t, terms=g)
        _assert_close_up_to_ties(pd_, pi, rd, ri, RTOL, ATOL)
    # tenant 2's upserts retrieve themselves under tenant 2 only
    t2 = np.full(8, 2, np.int32)
    _, i2 = peng.search_batch(vecs[16:24], tenants=t2)
    assert np.all(i2[:, 0] == new[16:24])
    for other in (0, 1):
        _, io = peng.search_batch(vecs[16:24],
                                  tenants=np.full(8, other, np.int32))
        assert not np.isin(io, new[16:]).any()


def test_live_service_tagged_upserts_follow_the_oracle(points, queries):
    """AnnService(mutable=True) built by the port: tagged upserts land in
    their tenant's scope only, before and after a forced generation, and
    scoped search equals the dedicated sub-index of the snapshot."""
    spec = ServiceSpec(engine="local", replicas=1, nprobe=4, k=K,
                       buckets=(1, 2, 4), mutable=True,
                       index=IndexSpec(nlist=32, m=8, cb=64, kmeans_iters=4,
                                       pq_iters=4),
                       tenants=(("a", 0, 1.0, 0.0, 1),
                                ("b", 1, 1.0, 0.0, 1)))
    n = 2000
    tenants = (np.arange(n) % 2).astype(np.int32)
    svc = AnnService.build(spec, points[:n], device="cpu", tenants=tenants)
    new = np.arange(n, n + 32)
    svc.upsert(new, points[n:n + 32], tenant="b")
    for when in ("before", "after"):
        _, ib = svc.search(points[n:n + 32], tenant="b")
        assert np.all(ib[:, 0] == new), when
        _, ia = svc.search(points[n:n + 32], tenant="a")
        assert not np.isin(ia, new).any(), when
        ivf = svc.index.to_ivfpq()
        d_s, i_s = svc.search(queries, tenant=1)
        _assert_isolation(d_s, i_s, *_dedicated(ivf, svc.index.meta, 1,
                                                queries, 4, "f32"))
        if when == "before":
            svc.run_maintenance(force=True)
    svc.shutdown()


def test_selftest_tenants_on_the_cpu(capsys):
    assert cli.main(["--selftest-tenants", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 3 and "multi-tenant serving OK" in out


def test_meta_snapshots_stay_whole_under_writers():
    """Replica workers take device tables and CL masks while an upsert
    thread writes: every snapshot is one version's (a table written
    whole per write is never seen half old, half new), and a cached
    version never goes back."""
    import sys
    import threading
    n, nlist = 4000, 8
    meta = flt.VectorMeta(capacity=n, tag_fields=2)
    meta.set(np.arange(n), tenant=0, tags=[[0, 0]],
             cluster=np.arange(n) % nlist)
    stop = threading.Event()
    errors = []

    def writer():
        for v in range(1, 200):
            meta.set(np.arange(n), tenant=v % 3, tags=[[v, v]])
        stop.set()

    def reader():
        seen = -1
        while not stop.is_set():
            jt, jg, fields = meta.scope_tables("cpu")
            t, g = jt.numpy(), jg.numpy()
            if not ((t == t[0]).all() and (g == g[0, 0]).all()
                    and fields == (0, 1)):
                errors.append("torn snapshot")
            allowed = meta.allowed_on([0, 1, 2, -1], nlist, "cpu").numpy()
            if not allowed[3].all() or allowed[:3].sum() not in (0, nlist):
                errors.append("torn bitmap")
            v = meta.version
            if v < seen:
                errors.append("version went back")
            seen = v

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader) for _ in range(6)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert meta.version == 200
