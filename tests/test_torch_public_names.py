"""Public names of the port's ANN modules that the reference has, each
held to the reference on the same arguments: the tenant mix of
``make_query_stream``, ``BucketPolicy.pow2`` / ``single``,
``MicroBatcher.flush``, the subtraction-form LUT and the one-hot scans,
the package exports, ``configs/drim_ann.py::smoke_config``,
``models/common.py::cast_tree``, and the scoped steps on raw scope
arrays (``sharded_search.run_shards_vmap_scoped`` /
``run_shards_vmap_lut_scoped``) on the reference's own shards."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.runtime as ref_runtime
import repro.service as ref_service
from repro.core import adc as ref_adc
from repro.core import cluster_locate as ref_locate
from repro.core import sharded_search as ref_ss
from repro.core.pq import PQCodebook as RefPQCodebook
from repro.data import make_query_stream as ref_stream
from repro.runtime.batching import BucketPolicy as RefBucketPolicy
from repro.runtime.batching import MicroBatcher as RefMicroBatcher

import repro_torch.core as core
import repro_torch.runtime as runtime
import repro_torch.service as service
from repro_torch.convert import sharded_index_from_numpy
from repro_torch.core import adc
from repro_torch.core import filter as flt
from repro_torch.core import sharded_search as ss
from repro_torch.core.pq import PQCodebook
from repro_torch.data import make_query_stream
from repro_torch.kernels import ops
from repro_torch.runtime.batching import BucketPolicy, MicroBatcher

from test_torch_search import assert_same_neighbours

RTOL, ATOL = 1e-4, 1e-3        # tests/test_kernels.py's tolerance
K = 10


@pytest.mark.parametrize("kw", [
    dict(tenants=4),
    dict(tenants=[3, 1, 7], tenant_skew=1.2, skew=1.1),
    dict(tenants=4, tenant_weights=[8, 1, 1, 1], poisson=False),
    dict(tenants=1, seed=5),
], ids=["uniform", "zipf-ids", "weights", "one"])
def test_query_stream_tenant_mix_equals_reference(kw):
    pool = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    got = make_query_stream(pool, 200, 1000.0, **kw)
    want = ref_stream(pool, 200, 1000.0, **kw)
    assert len(got) == len(want) == 200
    for (t, q, ten), (rt, rq, rten) in zip(got, want):
        assert t == rt and ten == rten and np.array_equal(q, rq)
    # the tenant draw comes after the query draw: same times and queries
    # as the trace without tenants
    plain = make_query_stream(pool, 200, 1000.0, skew=kw.get("skew"),
                              seed=kw.get("seed", 0),
                              poisson=kw.get("poisson", True))
    assert [(t, q.tobytes()) for t, q, _ in got] == \
        [(t, q.tobytes()) for t, q in plain]


@pytest.mark.parametrize("kw", [dict(tenant_skew=1.0),
                                dict(tenants=0),
                                dict(tenants=2, tenant_skew=1.0,
                                     tenant_weights=[1, 1]),
                                dict(tenants=2, tenant_weights=[1, 0])])
def test_query_stream_tenant_errors_as_reference(kw):
    pool = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError):
        ref_stream(pool, 3, 10.0, **kw)
    with pytest.raises(ValueError):
        make_query_stream(pool, 3, 10.0, **kw)


@pytest.mark.parametrize("n", [1, 5, 32, 33])
def test_bucket_policy_constructors_equal_reference(n):
    assert BucketPolicy.pow2(n).buckets == RefBucketPolicy.pow2(n).buckets
    assert BucketPolicy.single(n).buckets == \
        RefBucketPolicy.single(n).buckets == (n,)


def test_microbatcher_flush_equals_reference():
    qs = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    out = []
    for cls, pol in ((MicroBatcher, BucketPolicy), (RefMicroBatcher,
                                                    RefBucketPolicy)):
        mb = cls(pol.pow2(8), max_wait_s=10.0)
        assert mb.flush(0.0) is None                 # nothing queued
        for i, q in enumerate(qs):
            mb.submit(q, now=0.1 * i)
        assert mb.poll(0.3) is None                  # not full, not due
        batch = mb.flush(0.3)
        out.append((batch.n_valid, batch.bucket, batch.reason,
                    batch.queries.copy(), mb.flush(0.4)))
    (n, b, reason, q, rest), ref = out
    assert (n, b, reason, rest) == (ref[0], ref[1], ref[2], ref[4])
    assert (n, b, reason, rest) == (3, 4, "drain", None)
    assert np.array_equal(q, ref[3])


def _lut_inputs(seed, t=6, m=8, cb=32, dsub=4, c=50):
    rng = np.random.default_rng(seed)
    books = rng.normal(size=(m, cb, dsub)).astype(np.float32)
    res = rng.normal(size=(t, m * dsub)).astype(np.float32)
    codes = rng.integers(0, cb, size=(t, c, m)).astype(np.uint8)
    return books, res, codes


def test_build_lut_direct_equals_expansion_and_reference():
    books, res, _ = _lut_inputs(2)
    sq = (books * books).sum(-1)
    cb = PQCodebook(torch.from_numpy(books), torch.from_numpy(sq))
    direct = adc.build_lut_direct(cb, torch.from_numpy(res))
    assert direct.shape == (6, 8, 32)
    np.testing.assert_allclose(
        direct.numpy(), adc.build_lut_batch(cb, torch.from_numpy(res))
        .numpy(), rtol=RTOL, atol=ATOL)
    rcb = RefPQCodebook(jnp.asarray(books), jnp.asarray(sq))
    for t in range(res.shape[0]):
        want = ref_adc.build_lut_direct(rcb, jnp.asarray(res[t]))
        np.testing.assert_allclose(
            adc.build_lut_direct(cb, torch.from_numpy(res[t])).numpy(),
            np.asarray(want), rtol=1e-6, atol=1e-6)


def test_scan_codes_onehot_equals_gather_and_reference():
    books, res, codes = _lut_inputs(3)
    sq = (books * books).sum(-1)
    lut = adc.build_lut_batch(PQCodebook(torch.from_numpy(books),
                                         torch.from_numpy(sq)),
                              torch.from_numpy(res))
    ct = torch.from_numpy(codes)
    got = adc.scan_codes_onehot(lut, ct)
    np.testing.assert_allclose(got.numpy(), adc.scan_codes(lut, ct).numpy(),
                               rtol=RTOL, atol=ATOL)
    for t in range(codes.shape[0]):
        want = ref_adc.scan_codes_onehot(jnp.asarray(lut[t].numpy()),
                                         jnp.asarray(codes[t]))
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    q = adc.quantize_lut(lut)
    got_q = adc.scan_codes_onehot_quantized(q, ct)
    np.testing.assert_allclose(got_q.numpy(),
                               adc.scan_codes_quantized(q, ct).numpy(),
                               rtol=RTOL, atol=ATOL)
    for t in range(codes.shape[0]):
        rq = ref_adc.QuantizedLUT(*(jnp.asarray(x[t].numpy()) for x in q))
        want = ref_adc.scan_codes_onehot_quantized(rq, jnp.asarray(codes[t]))
        np.testing.assert_allclose(got_q[t].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("port,ref,names", [
    (core, ref_core, ("Index", "MutationStats", "build_lut_direct",
                      "scan_codes_onehot", "scan_codes_onehot_quantized")),
    (service, ref_service, ("MutationCoordinator",)),
    (runtime, ref_runtime, ("entry_nbytes", "stack_lut_bank")),
], ids=["core", "service", "runtime"])
def test_exports_present_as_in_reference(port, ref, names):
    for name in names:
        assert hasattr(ref, name), name
        assert name in port.__all__ and callable(getattr(port, name)), name
    from repro_torch.core.mutable_index import Index, MutationStats
    from repro_torch.runtime.cache import entry_nbytes
    from repro_torch.service.mutation import MutationCoordinator
    assert core.Index is Index and core.MutationStats is MutationStats
    assert service.MutationCoordinator is MutationCoordinator
    assert runtime.entry_nbytes is entry_nbytes
    assert runtime.entry_nbytes(torch.zeros(4, 8)) == 128


def test_drim_ann_smoke_config_equals_reference():
    from repro.configs import drim_ann as ref_drim
    from repro_torch.configs import drim_ann
    got, want = drim_ann.smoke_config(), ref_drim.smoke_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != drim_ann.config()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_cast_tree_equals_reference(dtype):
    from repro.models.common import cast_tree as ref_cast_tree
    from repro_torch.models.common import cast_tree
    rng = np.random.default_rng(9)
    leaves = [np.asarray(rng.normal(size=s) * 7, np.float32)
              for s in ((3, 4), (5,), (2, 2, 3), ())]

    def tree(wrap):
        return {"embed": wrap(leaves[0]),
                "groups": [{"w": wrap(leaves[1])}, {"w": wrap(leaves[2])}],
                "final_norm": wrap(leaves[3])}

    got = cast_tree(tree(torch.from_numpy), getattr(torch, dtype))
    want = ref_cast_tree(tree(jnp.asarray), getattr(jnp, dtype))
    assert got["groups"][1]["w"].dtype == getattr(torch, dtype)
    pairs = [(got["embed"], want["embed"]),
             (got["final_norm"], want["final_norm"])] + [
        (g["w"], w["w"]) for g, w in zip(got["groups"], want["groups"])]
    for g, w in pairs:
        assert tuple(g.shape) == tuple(w.shape)
        assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# The scoped steps on raw scope arrays (the reference's names)
# ---------------------------------------------------------------------------

SCOPED_MODES = ("f32", "uint8", "lut-f32", "lut-uint8")


@pytest.fixture(scope="module")
def scoped_case(small_index, small_corpus):
    """The reference's shards and schedule (8 shards, 16 probes a query)
    on the conftest index, carried across through numpy; raw scope
    arrays (three tenants striped over the ids, a tag field of 6 values
    and a sparse second one; per-query tenants, -1 for unscoped, and
    NO_TAG-padded terms); and a LUT bank of the tasks' residuals, f32 and
    quantized, one row a valid task, every fifth row withheld (-1)."""
    queries = np.asarray(small_corpus.queries, np.float32)
    probes = np.asarray(ref_locate(jnp.asarray(queries),
                                   small_index.centroids, 16)[0])
    eng = ref_ss.DistributedEngine(
        small_index, ref_ss.EngineConfig(
            n_shards=8, nprobe=16, k=K + 1, tasks_per_shard=256,
            split_max=64, strategy="gather", dup_budget_bytes=1 << 18),
        probes)
    sched = eng.schedule(probes)
    rs = eng.sindex
    n = int(np.asarray(small_index.ids).max()) + 1
    rng = np.random.default_rng(7)
    meta_tenant = (np.arange(n) % 3).astype(np.int32)
    meta_tags = np.full((n, 2), flt.NO_TAG, np.uint32)
    meta_tags[:, 0] = rng.integers(0, 6, n)
    meta_tags[::7, 1] = 9
    q = len(queries)
    q_tenants = rng.integers(-1, 3, q).astype(np.int32)
    q_terms = np.full((q, 2), flt.NO_TAG, np.uint32)
    q_terms[::2, 0] = rng.integers(0, 6, len(q_terms[::2]))
    q_terms[::3, 1] = 9
    qidx, sidx = sched.query_idx, sched.slot_idx
    valid = qidx >= 0
    lidx = np.where(valid, np.arange(qidx.size).reshape(qidx.shape), -1)
    lidx[valid & (np.arange(qidx.size).reshape(qidx.shape) % 5 == 0)] = -1
    cluster_of = np.asarray(rs.cluster_of)
    slot = np.clip(sidx, 0, cluster_of.shape[1] - 1)
    cl = cluster_of[np.arange(qidx.shape[0])[:, None], slot].reshape(-1)
    res = (queries[np.clip(qidx, 0, q - 1).reshape(-1)]
           - np.asarray(small_index.centroids)[np.clip(cl, 0, None)])
    bank = ref_adc.build_lut_batch(small_index.codebook, jnp.asarray(res))
    banks = {"lut-f32": bank, "lut-uint8": ref_adc.quantize_lut(bank)}
    return dict(
        rs=rs, qidx=qidx, sidx=sidx, lidx=lidx, queries=queries,
        banks=banks,
        raw=(meta_tenant, meta_tags, q_tenants, q_terms),
        sx=sharded_index_from_numpy(
            np.asarray(rs.codes), np.asarray(rs.ids), np.asarray(rs.sizes),
            cluster_of, np.asarray(rs.start_of), rs.slot_of_instance,
            np.asarray(rs.centroids), np.asarray(rs.codebook.codebooks),
            np.asarray(rs.codebook.sqnorms), None, device="cpu"))


def _port_bank(bank):
    if isinstance(bank, ref_adc.QuantizedLUT):
        return adc.QuantizedLUT(*(torch.from_numpy(np.array(x))
                                  for x in bank))
    return torch.from_numpy(np.array(bank))


def _scoped_port(case, mode, k=K):
    if mode.startswith("lut"):
        return ss.run_shards_vmap_lut_scoped(
            case["sx"], case["qidx"], case["sidx"], case["lidx"],
            _port_bank(case["banks"][mode]), *case["raw"], k=k,
            strategy="gather")
    return ss.run_shards_vmap_scoped(
        case["sx"], case["qidx"], case["sidx"], case["queries"],
        *case["raw"], k=k, quantize=mode == "uint8")


def _scoped_ref(case, mode, k=K + 1):
    raw = [jnp.asarray(a) for a in case["raw"]]
    if mode.startswith("lut"):
        d, i = ref_ss.run_shards_vmap_lut_scoped(
            case["rs"], jnp.asarray(case["qidx"]), jnp.asarray(case["sidx"]),
            jnp.asarray(case["lidx"]), case["banks"][mode], *raw, k=k,
            strategy="gather")
    else:
        d, i = ref_ss.run_shards_vmap_scoped(
            case["rs"], jnp.asarray(case["qidx"]), jnp.asarray(case["sidx"]),
            jnp.asarray(case["queries"]), *raw, k=k, strategy="gather",
            quantize=mode == "uint8")
    return np.asarray(d), np.asarray(i)


def _task_recall(found, truth):
    """Mean share of each task's finite truth ids found (tasks with any)."""
    shares = [len(set(f) & set(t[t >= 0])) / (t >= 0).sum()
              for f, t in zip(found, truth) if (t >= 0).any()]
    return float(np.mean(shares))


@pytest.mark.parametrize("mode", SCOPED_MODES)
def test_scoped_steps_equal_reference(scoped_case, mode):
    """The two names against the reference's on the same shards, schedule
    and scope: f32 (and a bank, whose rows are the same tables on both
    sides) distances at rtol 1e-4 / atol 1e-3 with ids up to ties at the
    k-th place; uint8 (each side quantizes its own LC tables) by recall
    of the reference's f32 winners, within 0.01 of the reference's."""
    ops.reset_launches()
    pd, pi = (x.numpy() for x in _scoped_port(scoped_case, mode))
    assert pd.shape == scoped_case["qidx"].shape + (K,)
    assert pi.dtype == np.int32
    assert all(v == 0 for v in ops.launches.values())    # CPU: plain runs
    rd, ri = _scoped_ref(scoped_case, mode)
    if mode == "uint8":
        _, fi = _scoped_ref(scoped_case, "f32", k=K)
        got = _task_recall(pi.reshape(-1, K), fi.reshape(-1, K))
        want = _task_recall(ri[..., :K].reshape(-1, K), fi.reshape(-1, K))
        assert got >= want - 0.01, (got, want)
        return
    pd, pi = pd.reshape(-1, K), pi.reshape(-1, K)
    rd, ri = rd.reshape(-1, K + 1), ri.reshape(-1, K + 1)
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(rd[:, :K]))
    np.testing.assert_allclose(pd, rd[:, :K], rtol=RTOL, atol=ATOL)
    assert (pi[np.isinf(pd)] == -1).all()
    assert_same_neighbours(pd, pi, rd, ri)


@pytest.mark.parametrize("mode", SCOPED_MODES)
def test_scoped_steps_keep_out_of_scope_rows_out(scoped_case, mode):
    """Every id returned is in its task's query's scope: its tenant when
    the query has one, a tag among the query's terms when it has any.
    Tasks without a bank row (lidx -1) return nothing."""
    meta_tenant, meta_tags, q_tenants, q_terms = scoped_case["raw"]
    _, pi = _scoped_port(scoped_case, mode)
    pi = pi.numpy().reshape(-1, K)
    qidx = scoped_case["qidx"].reshape(-1)
    seen = 0
    for q, ids in zip(qidx, pi):
        ids = ids[ids >= 0]
        if q < 0:
            assert ids.size == 0
            continue
        seen += ids.size
        if q_tenants[q] >= 0:
            assert (meta_tenant[ids] == q_tenants[q]).all()
        terms = q_terms[q][q_terms[q] != flt.NO_TAG]
        if terms.size:
            assert np.isin(meta_tags[ids], terms).any(axis=1).all()
    assert seen > 0
    if mode.startswith("lut"):
        lidx = scoped_case["lidx"].reshape(-1)
        assert (pi[lidx < 0] == -1).all()


@pytest.mark.parametrize("mode", SCOPED_MODES)
def test_scoped_steps_equal_run_shards_scoped(scoped_case, mode):
    """Each name == ``run_shards_scoped`` with the equivalent
    :class:`Scope` (a ``VectorMeta`` holding the same tables), bit for
    bit: the same kernels' plain versions on the same tasks."""
    meta_tenant, meta_tags, q_tenants, q_terms = scoped_case["raw"]
    meta = flt.VectorMeta(capacity=len(meta_tenant), tag_fields=2)
    meta.set(np.arange(len(meta_tenant)), tenant=meta_tenant, tags=meta_tags)
    scope = flt.Scope(meta, q_tenants, q_terms, "cpu")
    kw = dict(k=K)
    if mode.startswith("lut"):
        kw.update(lidx=scoped_case["lidx"],
                  lut_bank=_port_bank(scoped_case["banks"][mode]))
    else:
        kw.update(quantize=mode == "uint8")
    wd, wi = ss.run_shards_scoped(scoped_case["sx"], scoped_case["qidx"],
                                  scoped_case["sidx"],
                                  torch.from_numpy(scoped_case["queries"]),
                                  scope, **kw)
    gd, gi = _scoped_port(scoped_case, mode)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


@pytest.mark.parametrize("name", ["run_shards_vmap_scoped",
                                  "run_shards_vmap_lut_scoped"])
def test_scoped_step_signatures_and_strategy(scoped_case, name):
    """The reference's parameters in its order; an unknown strategy is
    refused as by ``run_shards_vmap``."""
    import inspect
    got = list(inspect.signature(getattr(ss, name)).parameters)
    want = list(inspect.signature(getattr(ref_ss, name)).parameters)
    assert got == want
    mode = "lut-f32" if "lut" in name else "f32"
    with pytest.raises(ValueError, match="strategy"):
        if mode == "f32":
            ss.run_shards_vmap_scoped(
                scoped_case["sx"], scoped_case["qidx"], scoped_case["sidx"],
                scoped_case["queries"], *scoped_case["raw"], k=K,
                strategy="bogus")
        else:
            ss.run_shards_vmap_lut_scoped(
                scoped_case["sx"], scoped_case["qidx"], scoped_case["sidx"],
                scoped_case["lidx"], _port_bank(scoped_case["banks"][mode]),
                *scoped_case["raw"], k=K, strategy="bogus")
    with pytest.raises(ValueError, match="strategy"):
        ss.run_shards_vmap(scoped_case["sx"],
                           torch.from_numpy(scoped_case["qidx"]),
                           torch.from_numpy(scoped_case["sidx"]),
                           torch.from_numpy(scoped_case["queries"]), k=K,
                           strategy="bogus")
