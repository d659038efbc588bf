"""Public names of the port's ANN modules that the reference has, each
held to the reference on the same arguments: the tenant mix of
``make_query_stream``, ``BucketPolicy.pow2`` / ``single``,
``MicroBatcher.flush``, the subtraction-form LUT and the one-hot scans,
the package exports, ``configs/drim_ann.py::smoke_config`` and
``models/common.py::cast_tree``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.runtime as ref_runtime
import repro.service as ref_service
from repro.core import adc as ref_adc
from repro.core.pq import PQCodebook as RefPQCodebook
from repro.data import make_query_stream as ref_stream
from repro.runtime.batching import BucketPolicy as RefBucketPolicy
from repro.runtime.batching import MicroBatcher as RefMicroBatcher

import repro_torch.core as core
import repro_torch.runtime as runtime
import repro_torch.service as service
from repro_torch.core import adc
from repro_torch.core.pq import PQCodebook
from repro_torch.data import make_query_stream
from repro_torch.runtime.batching import BucketPolicy, MicroBatcher

RTOL, ATOL = 1e-4, 1e-3        # tests/test_kernels.py's tolerance


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
