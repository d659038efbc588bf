"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, with their launch counters.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither jax nor the reference package, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (SearchParams, build_ivfpq, cluster_locate,
                              pad_clusters, recall_at_k, search_ivfpq)
from repro_torch.core.adc import (adc_distances, adc_distances_quantized,
                                  quantize_lut)
from repro_torch.data import make_clustered_corpus
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-3        # f32 sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _mk(seed, t, m, cb, c, dsub, code_dtype, device):
    rng = np.random.default_rng(seed)
    res = rng.normal(size=(t, m * dsub)).astype(np.float32)
    books = rng.normal(size=(m, cb, dsub)).astype(np.float32)
    sqn = (books * books).sum(-1)
    codes = rng.integers(0, cb, size=(t, c, m)).astype(code_dtype)
    sizes = rng.integers(1, c + 1, size=(t,)).astype(np.int32)
    sizes[0] = 0
    return [torch.from_numpy(a).to(device)
            for a in (res, books, sqn, codes, sizes)]


# Every instance of csrc/lut_build.cu's launcher: dsub 1, 2, 4, 8 (the
# codebook slice in registers), 16 (staged in shared memory), and the
# generic one (dsub 3, a CB that is not a multiple of 4, CB above 256), at
# CB 32 / 64 / 256 and T = 1.
@pytest.mark.parametrize("t,m,cb,dsub", [(7, 8, 64, 4), (32, 16, 256, 8),
                                         (130, 8, 256, 16), (9, 32, 32, 2),
                                         (8192, 16, 256, 8), (1, 16, 256, 8),
                                         (50, 4, 256, 1), (1, 8, 32, 1),
                                         (77, 16, 64, 2), (1, 4, 256, 4),
                                         (17, 4, 32, 16), (33, 6, 64, 3),
                                         (1, 8, 256, 3), (5, 3, 20, 8),
                                         (12, 2, 512, 8)])
def test_lut_kernels_match_plain(cuda, t, m, cb, dsub):
    r, b, s, _, _ = _mk(7, t, m, cb, 4, dsub, np.uint8, cuda)
    ops.reset_launches()
    got = ops.lut_build(r, b, s)
    gq = ops.lut_build_q(r, b, s)
    torch.cuda.synchronize()
    assert ops.launches["lut_build"] == 1 and ops.launches["lut_build_q"] == 1
    torch.testing.assert_close(got, ref.lut_build_ref(r.view(t, m, dsub), b,
                                                      s),
                               rtol=RTOL, atol=ATOL)
    hq = quantize_lut(got)          # the reference's contract: <= 1 count
    assert int((gq.lut_q.int() - hq.lut_q.int()).abs().max()) <= 1
    torch.testing.assert_close(gq.scale, hq.scale, rtol=1e-6, atol=0)
    torch.testing.assert_close(gq.bias, hq.bias, rtol=1e-6, atol=0)


@pytest.mark.parametrize("how", ["flat offset", "odd row"])
def test_lut_kernels_unaligned_residuals(cuda, how):
    """Residuals whose data_ptr is not 16-byte aligned (a flat offset of
    one float at dsub 8; row 1 of a (T, 10) tensor at dsub 2) give the
    same bits as an aligned copy, and match the oracle."""
    m, cb, dsub = (16, 256, 8) if how == "flat offset" else (5, 64, 2)
    t = 301
    rng = np.random.default_rng(13)
    flat = torch.from_numpy(rng.normal(size=t * m * dsub + m * dsub)
                            .astype(np.float32)).to(cuda)
    if how == "flat offset":
        r = flat[1:1 + t * m * dsub].view(t, m * dsub)
    else:
        r = flat.view(t + 1, m * dsub)[1:]
    assert r.is_contiguous() and r.data_ptr() % 16 != 0
    _, b, s, _, _ = _mk(14, 1, m, cb, 1, dsub, np.uint8, cuda)
    got, gq = ops.lut_build(r, b, s), ops.lut_build_q(r, b, s)
    aligned = r.clone()
    assert aligned.data_ptr() % 16 == 0
    torch.cuda.synchronize()
    assert torch.equal(got, ops.lut_build(aligned, b, s))
    for x, y in zip(gq, ops.lut_build_q(aligned, b, s)):
        assert torch.equal(x, y)
    torch.testing.assert_close(got, ref.lut_build_ref(r.view(t, m, dsub), b,
                                                      s),
                               rtol=RTOL, atol=ATOL)


def test_lut_build_q_equals_quantized_lut_build(cuda):
    """At the main path's shape B's u8 table, scale and bias equal
    quantize_lut of A's output bit for bit (both kernels compute the f32
    entry with one device function and divide in IEEE)."""
    r, b, s, _, _ = _mk(15, 8192, 16, 256, 1, 8, np.uint8, cuda)
    gq = ops.lut_build_q(r, b, s)
    hq = quantize_lut(ops.lut_build(r, b, s))
    torch.cuda.synchronize()
    assert torch.equal(gq.lut_q, hq.lut_q)
    assert torch.equal(gq.scale, hq.scale)
    assert torch.equal(gq.bias, hq.bias)


@pytest.mark.parametrize("t,m,cb,c", [(3, 8, 64, 300), (8, 16, 256, 512),
                                      (5, 8, 256, 1000), (2, 32, 32, 64),
                                      (1000, 16, 256, 1500)])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("quantized", [False, True])
def test_scan_kernels_match_plain(cuda, t, m, cb, c, code_dtype, quantized):
    r, b, s, codes, sizes = _mk(8, t, m, cb, c, 4, code_dtype, cuda)
    lut = ops.lut_build_q(r, b, s) if quantized else ops.lut_build(r, b, s)
    ops.reset_launches()
    got = ops.pq_scan_dc(lut, codes, sizes)
    full = ops.pq_scan_dc(lut, codes, None)
    torch.cuda.synchronize()
    assert ops.launches["pq_scan_dc_q" if quantized else "pq_scan_dc"] == 2
    plain = adc_distances_quantized if quantized else adc_distances
    torch.testing.assert_close(got, plain(lut, codes, sizes), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(full, plain(lut, codes, None), rtol=RTOL,
                               atol=ATOL)
    assert torch.isinf(got[0]).all()


def _topk_inputs(seed, t, c, code_dtype, quantized, device, m=16, cb=256):
    r, b, s, codes, sizes = _mk(seed, t, m, cb, c, 8, code_dtype, device)
    sizes = torch.minimum(sizes, torch.full_like(sizes, max(c - 1, 0)))
    sizes[-1] = min(c, 3)                       # fewer rows than k_pad
    sizes[0] = 0
    ids = torch.randperm(t * c, device=device).int().view(t, c)
    lut = ops.lut_build_q(r, b, s) if quantized else ops.lut_build(r, b, s)
    return lut, codes, ids, sizes


def _assert_topk_close(gd, gi, pd, pi, k):
    """Kernel (T, k) against the plain version's (T, k_pad) columns:
    distances allclose with equal +inf masks, ids -1 exactly at +inf, id
    sets equal per task apart from a tie at the k-th place."""
    gd, gi, pd, pi = (x.cpu().numpy() for x in (gd, gi, pd, pi))
    inf = np.isinf(pd[:, :k])
    np.testing.assert_array_equal(np.isinf(gd), inf)
    np.testing.assert_allclose(gd[~inf], pd[:, :k][~inf], rtol=RTOL,
                               atol=ATOL)
    assert (gi[inf] == -1).all() and (gi[~inf] >= 0).all()
    differ = np.nonzero((np.sort(gi, 1) != np.sort(pi[:, :k], 1)).any(1))[0]
    for t in differ:
        kth = pd[t, k - 1]
        assert k < pd.shape[1] and np.isclose(kth, pd[t, k], rtol=RTOL,
                                              atol=ATOL), t
        sure = {i for i, d in zip(pi[t, :k], pd[t, :k])
                if d < kth - (ATOL + RTOL * abs(kth))}
        assert sure <= set(gi[t].tolist()), t


@pytest.mark.parametrize("t,c", [(1, 1), (37, 1029), (300, 77),
                                 (5000, 2050)])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_scan_topk_kernels_match_plain(cuda, t, c, code_dtype,
                                             quantized, k):
    lut, codes, ids, sizes = _topk_inputs(10, t, c, code_dtype, quantized,
                                          cuda)
    name = "pq_scan_topk_q" if quantized else "pq_scan_topk"
    ops.reset_launches()
    gd, gi = ops.pq_scan_topk(lut, codes, ids, sizes, k)
    again = ops.pq_scan_topk(lut, codes, ids, sizes, k)
    torch.cuda.synchronize()
    assert ops.launches[name] == 2
    assert torch.equal(gd, again[0]) and torch.equal(gi, again[1])
    k_pad = max(8, 1 << (k - 1).bit_length())
    pd, pi = ops.pq_scan_topk_plain(lut, codes, ids, sizes, k_pad)
    _assert_topk_close(gd, gi, pd, pi, k)
    # the unfused DC kernel scores every row with the same float
    dc = ops.pq_scan_dc(lut, codes, sizes)
    want = torch.sort(dc, dim=1).values[:, :k]
    if want.shape[1] < k:
        want = torch.nn.functional.pad(want, (0, k - want.shape[1]),
                                       value=float("inf"))
    assert torch.equal(gd, want)


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_scan_topk_breaks_ties_by_row(cuda, quantized):
    """Every row of a task has the same codes, so the same distance: the
    winners are the first k valid rows, in row order, on every run."""
    lut, codes, ids, sizes = _topk_inputs(11, 64, 700, np.uint8, quantized,
                                          cuda)
    codes = codes[:, :1].expand_as(codes).contiguous()
    sizes[1:] = torch.arange(1, 64, device=cuda, dtype=torch.int32) * 11
    gd, gi = ops.pq_scan_topk(lut, codes, ids, sizes, 10)
    torch.cuda.synchronize()
    for t in range(1, 64):
        n = min(10, int(sizes[t]))
        assert torch.equal(gi[t, :n], ids[t, :n])
        assert bool((gd[t, :n] == gd[t, 0]).all())
        assert bool((gi[t, n:] == -1).all())


def _slot_topk_inputs(seed, p, t, c, code_dtype, quantized, device, m=16,
                      cb=256):
    """P code slots (ragged sizes, an empty one) and T tasks whose slots
    repeat and include -1 and (T > 4) one past the last slot."""
    g = torch.Generator(device=device).manual_seed(seed)
    lut, codes, ids, sizes = _topk_inputs(seed, p, c, code_dtype, quantized,
                                          device, m, cb)
    r = torch.randn(t, m * 8, device=device, generator=g)
    b = torch.randn(m, cb, 8, device=device, generator=g)
    lut = (ops.lut_build_q if quantized else ops.lut_build)(
        r, b, (b * b).sum(-1))
    slots = torch.randint(0, p, (t,), device=device, generator=g,
                          dtype=torch.int32)
    slots[0] = -1
    slots[1] = slots[2]
    slots[3] = 0                                   # slot 0 has no rows
    if t > 4:
        slots[4] = p                               # out of range: no task
    return lut, codes, ids, sizes, slots


def _lexsort_dc(lut, codes, ids, sizes, k_pad):
    """The k_pad first entries of a sort by (distance, row) of the DC
    kernel's output, ids looked up, (+inf, -1) past the valid rows."""
    dc = ops.pq_scan_dc(lut, codes, sizes)
    d, row = torch.sort(dc, dim=1, stable=True)
    d, row = d[:, :k_pad], row[:, :k_pad]
    i = torch.where(torch.isinf(d), -1, ids.gather(1, row))
    short = k_pad - d.shape[1]
    if short > 0:
        d = torch.nn.functional.pad(d, (0, short), value=float("inf"))
        i = torch.nn.functional.pad(i, (0, short), value=-1)
    return d, i


@pytest.mark.parametrize("p,t,c", [(5, 4, 700), (37, 300, 1029),
                                   (400, 20000, 300), (3000, 70000, 64)])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_scan_topk_slots_match_plain(cuda, p, t, c, code_dtype,
                                           quantized, k):
    """The slot form against its plain version (ties allowed) and, bit for
    bit, against the dense kernel on the gathered inputs; two launches
    are equal.  T runs from below the persistent grid to far above it."""
    lut, codes, ids, sizes, slots = _slot_topk_inputs(
        30, p, t, c, code_dtype, quantized, cuda)
    name = "pq_scan_topk_q" if quantized else "pq_scan_topk"
    ops.reset_launches()
    gd, gi = ops.pq_scan_topk(lut, codes, ids, sizes, k, slots=slots)
    again = ops.pq_scan_topk(lut, codes, ids, sizes, k, slots=slots)
    dense = ops.gather_slots(codes, ids, sizes, slots)
    dd, di = ops.pq_scan_topk(lut, *dense, k)
    torch.cuda.synchronize()
    assert ops.launches[name] == 3
    assert torch.equal(gd, again[0]) and torch.equal(gi, again[1])
    assert torch.equal(gd, dd) and torch.equal(gi, di)
    assert torch.isinf(gd[0]).all() and bool((gi[0] == -1).all())
    assert torch.isinf(gd[3]).all() and bool((gi[3] == -1).all())
    if t > 4:
        assert torch.isinf(gd[4]).all() and bool((gi[4] == -1).all())
    k_pad = max(8, 1 << (k - 1).bit_length())
    pd, pi = ops.pq_scan_topk_plain(lut, codes, ids, sizes, k_pad,
                                    slots=slots)
    _assert_topk_close(gd, gi, pd, pi, k)


@pytest.mark.parametrize("k_pad", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("quantized", [False, True])
def test_fused_scan_topk_equals_sorted_dc(cuda, k_pad, code_dtype,
                                          quantized):
    """Every k_pad from 8 to 256, both forms: the output is the (distance,
    row) sort of the DC kernel's (C's or D's) output, bit for bit."""
    lut, codes, ids, sizes, slots = _slot_topk_inputs(
        31, 300, 2000, 1100, code_dtype, quantized, cuda)
    dense = ops.gather_slots(codes, ids, sizes, slots)
    wd, wi = _lexsort_dc(lut, *dense, k_pad)
    for got in (ops.pq_scan_topk(lut, codes, ids, sizes, k_pad, slots=slots),
                ops.pq_scan_topk(lut, *dense, k_pad)):
        torch.cuda.synchronize()
        assert torch.equal(got[0], wd) and torch.equal(got[1], wi)


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_scan_topk_all_empty_tasks(cuda, quantized):
    """No task has rows (-1 slots, or dense sizes of 0): every output is
    (+inf, -1), and the launches count."""
    lut, codes, ids, sizes, slots = _slot_topk_inputs(
        32, 50, 5000, 300, np.uint8, quantized, cuda)
    name = "pq_scan_topk_q" if quantized else "pq_scan_topk"
    ops.reset_launches()
    outs = [ops.pq_scan_topk(lut, codes, ids, sizes, 10,
                             slots=torch.full_like(slots, -1)),
            ops.pq_scan_topk(lut, codes, ids, torch.zeros_like(sizes), 10,
                             slots=slots)]
    dense = ops.gather_slots(codes, ids, sizes, slots)
    outs.append(ops.pq_scan_topk(lut, dense[0], dense[1],
                                 torch.zeros_like(dense[2]), 10))
    torch.cuda.synchronize()
    assert ops.launches[name] == 3
    for d, i in outs:
        assert d.shape == (5000, 10) and torch.isinf(d).all()
        assert bool((i == -1).all())


def test_fused_scan_topk_refuses_large_k(cuda):
    lut, codes, ids, sizes = _topk_inputs(12, 4, 300, np.uint8, False, cuda)
    assert ops.pq_scan_topk(lut, codes, ids, sizes, ops.MAX_K_PAD)[0].shape \
        == (4, ops.MAX_K_PAD)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, codes, ids, sizes, ops.MAX_K_PAD + 1)


def test_kernels_refuse_cpu_mixed_inputs(cuda):
    r, b, s, codes, sizes = _mk(9, 4, 4, 16, 32, 2, np.uint8, cuda)
    with pytest.raises(ValueError):
        ops.lut_build(r, b.cpu(), s)
    lut = ops.lut_build(r, b, s)
    with pytest.raises(ValueError):
        ops.pq_scan_dc(lut, codes.cpu(), sizes)
    ids = torch.zeros(codes.shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, codes, ids, sizes, 4)


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_search_goes_through_kernels(cuda, lut_dtype):
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               k_gt=10, device=cuda)
    idx = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=64,
                      m=16, cb=256, kmeans_iters=6, pq_iters=6, device=cuda)
    cl = pad_clusters(idx)
    q = ds.queries.float()
    ops.reset_launches()
    kd, ki = search_ivfpq(idx, cl, q, SearchParams(
        nprobe=8, k=10, query_chunk=32, use_kernels=True,
        lut_dtype=lut_dtype))
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    assert ops.launches[lc] == 2 and ops.launches[dc] == 2
    pd, pi = search_ivfpq(idx, cl, q, SearchParams(
        nprobe=8, k=10, query_chunk=32, lut_dtype=lut_dtype))
    assert abs(recall_at_k(ki, ds.groundtruth)
               - recall_at_k(pi, ds.groundtruth)) <= 0.01
    if lut_dtype == "f32":
        torch.testing.assert_close(kd, pd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_sharded_search_goes_through_fused_kernels(cuda, lut_dtype):
    """DistributedEngine on the card launches LC and the fused DC+TS
    kernels from both steps; results equal the local kernel search (id
    sets, ties allowed) and cache on equals cache off bit for bit."""
    from repro_torch.core.sharded_search import DistributedEngine, EngineConfig
    from repro_torch.runtime import HotClusterLUTCache
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               k_gt=10, device=cuda)
    idx = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=64,
                      m=16, cb=256, kmeans_iters=6, pq_iters=6, device=cuda)
    cl = pad_clusters(idx)
    q = ds.queries.float()
    cfg = EngineConfig(n_shards=8, nprobe=8, k=10, tasks_per_shard=256,
                       split_max=64, dup_budget_bytes=1 << 17,
                       lut_dtype=lut_dtype)
    probes = cluster_locate(q, idx.centroids, 8)[0].cpu().numpy()
    eng = DistributedEngine(idx, cfg, probes)
    cache = HotClusterLUTCache(capacity=4096, lut_dtype=lut_dtype)
    cached = DistributedEngine(idx, cfg, probes, lut_cache=cache)
    ops.reset_launches()
    d, i, _ = eng.search(q)
    lc, fused = (("lut_build_q", "pq_scan_topk_q") if lut_dtype == "uint8"
                 else ("lut_build", "pq_scan_topk"))
    assert ops.launches[lc] >= 1 and ops.launches[fused] >= 1
    n = ops.launches[fused]
    for _ in range(2):                            # all misses, then all hits
        cd, ci, _ = cached.search(q)
        np.testing.assert_array_equal(cd, d)
        np.testing.assert_array_equal(ci, i)
    assert ops.launches[fused] > n and cache.stats.hits == 64 * 8
    ld, li = search_ivfpq(idx, cl, q, SearchParams(
        nprobe=8, k=11, use_kernels=True, lut_dtype=lut_dtype))
    ld, li = ld.cpu().numpy(), li.cpu().numpy()
    np.testing.assert_allclose(d, ld[:, :10], rtol=RTOL, atol=ATOL)
    for row in range(64):
        if set(i[row].tolist()) != set(li[row, :10].tolist()):
            assert np.isclose(ld[row, 9], ld[row, 10], rtol=RTOL, atol=ATOL)


def _service_index(cuda):
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               k_gt=10, device=cuda)
    idx = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=64,
                      m=16, cb=256, kmeans_iters=6, pq_iters=6, device=cuda)
    return idx, ds.queries.float().cpu().numpy()


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_local_cached_service_goes_through_kernels(cuda, lut_dtype):
    """A 2-replica local service with the LUT cache on the card: LC (A or
    B) and DC (C or D) launch; streamed results on both clocks equal the
    service's direct search, which equals search_ivfpq bit for bit."""
    from repro_torch.service import AnnService, ServiceSpec
    idx, q = _service_index(cuda)
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    d0, i0 = (x.cpu().numpy() for x in search_ivfpq(
        idx, pad_clusters(idx), torch.from_numpy(q).to(cuda),
        SearchParams(nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype)))
    stream = [(j * 5e-4, q[j % 16]) for j in range(48)]
    for clock in ("virtual", "wall"):
        svc = AnnService.build(ServiceSpec(
            engine="local", replicas=2, router="cache_aware", nprobe=8,
            k=10, lut_dtype=lut_dtype, cache_capacity_bytes=1 << 24,
            buckets=(1, 2, 4, 8)), index=idx)
        svc.warmup()
        ops.reset_launches()
        d, i = svc.search(q)
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(i, i0)
        reqs = svc.stream(stream, clock=clock)
        assert ops.launches[lc] > 0 and ops.launches[dc] > 0
        for j, r in enumerate(reqs):
            np.testing.assert_array_equal(r.dists, d0[j % 16])
            assert set(r.ids.tolist()) == set(i0[j % 16].tolist())
        assert svc.stats()["aggregate"]["lut_hit_rate"] > 0
        svc.shutdown()


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_sharded_service_goes_through_fused_kernels(cuda, lut_dtype):
    """A 2-replica sharded service on the card: LC (A or B) and the fused
    DC+TS kernel (E or F) launch; streamed results equal the service's
    direct search, whose id sets equal the local kernel search's."""
    from repro_torch.service import AnnService, ServiceSpec
    idx, q = _service_index(cuda)
    svc = AnnService.build(ServiceSpec(
        engine="sharded", replicas=2, router="least_queue", nprobe=8, k=10,
        n_shards=8, tasks_per_shard=256, split_max=64,
        dup_budget_bytes=1 << 17, lut_dtype=lut_dtype, buckets=(1, 2, 4, 8)),
        index=idx, sample_queries=q)
    svc.warmup()
    lc, fused = (("lut_build_q", "pq_scan_topk_q") if lut_dtype == "uint8"
                 else ("lut_build", "pq_scan_topk"))
    ops.reset_launches()
    d, i = svc.search(q)
    reqs = svc.stream([(j * 5e-4, q[j % 16]) for j in range(32)],
                      clock="wall")
    assert ops.launches[lc] > 0 and ops.launches[fused] > 0
    for j, r in enumerate(reqs):
        np.testing.assert_array_equal(r.dists, d[j % 16])
        assert set(r.ids.tolist()) == set(i[j % 16].tolist())
    if lut_dtype == "f32":
        ld, li = search_ivfpq(idx, pad_clusters(idx), torch.from_numpy(q).to(
            cuda), SearchParams(nprobe=8, k=11, use_kernels=True))
        ld, li = ld.cpu().numpy(), li.cpu().numpy()
        np.testing.assert_allclose(d, ld[:, :10], rtol=RTOL, atol=ATOL)
        for row in range(len(q)):
            if set(i[row].tolist()) != set(li[row, :10].tolist()):
                assert np.isclose(ld[row, 9], ld[row, 10], rtol=RTOL,
                                  atol=ATOL)
    svc.shutdown()


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_live_index_on_the_card(cuda, lut_dtype):
    """A mutable Index on the card: an edit never writes a published
    snapshot (it is copied first), each engine over the current snapshot
    launches LC and DC and equals search_ivfpq over it bit for bit, and a
    forced generation keeps deleted ids out."""
    from repro_torch.core.mutable_index import Index
    from repro_torch.runtime import LocalEngine
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               device=cuda)
    idx = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=64,
                      m=16, cb=256, kmeans_iters=6, pq_iters=6, device=cuda)
    h = Index(idx, points=ds.points, mutable=True)
    q = ds.queries.float().cpu().numpy()
    p = SearchParams(nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype)
    eng = LocalEngine(h.search_view, h.clusters, p)
    old = h.clusters
    kept = old.codes.clone(), old.ids.clone()
    vecs = ds.points[:256].float().cpu().numpy() + 1e-2
    h.upsert(np.arange(8000, 8256), vecs)
    h.delete(np.arange(0, 4000, 3))
    assert torch.equal(old.codes, kept[0]) and torch.equal(old.ids, kept[1])
    assert h.clusters.codes.data_ptr() != old.codes.data_ptr()
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    for step in ("mutated", "generation"):
        if step == "generation":
            h.run_maintenance(force=True)
            eng.install(index=h.search_view, clusters=h.clusters)
        else:
            eng.install(clusters=h.clusters)
        ops.reset_launches()
        d, i = eng.search_batch(np.concatenate([q, vecs[:64]]))
        assert ops.launches[lc] > 0 and ops.launches[dc] > 0
        wd, wi = search_ivfpq(h.search_view, h.clusters, torch.from_numpy(
            np.concatenate([q, vecs[:64]])).to(cuda), p)
        np.testing.assert_array_equal(d, wd.cpu().numpy())
        np.testing.assert_array_equal(i, wi.cpu().numpy())
        assert not np.isin(i, np.arange(0, 4000, 3)).any()
        assert np.mean([8000 + r in i[64 + r] for r in range(64)]) >= 0.9


def test_live_sharded_service_goes_through_fused_kernels(cuda):
    """A mutable sharded replica on the card: each mutation stages a new
    placement; the next batch installs it and launches LC and E."""
    from repro_torch.service import AnnService, ServiceSpec
    idx, q = _service_index(cuda)
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               device=cuda)
    svc = AnnService.build(ServiceSpec(
        engine="sharded", replicas=1, nprobe=8, k=10, n_shards=8,
        tasks_per_shard=256, split_max=64, mutable=True,
        buckets=(1, 2, 4, 8)), points=ds.points, index=idx,
        sample_queries=q)
    vecs = ds.points[:32].float().cpu().numpy() + 1e-2
    svc.upsert(np.arange(8000, 8032), vecs)
    svc.delete(np.arange(8000, 8016))
    svc.run_maintenance(force=True)
    ops.reset_launches()
    _, i = svc.search(vecs)
    assert ops.launches["lut_build"] > 0 and ops.launches["pq_scan_topk"] > 0
    assert not np.isin(i, np.arange(8000, 8016)).any()
    assert np.mean([8016 + r in i[16 + r] for r in range(16)]) >= 0.9
    assert svc.core_engine().serving_info()["generations"] >= 1
    svc.shutdown()


def test_tier_on_the_card_gathers_pad_clusters(cuda, tmp_path):
    """The slab lives on the card and cold rows come through the pinned
    staging buffer: every gather, at every residency, equals pad_clusters'
    rows; the CRC checks name a rotten cluster."""
    from repro_torch.storage import CorruptClusterError, TieredStore
    idx, _ = _service_index(cuda)
    cl = pad_clusters(idx)
    cids = np.random.default_rng(0).integers(0, idx.nlist, 500)
    want = [x[torch.from_numpy(cids).to(cuda)] for x in cl]
    for slots in (0, 9, 64):
        tier = TieredStore.from_index(idx, tmp_path / str(slots),
                                      budget_bytes=max(1, slots * cl.cmax
                                                       * 20),
                                      device=cuda)
        assert tier._hot_codes.device.type == "cuda"
        for _ in range(3):
            got = tier.gather(cids)
            assert all(g.device.type == "cuda" and torch.equal(g, w)
                       for g, w in zip(got, want))
            tier.observe(cids.reshape(-1, 10)[::-1])
        assert tier.resident_bytes <= tier.budget_bytes
    tier = TieredStore.from_index(idx, tmp_path / "rot", budget_bytes=1,
                                  device=cuda)
    tier.corrupt_spill(7)
    with pytest.raises(CorruptClusterError) as ei:
        tier.gather(np.array([3, 7]))
    assert ei.value.cluster == 7


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_tiered_engine_on_the_card(cuda, tmp_path, lut_dtype):
    """A tiered LocalEngine on the card equals search_ivfpq bit for bit at
    every residency and goes through the LC and DC kernels."""
    from repro_torch.runtime import LocalEngine
    from repro_torch.storage import TieredStore
    idx, q = _service_index(cuda)
    cl = pad_clusters(idx)
    p = SearchParams(nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype,
                     query_chunk=24)
    wd, wi = (x.cpu().numpy() for x in search_ivfpq(
        idx, cl, torch.from_numpy(q).to(cuda), p))
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    for slots in (0, 13, 64):
        tier = TieredStore.from_index(idx, tmp_path / str(slots),
                                      budget_bytes=max(1, slots * cl.cmax
                                                       * 20), device=cuda)
        eng = LocalEngine(idx, None, p, tiered_store=tier)
        for _ in range(3):
            ops.reset_launches()
            d, i = eng.search_batch(q)
            assert ops.launches[lc] > 0 and ops.launches[dc] > 0
            np.testing.assert_array_equal(d, wd)
            np.testing.assert_array_equal(i, wi)


def test_two_streams_share_one_slab(cuda, tmp_path):
    """Two threads, each on its own CUDA stream: one gathers while the
    other churns residency (slab slots rewritten).  The lock plus the
    stream synchronisation before it is released keep every gather equal
    to pad_clusters' rows."""
    import threading
    from repro_torch.storage import TieredStore
    idx, _ = _service_index(cuda)
    cl = pad_clusters(idx)
    tier = TieredStore.from_index(idx, tmp_path, budget_bytes=6 * cl.cmax
                                  * 20, device=cuda)
    cids = np.arange(idx.nlist)[::2]
    want = [x[torch.from_numpy(cids).to(cuda)] for x in cl]
    stop, bad = threading.Event(), []

    def churn():
        rng = np.random.default_rng(0)
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            while not stop.is_set():
                tier.observe(rng.integers(0, idx.nlist, (4, 8)))

    t = threading.Thread(target=churn)
    t.start()
    try:
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(200):
                got = tier.gather(cids)
                bad += [j for j, (g, w) in enumerate(zip(got, want))
                        if not torch.equal(g, w)]
    finally:
        stop.set()
        t.join()
    assert not bad and tier.stats.promotions > 0


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_tiered_sharded_cold_scan_goes_through_dense_fused(cuda, tmp_path,
                                                           lut_dtype):
    """The tiered sharded engine scans its cold probes with E/F in their
    dense form; results equal the tiered local engine's."""
    from repro_torch.core.sharded_search import (DistributedEngine,
                                                 EngineConfig, locate_probes)
    from repro_torch.runtime import LocalEngine
    from repro_torch.storage import TieredStore
    idx, q = _service_index(cuda)
    cl = pad_clusters(idx)
    budget = 16 * cl.cmax * 20
    eng = DistributedEngine(
        idx, EngineConfig(n_shards=8, nprobe=8, k=10, tasks_per_shard=256,
                          split_max=64, lut_dtype=lut_dtype),
        locate_probes(q, idx.centroids, 8),
        tiered_store=TieredStore.from_index(idx, tmp_path / "s",
                                            budget_bytes=budget,
                                            device=cuda))
    assert eng._cold_mask.any()
    fused = "pq_scan_topk_q" if lut_dtype == "uint8" else "pq_scan_topk"
    ops.reset_launches()
    d, i, _ = eng.search(q)
    assert ops.launches[fused] >= 2           # the shards' step + cold scan
    local = LocalEngine(idx, None, SearchParams(
        nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype),
        tiered_store=TieredStore.from_index(idx, tmp_path / "l",
                                            budget_bytes=budget,
                                            device=cuda))
    ld, li = local.search_batch(q)
    np.testing.assert_allclose(d, ld, rtol=RTOL, atol=ATOL)
    assert np.mean([set(a) == set(b) for a, b in zip(i, li)]) >= 0.95


def test_coarse2_on_the_card(cuda):
    """Two-level CL on the card: full fan-out probes flat CL's sets up to
    near-ties, and a query's probes do not depend on its batch."""
    from repro_torch.core.coarse2 import build_coarse2, coarse2_locate
    idx, q = _service_index(cuda)
    qt = torch.from_numpy(q).to(cuda)
    coarse = build_coarse2(torch.Generator().manual_seed(0), idx.centroids,
                           n_groups=8)
    flat, fd = cluster_locate(qt, idx.centroids, 8, block=256)
    two, td = coarse2_locate(coarse, qt, nprobe=8, nprobe1=8)
    differ = [r for r in range(len(q))
              if set(flat[r].tolist()) != set(two[r].tolist())]
    for r in differ:                         # only near-ties at the edge
        assert torch.isclose(fd[r, -1], td[r, -1], rtol=1e-5, atol=1e-2)
    for s in (0, 31):
        one, _ = coarse2_locate(coarse, qt[s:s + 1], nprobe=8, nprobe1=8)
        assert torch.equal(one[0], two[s])


def _tenant_meta(idx):
    """Tenants striped over 3, one tag column mod 5, clusters from the
    padded layout."""
    from repro_torch.core.filter import VectorMeta
    n = idx.ids.shape[0]
    meta = VectorMeta(tag_fields=2)
    meta.set(np.arange(n), tenant=(np.arange(n) % 3).astype(np.int32),
             tags=(np.arange(n) % 5).astype(np.uint32)[:, None])
    cl = pad_clusters(idx)
    meta.rebuild_clusters(cl.ids.cpu().numpy(), cl.sizes.cpu().numpy())
    return meta, cl


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_scoped_local_search_goes_through_kernels(cuda, lut_dtype):
    """Tenant-scoped search on the card: LC (A or B) and DC (C or D)
    launch and the fused kernels do not; no id leaves its tenant, every
    id carries the term, and each tenant's result equals search_ivfpq
    over its dedicated sub-index (ids up to ties at the k-th place)."""
    from repro_torch.core.filter import pad_terms, tenant_subindex
    from repro_torch.runtime import LocalEngine
    idx, q = _service_index(cuda)
    meta, cl = _tenant_meta(idx)
    p = SearchParams(nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype)
    eng = LocalEngine(idx, cl, p, meta=meta)
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    tenants = (np.arange(len(q)) % 3).astype(np.int32)
    ops.reset_launches()
    d, i = eng.search_batch(q, tenants=tenants)
    assert ops.launches[lc] > 0 and ops.launches[dc] > 0
    assert ops.launches["pq_scan_topk"] == ops.launches["pq_scan_topk_q"] == 0
    assert np.all(meta.tenant_of[i] == tenants[:, None])
    _, i_f = eng.search_batch(q, tenants=tenants,
                              terms=pad_terms([(2,)] * len(q), 2))
    assert np.all(meta.match_host(i_f[i_f >= 0], terms=(2,)))
    for tid in range(3):
        sub, members = tenant_subindex(idx, meta, tid)
        rows = tenants == tid
        sd, si = (x.cpu().numpy() for x in search_ivfpq(
            sub, pad_clusters(sub), torch.from_numpy(q[rows]).to(cuda),
            p._replace(nprobe=min(8, len(members)))))
        np.testing.assert_allclose(d[rows], sd, rtol=RTOL, atol=ATOL)
        assert np.mean([set(a) == set(b)
                        for a, b in zip(i[rows], si)]) >= 0.95


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_scoped_sharded_search_goes_through_kernels(cuda, lut_dtype):
    """The scoped sharded step runs LC and the DC kernels (not the fused
    ones, which cannot take the mask) and agrees with the scoped local
    engine."""
    from repro_torch.core.sharded_search import (DistributedEngine,
                                                 EngineConfig, locate_probes)
    from repro_torch.runtime import LocalEngine
    idx, q = _service_index(cuda)
    meta, cl = _tenant_meta(idx)
    eng = DistributedEngine(
        idx, EngineConfig(n_shards=8, nprobe=8, k=10, tasks_per_shard=256,
                          split_max=64, lut_dtype=lut_dtype),
        locate_probes(q, idx.centroids, 8), meta=meta)
    tenants = (np.arange(len(q)) % 3).astype(np.int32)
    ops.reset_launches()
    d, i, _ = eng.search(q, tenants=tenants)
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    assert ops.launches[lc] > 0 and ops.launches[dc] > 0
    assert ops.launches["pq_scan_topk"] == ops.launches["pq_scan_topk_q"] == 0
    local = LocalEngine(idx, cl, SearchParams(
        nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype), meta=meta)
    ld, li = local.search_batch(q, tenants=tenants)
    np.testing.assert_allclose(d, ld, rtol=RTOL, atol=ATOL)
    assert np.mean([set(a) == set(b) for a, b in zip(i, li)]) >= 0.95


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_armed_tier_on_the_card_drops_cold_rows(cuda, tmp_path, lut_dtype):
    """A tiered LocalEngine on the card with tier.cold_read firing on every
    gather: the batch is degraded, equals search_ivfpq over the clusters
    with the cold ones emptied, and the store leaves nothing in flight on
    the stream (after a degraded gather, and after a strict one raises)."""
    from repro_torch.core.ivf import PaddedClusters
    from repro_torch.runtime import (FaultInjector, FaultPlan, FaultRule,
                                     LocalEngine)
    from repro_torch.storage import TieredStore
    idx, q = _service_index(cuda)
    cl = pad_clusters(idx)
    tier = TieredStore.from_index(idx, tmp_path, budget_bytes=16 * cl.cmax
                                  * 20, device=cuda)
    tier.faults = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("tier.cold_read", rate=1.0),)))
    p = SearchParams(nprobe=8, k=10, use_kernels=True, lut_dtype=lut_dtype,
                     query_chunk=24)
    eng = LocalEngine(idx, None, p, tiered_store=tier)
    lc, dc = (("lut_build_q", "pq_scan_dc_q") if lut_dtype == "uint8"
              else ("lut_build", "pq_scan_dc"))
    ops.reset_launches()
    d, i = eng.search_batch(q)
    assert eng.last_batch_info["degraded"]
    assert ops.launches[lc] > 0 and ops.launches[dc] > 0
    cold = torch.from_numpy(~tier.resident_mask).to(cuda)
    emptied = PaddedClusters(cl.codes, cl.ids,
                             torch.where(cold, 0, cl.sizes))
    wd, wi = (x.cpu().numpy() for x in search_ivfpq(
        idx, emptied, torch.from_numpy(q).to(cuda), p))
    np.testing.assert_array_equal(d, wd)
    np.testing.assert_array_equal(i, wi)
    stream = torch.cuda.current_stream(cuda)
    cids = np.arange(idx.nlist)
    codes, ids, sizes, dropped = tier.gather_degraded(cids)
    assert stream.query()                    # nothing left in flight
    assert dropped.tolist() == (~tier.resident_mask).tolist()
    rows = torch.from_numpy(dropped).to(cuda)
    assert int(codes[rows].sum()) == 0 and bool((ids[rows] == -1).all())
    assert int(sizes[rows].sum()) == 0
    assert torch.equal(codes[~rows], cl.codes[~rows])
    with pytest.raises(IOError, match="tier.cold_read"):
        tier.gather(cids)
    assert stream.query()


def test_engine_sites_fail_over_between_executors(cuda):
    """engine.batch fires on replica 0 only and stragglers on both: every
    request is answered by replica 1's executor on the card, bit for bit
    the unarmed service's answer, through the LC and DC kernels."""
    from repro_torch.runtime import FaultInjector, FaultPlan, FaultRule
    from repro_torch.service import AnnService, ServiceSpec
    idx, q = _service_index(cuda)
    spec = ServiceSpec(engine="local", replicas=2, nprobe=8, k=10,
                       buckets=(1, 2, 4, 8), max_wait_s=1e-3, max_retries=2,
                       backoff_base_ms=0.0, breaker_threshold=100)
    plain = AnnService.build(spec, index=idx)
    wd, wi = plain.search(q)
    plain.shutdown()
    inj = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("engine.batch", replicas=(0,)),
        FaultRule("engine.straggler", rate=0.5, delay_s=2e-3))))
    svc = AnnService.build(spec, index=idx, fault_injector=inj)
    svc.warmup()
    ops.reset_launches()
    futs = [svc.submit_async(q[j]) for j in range(len(q))]
    for j, f in enumerate(futs):
        d, i = f.result(timeout=60.0)
        np.testing.assert_array_equal(d, wd[j])
        np.testing.assert_array_equal(i, wi[j])
        assert f.timing()["replica"] == 1
    assert ops.launches["lut_build"] > 0 and ops.launches["pq_scan_dc"] > 0
    st = svc.stats()["faults"]
    assert st["engine.batch"]["fires"] > 0
    assert st["engine.straggler"]["fires"] > 0
    svc.shutdown()


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_measure_spec_on_the_card_equals_the_cpu(cuda, monkeypatch,
                                                 lut_dtype):
    """The tuner's measurement of one candidate over one index, on the
    card and on the CPU: the PIM-paced p50 / p99 / QPS are equal (a host
    clock that moves only when slept, so each batch is charged its
    modeled time) and recall agrees up to k-th-place ties."""
    from repro_torch.convert import index_from_numpy
    from repro_torch.core.autotune import Candidate, candidate_spec, \
        measure_spec
    from repro_torch.core.mutable_index import Index
    from repro_torch.runtime import serving as serving_mod

    class FakeTime:
        t = 0.0

        def perf_counter(self):
            return self.t

        monotonic = perf_counter

        def sleep(self, s):
            self.t += max(float(s), 0.0)

    ds = make_clustered_corpus(0, 3000, 16, n_queries=48, n_components=12,
                               k_gt=10, device="cpu")
    cpu = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=16,
                      m=8, cb=256, kmeans_iters=8, pq_iters=8, device="cpu")
    on_card = index_from_numpy(cpu.centroids, cpu.codebook.codebooks,
                               cpu.codebook.sqnorms, cpu.codes, cpu.ids,
                               cpu.offsets, device=cuda)
    spec = candidate_spec(Candidate(8, 4, lut_dtype, (1, 2, 4, 8), 1024,
                                    1 << 19), nlist=16)
    q = ds.queries.float().numpy()
    gt = ds.groundtruth.numpy()
    out = {}
    for name, index in (("cpu", cpu), ("cuda", on_card)):
        monkeypatch.setattr(serving_mod, "time", FakeTime())
        ops.reset_launches()
        out[name] = measure_spec(spec, Index(index), q, gt, k=10,
                                 n_requests=48, qps=4000.0, skew=1.2,
                                 seed=1)
        if name == "cuda":
            lc = "lut_build_q" if lut_dtype == "uint8" else "lut_build"
            assert ops.launches[lc] > 0
    for key in ("p50_ms", "p99_ms", "qps"):
        assert out["cuda"][key] == out["cpu"][key], key
    assert abs(out["cuda"]["recall"] - out["cpu"]["recall"]) <= \
        (1.0 if lut_dtype == "f32" else 4.0) / (len(q) * 10) + 1e-12
