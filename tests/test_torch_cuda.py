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


@pytest.mark.parametrize("p,t,c", [(5, 4, 700), (37, 300, 1029),
                                   (400, 20000, 300), (96, 2000, 6200)])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("kind", ["f32", "u8", "bf16"])
def test_scan_kernels_slots_equal_dense(cuda, p, t, c, code_dtype, kind):
    """C, D and C-bf16 by slot (task t reads code slot slots[t] in place)
    against the dense kernel on ``gather_slots``' copy, bit for bit:
    repeated, -1 and out-of-range slots and an empty one; C = 6,200 rows
    a task, as in the benchmark's cells.  At M = 16 u8 codes both forms
    take the 16-byte row loads."""
    g = torch.Generator(device=cuda).manual_seed(40)
    _, _, _, codes, sizes = _mk(40, p, 16, 256, c, 8, code_dtype, cuda)
    r = torch.randn(t, 16 * 8, device=cuda, generator=g)
    b = torch.randn(16, 256, 8, device=cuda, generator=g)
    build = {"f32": ops.lut_build, "u8": ops.lut_build_q,
             "bf16": ops.lut_build_bf16}[kind]
    lut = build(r, b, (b * b).sum(-1))
    slots = torch.randint(0, p, (t,), device=cuda, generator=g,
                          dtype=torch.int32)
    slots[0] = -1
    slots[1] = slots[2]
    slots[3] = 0                                   # slot 0 has no rows
    slots[-1] = p                                  # out of range: no task
    name = "pq_scan_dc" + ops.KIND_SUFFIX[kind]
    ops.reset_launches()
    got = ops.pq_scan_dc(lut, codes, sizes, slots=slots)
    dense = ops.gather_slots(codes, None, sizes, slots)
    want = ops.pq_scan_dc(lut, dense[0], dense[2])
    torch.cuda.synchronize()
    assert ops.launches[name] == 2
    assert torch.equal(got, want)
    for task in (0, 3, t - 1):
        assert torch.isinf(got[task]).all()


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


# ---------------------------------------------------------------------------
# TS by slot: ops.ts_topk
# ---------------------------------------------------------------------------

def _ts_inputs(seed, qc, p, c, nslots, device, sizes="uniform",
               ties=False):
    """(dists, slots, sizes, ids) as DC by slot leaves them: real rows
    random (``ties``: rounded to 1/4, so many are equal), +inf past each
    task's size and in every task of a slot outside [0, nslots) (one task
    in 7 at -1, one in 11 past the end).  ``sizes``: "uniform" in [0, C],
    "lognormal" (the benchmark's spread 0.337, mean C / 4) or "empty"."""
    g = torch.Generator(device=device).manual_seed(seed)
    if sizes == "lognormal":
        z = torch.randn(nslots, device=device, generator=g)
        sz = (torch.exp(0.337 * z) * (c / 4)).clamp(max=c).int()
    elif sizes == "empty":
        sz = torch.zeros(nslots, dtype=torch.int32, device=device)
    else:
        sz = torch.randint(0, c + 1, (nslots,), device=device, generator=g,
                           dtype=torch.int32)
    row = torch.arange(c, device=device)
    ids = (torch.arange(nslots, device=device)[:, None] * c + row).int()
    ids = ids.masked_fill(row[None, :] >= sz[:, None], -1)
    slots = torch.randint(0, nslots, (qc * p,), device=device, generator=g,
                          dtype=torch.int32)
    slots[::7] = -1
    slots[3::11] = nslots + 2
    valid = (slots >= 0) & (slots < nslots)
    n = torch.where(valid, sz[slots.long().clamp(0, nslots - 1)], 0)
    dists = torch.rand((qc * p, c), device=device, generator=g) * 100
    if ties:
        dists = torch.round(dists * 4) / 4
    dists.masked_fill_(row[None, :] >= n[:, None], float("inf"))
    return dists, slots, sz, ids


def _ts_by_position(dists, slots, ids, qc, k):
    """The exact answer: each query's rows sorted stably (ties by the
    lower position probe * C + row), the first k with their ids; a padded
    row's id is -1, as is every row of a slot outside [0, nslots)."""
    nslots, c = ids.shape
    d, pos = torch.sort(dists.reshape(qc, -1), dim=-1, stable=True)
    d, pos = d[:, :k], pos[:, :k]
    s = slots.long().reshape(qc, -1).gather(1, pos // c)
    valid = (s >= 0) & (s < nslots)
    i = torch.take(ids, torch.where(valid, s, 0) * c + pos % c)
    return d, i.masked_fill(~valid, -1)


def _assert_ts_equal_up_to_ties(got, want):
    """Distances bit for bit; ids equal within each group of equal
    distances, except the k-th distance's group, which may hold any of
    its rows (torch.topk fixes no order among ties)."""
    gd, gi = (x.cpu().numpy() for x in got)
    wd, wi = (x.cpu().numpy() for x in want)
    np.testing.assert_array_equal(gd, wd)
    for q in range(gd.shape[0]):
        for v in np.unique(wd[q]):
            same = wd[q] == v
            if v != wd[q, -1] or not np.isfinite(v):
                assert sorted(gi[q, same]) == sorted(wi[q, same]), q


@pytest.mark.parametrize("shape", ["main", "ragged", "empty"])
@pytest.mark.parametrize("k", [1, 10, 256])
def test_ts_topk_matches_plain(cuda, shape, k):
    """The main path's chunk (256 queries x 96 probes of C = 6,200 rows,
    log-normal sizes over 65,536 slots), a C that is no multiple of a
    block width or of 4 (unaligned rows), and no real row at all: the
    kernel == the stable sort by position bit for bit, and == the plain
    route (torch.topk) up to tie order."""
    qc, p, c, nslots, sizes = {
        "main": (256, 96, 6200, 65536, "lognormal"),
        "ragged": (7, 5, 1029, 13, "uniform"),
        "empty": (9, 4, 300, 5, "empty")}[shape]
    dists, slots, sz, ids = _ts_inputs(50, qc, p, c, nslots, cuda, sizes)
    ops.reset_launches()
    got = ops.ts_topk(dists, slots, sz, ids, qc, k)
    torch.cuda.synchronize()
    assert ops.launches["ts_topk"] == 1
    assert got[0].shape == got[1].shape == (qc, k)
    assert got[1].dtype == torch.int32
    exact = _ts_by_position(dists, slots, ids, qc, k)
    assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])
    _assert_ts_equal_up_to_ties(got, ops.ts_topk_plain(dists, slots, ids,
                                                       qc, k))
    if shape == "empty":
        assert bool(torch.isinf(got[0]).all()) and bool((got[1] == -1).all())


@pytest.mark.parametrize("k", [1, 10, 100])
def test_ts_topk_breaks_ties_by_position(cuda, k):
    """Distances on a grid of 1/4 over [0, 100], so every winner has many
    equals: the kernel takes the lower probe * C + row first, run after
    run."""
    dists, slots, sz, ids = _ts_inputs(51, 33, 40, 777, 50, cuda,
                                       ties=True)
    exact = _ts_by_position(dists, slots, ids, 33, k)
    for _ in range(3):
        got = ops.ts_topk(dists, slots, sz, ids, 33, k)
        assert torch.equal(got[0], exact[0])
        assert torch.equal(got[1], exact[1])


@pytest.mark.parametrize("k", [10, 256])
def test_ts_topk_never_reads_padding(cuda, k):
    """Every padded entry (rows past a task's size, every row of a slot
    outside [0, nslots)) poisoned with -1.0, below any real distance: the
    answers are those on DC's +inf padding."""
    qc, p, c, nslots = 64, 96, 2000, 4096
    dists, slots, sz, ids = _ts_inputs(52, qc, p, c, nslots, cuda,
                                       "lognormal")
    want = ops.ts_topk(dists, slots, sz, ids, qc, k)
    poisoned = dists.masked_fill(torch.isinf(dists), -1.0)
    got = ops.ts_topk(poisoned, slots, sz, ids, qc, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], _ts_by_position(dists, slots, ids, qc, k)[0])


def test_ts_topk_refuses(cuda):
    dists, slots, sz, ids = _ts_inputs(53, 4, 6, 50, 9, cuda)
    assert ops.ts_topk(dists, slots, sz, ids, 4, ops.MAX_K_PAD)[0].shape \
        == (4, ops.MAX_K_PAD)
    for bad in ((dists, slots, sz, ids.cpu(), 4, 10),
                (dists, slots.long(), sz, ids, 4, 10),
                (dists, slots, sz, ids, 4, ops.MAX_K_PAD + 1),
                (torch.cat([dists, dists], 1)[:, ::2], slots, sz, ids, 4,
                 10)):
        with pytest.raises((TypeError, ValueError)):
            ops.ts_topk(*bad)


# ---------------------------------------------------------------------------
# The bf16-table kernels: A-bf16, C-bf16, E-bf16
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8           # one bf16 ulp, relative


def _assert_bf16_close(got, want, min_equal=0.99):
    """Within one bf16 ulp with equal +inf masks, at least ``min_equal``
    of the finite values bit-equal."""
    got, want = got.cpu(), want.cpu()
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    g, w = got[~inf], want[~inf]
    assert bool(((g - w).abs() <= BF16_ULP * w.abs()).all())
    if g.numel():
        assert float((g == w).float().mean()) >= min_equal


def _bf16_ulps(x):
    """The bf16 ulp of each finite value: 2^(e - 7) for |x| in [2^e,
    2^(e+1)), i.e. 2^-7 to 2^-8 of it."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def _assert_within_a_bf16_ulp(got, want):
    """Each finite value within one bf16 ulp of ``want``'s, equal +inf
    masks: two different f32 LC computations (the card's and the CPU's),
    each rounded to bf16, may land a table entry, and so a row's sum, on
    neighbouring bf16 values."""
    got, want = got.cpu(), want.cpu()
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    g, w = got[~inf], want[~inf]
    assert bool(((g - w).abs() <= _bf16_ulps(w)).all())


def _assert_topk_bf16(gd, gi, pd, pi, k, same_table=True):
    """Kernel (T, k) against the plain version's (T, k_pad): distances by
    the bf16 rule (``same_table``) or within one bf16 ulp (tables from
    two LC computations), ids -1 exactly at +inf, and each task's ids two
    ulps below its k-th distance present in the kernel's set."""
    if same_table:
        _assert_bf16_close(gd, pd[:, :k])
    else:
        _assert_within_a_bf16_ulp(gd, pd[:, :k])
    kth = pd[:, k - 1].cpu()
    thr = (kth - 2 * _bf16_ulps(kth)).numpy()
    gd, gi, pd, pi = (x.cpu().numpy() for x in (gd, gi, pd, pi))
    inf = np.isinf(gd)
    assert (gi[inf] == -1).all() and (gi[~inf] >= 0).all()
    for t in range(gd.shape[0]):
        sure = set(pi[t, :k][pd[t, :k] < thr[t]].tolist())
        assert sure <= set(gi[t].tolist()), t


@pytest.mark.parametrize("t,m,cb,dsub", [(7, 8, 64, 4), (32, 16, 256, 8),
                                         (130, 8, 256, 16), (9, 32, 32, 2),
                                         (8192, 16, 256, 8), (1, 16, 256, 8),
                                         (50, 4, 256, 1), (33, 6, 64, 3),
                                         (5, 3, 20, 8), (12, 2, 512, 8)])
def test_lut_build_bf16_equals_cast_of_a(cuda, t, m, cb, dsub):
    """A-bf16 at every instance of the launcher (dsub 1-16 compiled, the
    generic one at dsub 3, CB 20, CB 512) is A's table rounded to bf16,
    bit for bit, and within one bf16 ulp of the oracle's."""
    r, b, s, _, _ = _mk(7, t, m, cb, 4, dsub, np.uint8, cuda)
    ops.reset_launches()
    got = ops.lut_build_bf16(r, b, s)
    a = ops.lut_build(r, b, s)
    torch.cuda.synchronize()
    assert ops.launches["lut_build_bf16"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (t, m, cb)
    assert torch.equal(got, a.to(torch.bfloat16))
    # A's tolerance against the oracle, widened by the bf16 rounding
    torch.testing.assert_close(got.float(),
                               ref.lut_build_ref(r.view(t, m, dsub), b, s),
                               rtol=BF16_ULP, atol=ATOL)


def test_lut_build_bf16_unaligned_residuals(cuda):
    """Residuals off a 16-byte boundary give the aligned copy's bits."""
    m, cb, dsub, t = 16, 256, 8, 301
    rng = np.random.default_rng(13)
    flat = torch.from_numpy(rng.normal(size=t * m * dsub + 1)
                            .astype(np.float32)).to(cuda)
    r = flat[1:].view(t, m * dsub)
    assert r.data_ptr() % 16 != 0
    _, b, s, _, _ = _mk(14, 1, m, cb, 1, dsub, np.uint8, cuda)
    got = ops.lut_build_bf16(r, b, s)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.lut_build_bf16(r.clone(), b, s))
    assert torch.equal(got, ops.lut_build(r, b, s).to(torch.bfloat16))


@pytest.mark.parametrize("t,m,cb,c", [(3, 8, 64, 300), (8, 16, 256, 512),
                                      (5, 8, 256, 1000), (2, 32, 32, 64),
                                      (1000, 16, 256, 1500)])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
def test_scan_bf16_matches_plain(cuda, t, m, cb, c, code_dtype):
    """C-bf16 against its plain version (``adc_distances`` on the bf16
    table), with and without sizes; its values are bf16 ones."""
    r, b, s, codes, sizes = _mk(8, t, m, cb, c, 4, code_dtype, cuda)
    lut = ops.lut_build_bf16(r, b, s)
    ops.reset_launches()
    got = ops.pq_scan_dc(lut, codes, sizes)
    full = ops.pq_scan_dc(lut, codes, None)
    torch.cuda.synchronize()
    assert ops.launches["pq_scan_dc_bf16"] == 2
    assert ops.launches["pq_scan_dc"] == 0
    _assert_bf16_close(got, adc_distances(lut, codes, sizes))
    _assert_bf16_close(full, adc_distances(lut, codes, None))
    assert torch.isinf(got[0]).all()
    assert torch.equal(full.to(torch.bfloat16).float(), full)


@pytest.mark.parametrize("t,c", [(1, 1), (37, 1029), (300, 77),
                                 (5000, 2050)])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_scan_topk_bf16_matches_plain(cuda, t, c, code_dtype, k):
    """E-bf16, dense, against its plain version (C < k_pad, an empty task
    and a task with fewer rows than k_pad included), and equal to the
    sort of C-bf16's output."""
    r, b, s, codes, sizes = _mk(10, t, 16, 256, c, 8, code_dtype, cuda)
    sizes = torch.minimum(sizes, torch.full_like(sizes, max(c - 1, 0)))
    sizes[-1] = min(c, 3)
    sizes[0] = 0
    ids = torch.randperm(t * c, device=cuda).int().view(t, c)
    lut = ops.lut_build_bf16(r, b, s)
    ops.reset_launches()
    gd, gi = ops.pq_scan_topk(lut, codes, ids, sizes, k)
    again = ops.pq_scan_topk(lut, codes, ids, sizes, k)
    torch.cuda.synchronize()
    assert ops.launches["pq_scan_topk_bf16"] == 2
    assert ops.launches["pq_scan_topk"] == 0
    assert torch.equal(gd, again[0]) and torch.equal(gi, again[1])
    k_pad = max(8, 1 << (k - 1).bit_length())
    pd, pi = ops.pq_scan_topk_plain(lut, codes, ids, sizes, k_pad)
    _assert_topk_bf16(gd, gi, pd, pi, k)
    assert torch.isinf(gd[0]).all() and bool((gi[0] == -1).all())
    wd, wi = _lexsort_dc(lut, codes, ids, sizes, k_pad)
    assert torch.equal(gd, wd[:, :k]) and torch.equal(gi, wi[:, :k])


@pytest.mark.parametrize("p,t,c", [(5, 4, 700), (37, 300, 1029),
                                   (400, 20000, 300), (3000, 70000, 64)])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_scan_topk_bf16_slots_match_plain(cuda, p, t, c, k):
    """E-bf16 by slot: against its plain version, against the dense launch
    on the gathered inputs and the sort of C-bf16's output bit for bit;
    -1, out-of-range and empty slots give (+inf, -1)."""
    g = torch.Generator(device=cuda).manual_seed(30)
    _, codes, ids, sizes, slots = _slot_topk_inputs(30, p, t, c, np.uint8,
                                                    False, cuda)
    res = torch.randn(t, 16 * 8, device=cuda, generator=g)
    books = torch.randn(16, 256, 8, device=cuda, generator=g)
    lut = ops.lut_build_bf16(res, books, (books * books).sum(-1))
    ops.reset_launches()
    gd, gi = ops.pq_scan_topk(lut, codes, ids, sizes, k, slots=slots)
    dense = ops.gather_slots(codes, ids, sizes, slots)
    dd, di = ops.pq_scan_topk(lut, *dense, k)
    torch.cuda.synchronize()
    assert ops.launches["pq_scan_topk_bf16"] == 2
    assert torch.equal(gd, dd) and torch.equal(gi, di)
    for row in (0, 3) + ((4,) if t > 4 else ()):
        assert torch.isinf(gd[row]).all() and bool((gi[row] == -1).all())
    k_pad = max(8, 1 << (k - 1).bit_length())
    pd, pi = ops.pq_scan_topk_plain(lut, codes, ids, sizes, k_pad,
                                    slots=slots)
    _assert_topk_bf16(gd, gi, pd, pi, k)
    wd, wi = _lexsort_dc(lut, *dense, k_pad)
    assert torch.equal(gd, wd[:, :k]) and torch.equal(gi, wi[:, :k])


def test_fused_scan_topk_bf16_all_empty_and_ties(cuda):
    """No task with rows gives (+inf, -1) everywhere; equal rows break
    ties by row."""
    r, b, s, codes, sizes = _mk(11, 64, 16, 256, 700, 8, np.uint8, cuda)
    lut = ops.lut_build_bf16(r, b, s)
    ids = torch.randperm(64 * 700, device=cuda).int().view(64, 700)
    d, i = ops.pq_scan_topk(lut, codes, ids, torch.zeros_like(sizes), 10)
    assert torch.isinf(d).all() and bool((i == -1).all())
    same = codes[:, :1].expand_as(codes).contiguous()
    sizes[1:] = torch.arange(1, 64, device=cuda, dtype=torch.int32) * 11
    gd, gi = ops.pq_scan_topk(lut, same, ids, sizes, 10)
    torch.cuda.synchronize()
    for t in range(1, 64):
        n = min(10, int(sizes[t]))
        assert torch.equal(gi[t, :n], ids[t, :n])
        assert bool((gi[t, n:] == -1).all())


def _plain_by_row(lut, codes, ids, sizes, k_pad, slots=None):
    """The plain version with ties broken by row: the plain DC
    (``adc_distances``) on the (gathered) inputs, a stable sort by
    distance, ids looked up, (+inf, -1) past the valid rows."""
    if slots is not None:
        codes, ids, sizes = ops.gather_slots(codes, ids, sizes, slots)
    d, row = torch.sort(adc_distances(lut, codes, sizes), dim=1, stable=True)
    d, row = d[:, :k_pad], row[:, :k_pad]
    i = torch.where(torch.isinf(d), -1, ids.gather(1, row))
    short = k_pad - d.shape[1]
    if short > 0:
        d = torch.nn.functional.pad(d, (0, short), value=float("inf"))
        i = torch.nn.functional.pad(i, (0, short), value=-1)
    return d, i


def _assert_bf16_topk_exact(lut, codes, ids, sizes, k_pad, slots=None):
    """E-bf16 (dense, or by slot and dense on the gathered inputs) ==
    the plain version bit for bit: its distances are the plain top-k's,
    and distances and ids those of the plain DC sorted by (distance, row)
    and of C-bf16's output sorted the same way."""
    got = [ops.pq_scan_topk(lut, codes, ids, sizes, k_pad, slots=slots)]
    if slots is not None:
        got.append(ops.pq_scan_topk(
            lut, *ops.gather_slots(codes, ids, sizes, slots), k_pad))
    pd, _ = ops.pq_scan_topk_plain(lut, codes, ids, sizes, k_pad,
                                   slots=slots)
    wd, wi = _plain_by_row(lut, codes, ids, sizes, k_pad, slots)
    dense = (codes, ids, sizes) if slots is None else ops.gather_slots(
        codes, ids, sizes, slots)
    sd, si = _lexsort_dc(lut, *dense, k_pad)
    torch.cuda.synchronize()
    for gd, gi in got:
        assert torch.equal(gd, pd) and torch.equal(gd, wd)
        assert torch.equal(gi, wi)
        assert torch.equal(gd, sd) and torch.equal(gi, si)


@pytest.mark.parametrize("k_pad", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("form", ["dense", "slots"])
def test_fused_scan_topk_bf16_equals_plain_every_k_pad(cuda, k_pad, form):
    """E-bf16 with 32-bit keys, every k_pad from 8 to 256, dense and by
    slot: bit-equal to the plain version (ties by row) and to the sorted
    C-bf16 output, as test_fused_scan_topk_equals_sorted_dc holds E."""
    _, codes, ids, sizes, slots = _slot_topk_inputs(31, 300, 2000, 1100,
                                                    np.uint8, False, cuda)
    g = torch.Generator(device=cuda).manual_seed(31)
    res = torch.randn(2000, 16 * 8, device=cuda, generator=g)
    books = torch.randn(16, 256, 8, device=cuda, generator=g)
    lut = ops.lut_build_bf16(res, books, (books * books).sum(-1))
    assert ops.pq_scan_topk_instance(lut, codes)["key_bits"] == 32
    if form == "dense":
        codes, ids, sizes = ops.gather_slots(codes, ids, sizes, slots)
        slots = None
    ops.reset_launches()
    _assert_bf16_topk_exact(lut, codes, ids, sizes, k_pad, slots)
    assert ops.launches["pq_scan_topk_bf16"] == (1 if form == "dense" else 2)


@pytest.mark.parametrize("case", ["c-below-k-pad", "empty-tasks",
                                  "all-equal"])
@pytest.mark.parametrize("k_pad", [16, 256])
def test_fused_scan_topk_bf16_edges(cuda, case, k_pad):
    """E-bf16 bit-equal to the plain version where C < k_pad (C = 5), where
    every other task is empty (size 0, dense; slot -1, by slot), and where
    every row of a task has the same distance (ties broken by row)."""
    c = 5 if case == "c-below-k-pad" else 700
    r, b, s, codes, sizes = _mk(12, 64, 16, 256, c, 8, np.uint8, cuda)
    sizes[1:] = torch.randint(1, c + 1, (63,), device=cuda,
                              dtype=torch.int32)
    ids = torch.randperm(64 * c, device=cuda).int().view(64, c)
    lut = ops.lut_build_bf16(r, b, s)
    slots = torch.arange(64, device=cuda, dtype=torch.int32)
    if case == "empty-tasks":
        sizes[::2] = 0
        slots[1::4] = -1
    elif case == "all-equal":
        codes = codes[:, :1].expand_as(codes).contiguous()
    _assert_bf16_topk_exact(lut, codes, ids, sizes, k_pad)
    _assert_bf16_topk_exact(lut, codes, ids, sizes, k_pad, slots)
    if case == "all-equal":
        d, i = ops.pq_scan_topk(lut, codes, ids, sizes, k_pad)
        for t in range(64):
            n = min(k_pad, int(sizes[t]))
            assert torch.equal(i[t, :n], ids[t, :n])
            assert bool((d[t, :n] == d[t, 0]).all())


@pytest.mark.parametrize("c,key_bits", [(65535, 32), (65536, 64)])
@pytest.mark.parametrize("k_pad", [16, 128])
def test_fused_scan_topk_bf16_key_limit(cuda, c, key_bits, k_pad):
    """C on either side of the 32-bit keys' limit: 65,535 rows a slot take
    the 32-bit instance, 65,536 the 64-bit one; both bit-equal to the
    plain version, with the best rows (tied) the last ones of a slot, so
    rows up to C - 1 win and break their ties by row."""
    t, m = 3, 16
    r, b, s, codes, sizes = _mk(13, t, m, 256, c, 8, np.uint8, cuda)
    sizes[:] = c
    sizes[1] = c - 7
    lut = ops.lut_build_bf16(r, b, s)
    best = lut.float().argmin(dim=2).to(torch.uint8)          # (T, M)
    codes[:, -(k_pad + 40):] = best[:, None, :]
    ids = torch.randperm(t * c, device=cuda).int().view(t, c)
    inst = ops.pq_scan_topk_instance(lut, codes)
    assert inst["key_bits"] == key_bits
    assert inst["entry"] == ("pq_scan_topk_bf16" if key_bits == 32
                             else "pq_scan_topk_bf16_wide")
    slots = torch.tensor([2, 0, -1, 1], device=cuda, dtype=torch.int32)
    ops.reset_launches()
    _assert_bf16_topk_exact(lut, codes, ids, sizes, k_pad)
    lut4 = torch.cat([lut, lut[:1]])
    _assert_bf16_topk_exact(lut4, codes, ids, sizes, k_pad, slots)
    assert ops.launches["pq_scan_topk_bf16"] == 3
    d, i = ops.pq_scan_topk(lut, codes, ids, sizes, k_pad)
    assert int(i[0, 0]) == int(ids[0, c - k_pad - 40])


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
    assert ops.launches["ts_topk"] == 2            # one a chunk
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


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_mesh_engine_on_one_card_equals_flat(cuda, monkeypatch, lut_dtype):
    """DistributedEngine(mesh=) with 8 entries on one card: each entry's
    program runs on its own stream, LC and the fused DC+TS launch once per
    entry and step, and the results equal the flat engine's bit for bit,
    through flush rounds and with the LUT cache."""
    from repro_torch.core.sharded_search import DistributedEngine, EngineConfig
    from repro_torch.launch import make_shard_mesh
    from repro_torch.runtime import HotClusterLUTCache
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               k_gt=10, device=cuda)
    idx = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=64,
                      m=16, cb=256, kmeans_iters=6, pq_iters=6, device=cuda)
    q = ds.queries.float()
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_shard_mesh(8, devices=[card] * 8)
    streams = [s.cuda_stream for s in mesh.streams]
    assert len(set(streams)) == 8
    assert torch.cuda.current_stream(card).cuda_stream not in streams
    # past the 32 streams a device of PyTorch's pool, each entry its own
    wide = make_shard_mesh(64, devices=[card] * 64)
    assert len({s.cuda_stream for s in wide.streams}) == 64
    wide.close()
    cfg = EngineConfig(n_shards=8, nprobe=8, k=10, tasks_per_shard=24,
                       split_max=64, dup_budget_bytes=1 << 17,
                       lut_dtype=lut_dtype)
    probes = cluster_locate(q, idx.centroids, 8)[0].cpu().numpy()
    lc, fused = (("lut_build_q", "pq_scan_topk_q") if lut_dtype == "uint8"
                 else ("lut_build", "pq_scan_topk"))
    seen = []
    for name in {lc, fused}:
        wrapper = "pq_scan_topk" if name.startswith("pq") else name

        def record(*a, _name=name, _fn=getattr(ops, wrapper), **kw):
            seen.append((_name, torch.cuda.current_stream().cuda_stream))
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, wrapper, record)
    for cached in (False, True):
        def engine(m):
            cache = (HotClusterLUTCache(capacity=4096, lut_dtype=lut_dtype)
                     if cached else None)
            return DistributedEngine(idx, cfg, probes, mesh=m,
                                     lut_cache=cache)
        flat, on_mesh = engine(None), engine(mesh)
        for _ in range(2 if cached else 1):
            d0, i0, info0 = flat.search(q)
            ops.reset_launches()
            seen.clear()
            d1, i1, info1 = on_mesh.search(q)
            torch.cuda.synchronize()
            rounds = info1["rounds"]
            assert rounds == info0["rounds"] > 1
            np.testing.assert_array_equal(d1, d0)
            np.testing.assert_array_equal(i1, i0)
            assert ops.launches[fused] == 8 * rounds
            assert [s for n, s in seen if n == fused] == streams * rounds
            if not cached:
                assert ops.launches[lc] == 8 * rounds
                assert [s for n, s in seen if n == lc] == streams * rounds
        if cached:
            assert on_mesh.lut_cache.stats.hits == 64 * 8
    mesh.close()


def _on_cpu(x):
    """A tensor, or a NamedTuple of them (ShardedIndex, PQCodebook,
    QuantizedLUT), copied to the CPU; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on_cpu(a) for a in x))
    return x


@pytest.mark.parametrize("other", ["cpu", "cuda:1"])
@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_mesh_engine_across_devices(cuda, monkeypatch, lut_dtype, other):
    """A mesh whose last four entries lie on another device than the
    engine's card.  Their shards are copies on that device, the task
    tables, queries, centroids, codebooks and LUT bank are copied there
    each step, and their (T, k) outputs come back to the engine's card.
    Entries on a second card own a stream there, and the engine equals the
    flat engine bit for bit (the same kernels on the same rows).  Entries
    on the CPU own no stream and run the plain versions, so the engine
    equals the flat engine whose steps take those four shards' rows from
    the same step run on a CPU copy of the index.  Cache off and on, with
    flush rounds; LC and the fused DC+TS launch once per card entry and
    step."""
    import repro_torch.core.sharded_search as ss
    from repro_torch.launch import make_shard_mesh
    from repro_torch.runtime import HotClusterLUTCache
    if other == "cuda:1" and torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    ds = make_clustered_corpus(0, 8000, 32, n_queries=64, n_components=32,
                               k_gt=10, device=cuda)
    idx = build_ivfpq(torch.Generator().manual_seed(0), ds.points, nlist=64,
                      m=16, cb=256, kmeans_iters=6, pq_iters=6, device=cuda)
    q = ds.queries.float()
    card = torch.device("cuda", torch.cuda.current_device())
    far = torch.device(other)
    mesh = make_shard_mesh(8, devices=[card] * 4 + [far] * 4)
    if far.type == "cpu":
        assert mesh.streams[4:] == (None,) * 4
    else:
        assert all(s.device == far for s in mesh.streams[4:])
    n_card = 4 if far.type == "cpu" else 8
    cfg = ss.EngineConfig(n_shards=8, nprobe=8, k=10, tasks_per_shard=24,
                          split_max=64, dup_budget_bytes=1 << 17,
                          lut_dtype=lut_dtype)
    probes = cluster_locate(q, idx.centroids, 8)[0].cpu().numpy()
    fused = "pq_scan_topk_q" if lut_dtype == "uint8" else "pq_scan_topk"
    lc = "lut_build_q" if lut_dtype == "uint8" else "lut_build"

    def spliced(run):
        """``run`` with shards 4-7's rows from the same call on the CPU."""
        def step(sindex, *args, **kw):
            a = run(sindex, *args, **kw)
            b = run(_on_cpu(sindex), *(_on_cpu(x) for x in args), **kw)
            return tuple(torch.cat([x[:4], y[4:].to(x.device)])
                         for x, y in zip(a, b))
        return step

    for cached in (False, True):
        def engine(m):
            cache = (HotClusterLUTCache(capacity=4096, lut_dtype=lut_dtype)
                     if cached else None)
            return ss.DistributedEngine(idx, cfg, probes, mesh=m,
                                        lut_cache=cache)
        flat, on_mesh = engine(None), engine(mesh)
        for s, piece in enumerate(on_mesh._shards[0]):
            assert piece.device == mesh.devices[s]
            assert (piece.data_ptr() == on_mesh.sindex.codes[s].data_ptr()
                    ) == (s < 4)                # views on the engine's card
        for _ in range(2 if cached else 1):
            with monkeypatch.context() as patch:
                if far.type == "cpu":
                    for name in ("run_shards_vmap", "run_shards_vmap_lut"):
                        patch.setattr(ss, name, spliced(getattr(ss, name)))
                d0, i0, info0 = flat.search(q)
            ops.reset_launches()
            d1, i1, info1 = on_mesh.search(q)
            torch.cuda.synchronize()
            rounds = info1["rounds"]
            assert rounds == info0["rounds"] > 1
            np.testing.assert_array_equal(d1, d0)
            np.testing.assert_array_equal(i1, i0)
            assert ops.launches[fused] == n_card * rounds
            if not cached:
                assert ops.launches[lc] == n_card * rounds
        if cached:
            assert on_mesh.lut_cache.stats.hits == 64 * 8
    mesh.close()


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


# ---- the paper-side variants and the entry points (slice 10) -------------

def test_multiplierless_lut_lossless_on_the_card(cuda):
    """The paper's losslessness claim on the card at its width (D=128,
    M=16, CB=256, scale 1.0, the uint8 grid), and the card's integers
    equal the CPU's: the quantizers divide by a tensor, never by a
    reciprocal, and .5 quotients round to even."""
    from repro_torch.core import multiplierless as ml
    from repro_torch.core.pq import PQCodebook
    rng = np.random.default_rng(20)
    books = rng.normal(0, 30, size=(16, 256, 8)).astype(np.float32)
    res = rng.normal(0, 60, size=(512, 128)).astype(np.float32)
    res[0, :64] = np.arange(-32, 32) + 0.5            # half-way quotients
    codes = rng.integers(0, 256, size=(512, 300, 16)).astype(np.uint8)
    out = {}
    for dev in ("cpu", cuda):
        cb = PQCodebook(torch.from_numpy(books).to(dev),
                        torch.zeros((16, 256), device=dev))
        qcb = ml.quantize_codebook(cb, 1.0)
        rq = ml.quantize_residual(torch.from_numpy(res).to(dev), qcb.scale)
        lut = ml.build_lut_multiplierless(qcb, rq)
        assert torch.equal(lut, ml.build_lut_int_reference(qcb, rq))
        dist = ml.scan_codes_int(lut, torch.from_numpy(codes).to(dev))
        out[str(dev)] = [x.cpu() for x in (qcb.codebooks_q, rq, lut, dist)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)
    assert torch.equal(out["cuda"][1][0, 30:34],
                       torch.tensor([-2, 0, 0, 2], dtype=torch.int32))


def test_quickstart_kernel_search_launches_a_to_d(cuda):
    """examples/torch_quickstart.py on the card: both kernel searches
    reach the paper's 0.8 and launch A-D."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_launches()
    out = mod.main(["--device", "cuda"])
    assert out["recall"] >= 0.8
    assert min(out["recall_kernels"].values()) >= 0.8
    for name in ("lut_build", "lut_build_q", "pq_scan_dc", "pq_scan_dc_q"):
        assert ops.launches[name] > 0, name


@pytest.mark.parametrize("arch", ["qwen3_14b", "qwen2_moe_a2p7b",
                                  "mamba2_2p7b"],
                         ids=["dense", "moe", "ssd"])
def test_lm_smoke_arch_card_equals_cpu(cuda, arch):
    """One smoke arch of each family on shared weights: the card's
    ``forward`` and eight ``decode_step``s equal the CPU's at rtol 1e-4,
    atol 1e-3 or 1e-4 of the logits' scale where that is larger (f32 sums
    in another order leave ~3e-5 of it; matmuls in IEEE f32; mamba2's tied
    embedding gives logits up to ~39)."""
    from repro_torch.configs import registry
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_map
    from repro_torch.util import ieee_f32_matmul
    ieee_f32_matmul()
    cfg = registry.get_config(arch, smoke=True)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 8)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        t = toks.to(dev)
        logits, _ = forward(p, cfg, t)
        caches = init_caches(cfg, 2, 8, device=dev)
        steps = []
        for i in range(8):
            lg, caches = decode_step(p, cfg, t[:, i:i + 1],
                                     torch.full((2,), i, device=dev), caches)
            steps.append(lg[:, 0])
        out[dev] = (logits.cpu(), torch.stack(steps, 1).cpu())
    scale = float(out["cpu"][0][..., :cfg.vocab_size].abs().max())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=max(1e-3, 1e-4 * scale))


def test_matmul_f32_autograd_on_card(cuda):
    """``matmul_f32`` on bf16 operands on the card: the f32 product (no
    f32 copy of the weight) and its gradient (``aten::mm.dtype`` has no
    derivative of its own): both operands' gradients are bf16 products of
    the bf16-cast output gradient, accumulated in f32, so they equal the
    f32 products of the same bf16 values up to the final rounding to bf16
    (rtol 2^-8)."""
    from repro_torch.models.layers import matmul_f32
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 96, 256, device="cuda", generator=g).bfloat16()
    w = (torch.randn(1000, 256, device="cuda", generator=g) / 16).bfloat16()
    up = torch.randn(2, 96, 1000, device="cuda", generator=g)
    x.requires_grad_(True)
    w.requires_grad_(True)
    out = matmul_f32(x, w)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.float() @ w.float().t(), rtol=1e-5,
                               atol=1e-4)
    (out * up).sum().backward()
    ub = up.bfloat16().float().reshape(-1, 1000)
    want_x = (ub @ w.float()).reshape(x.shape)
    want_w = ub.t() @ x.float().reshape(-1, 256)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad.float(), want_x, rtol=2 ** -8,
                               atol=1e-3)
    torch.testing.assert_close(w.grad.float(), want_w, rtol=2 ** -8,
                               atol=1e-3)


def test_async_save_snapshot_not_torn_on_card(cuda, tmp_path):
    """An async save of card tensors holds the values at the call: an
    in-place update launched right after ``save`` returns does not reach
    the files (a bf16 leaf too, widened to f32 on disk)."""
    from repro_torch.checkpoint import Checkpointer
    w = torch.arange(1 << 22, device="cuda", dtype=torch.float32)
    h = torch.linspace(-4, 4, 1 << 20, device="cuda").bfloat16()
    tree = {"w": w, "h": h}
    before = {k: v.clone() for k, v in tree.items()}
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, extra={"step": 1}, blocking=False)
    w.add_(1.0)
    h.mul_(2.0)
    ck.wait()
    got, _ = ck.restore(1, tree)
    for k in tree:
        assert got[k].is_cuda and got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], before[k]), k


@pytest.mark.parametrize("arch", ["qwen3_14b", "minitron_4b",
                                  "llama32_vision_11b"])
def test_train_step_card_equals_cpu(cuda, arch):
    """One ``make_train_step`` on shared smoke weights (f32, IEEE
    matmuls): the card's loss and grad_norm equal the CPU's at rtol 1e-4,
    atol 1e-3; the card's remat "full" gradients equal "none"'s."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import make_token_pipeline
    from repro_torch.launch.steps import cross_entropy, make_train_step
    from repro_torch.launch.train import ctx_for
    from repro_torch.models import forward, init_params
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.util import ieee_f32_matmul
    ieee_f32_matmul()
    cfg = registry.get_config(arch, smoke=True)
    params = init_params(cfg, 0, device="cpu")
    batch = make_token_pipeline(cfg.vocab_size, 16, 2, seed=0).batch_at(0)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev, copy=True), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        ctx = ctx_for(cfg, 0, 2, "cpu")
        if ctx is not None:
            b["ctx"] = ctx.to(dev)
        _, _, m = make_train_step(cfg)(p, adamw.init(p), b)
        out[dev] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "grad_norm"):
        assert out["cuda"][k] == pytest.approx(out["cpu"][k], rel=1e-4,
                                               abs=1e-3), k
    grads = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        p = tree_map(lambda x: x.to("cuda", copy=True).requires_grad_(True),
                     params)
        b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        ctx = ctx_for(cfg, 0, 2, "cpu")
        lg, aux = forward(p, c, b["tokens"],
                          ctx=None if ctx is None else ctx.cuda())
        (cross_entropy(lg, b["labels"]) + 1e-3 * aux).backward()
        grads[remat] = [t.grad for t in tree_leaves(p)]
    for a, b in zip(grads["full"], grads["none"]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_bf16_train_step_on_card(cuda):
    """A bf16 smoke model trains on the card: the logits go through
    ``matmul_f32``'s gradient; loss and grad_norm are finite, the grads
    bf16, the moments f32, and ten steps lower the loss."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.train import train_loop
    cfg = dataclasses.replace(registry.get_config("minitron_4b", smoke=True),
                              dtype=torch.bfloat16, remat="full")
    params, hist = train_loop(cfg, steps=10, global_batch=8, seq_len=64,
                              log_every=100, device="cuda")
    assert params["lm_head"].dtype == torch.bfloat16
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    assert np.mean([h["loss"] for h in hist[-3:]]) < \
        np.mean([h["loss"] for h in hist[:3]])


@pytest.mark.parametrize("lut_dtype", [None, "uint8", "bf16"])
def test_drim_dryrun_cell_launches_kernels_equal_plain(cuda, tmp_path,
                                                       lut_dtype):
    """The dry-run's drim cell at rank 0's 100M shape (512 slots of 4,096
    codes, 8,192 tasks) launches A then E (f32), B then F (uint8) or
    A-bf16 then E-bf16, fused, and C, D or C-bf16 unfused; rank 0's step
    on the card equals the same step on CPU copies of its tensors (the
    kernels' plain versions; bf16 by the one-ulp rule)."""
    from repro_torch.configs import drim_ann
    from repro_torch.launch import dryrun
    quant = lut_dtype == "uint8"
    sfx = {None: "", "uint8": "_q", "bf16": "_bf16"}[lut_dtype]
    lc = "lut_build" + sfx
    for fused, dc in ((True, "pq_scan_topk" + sfx),
                      (False, "pq_scan_dc" + sfx)):
        ops.reset_launches()
        rec = dryrun.run_drim_ann_cell(False, tmp_path, fused_scan=fused,
                                       lut_dtype=lut_dtype)
        assert rec["fits"] and rec["shard_shape"]["slots"] == 512
        steps = 1 + dryrun.DRIM_TIMED_STEPS          # the warm one, timed
        assert len(rec["step_ms_samples"]) == dryrun.DRIM_TIMED_STEPS
        assert ops.launches[lc] == steps and ops.launches[dc] == steps
    shp = dryrun._drim_shape(drim_ann.config(), 256)
    inp = dryrun.drim_inputs(shp, cuda)
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else
               type(v)(*(x.cpu() for x in v))) for k, v in inp.items()}
    bf16 = "bf16" if lut_dtype == "bf16" else None
    for fused in (True, False):
        d1, i1 = dryrun.drim_step(inp, shp["k"], fused, quant, bf16)
        d2, i2 = dryrun.drim_step(cpu, shp["k"], fused, quant, bf16)
        if bf16:        # bf16 distances tie often: ids up to those ties
            _assert_topk_bf16(d1, i1, d2, i2, shp["k"], same_table=False)
            continue
        torch.testing.assert_close(d1.cpu(), d2, rtol=RTOL, atol=ATOL)
        assert (i1.cpu() == i2).float().mean() > 0.99


def test_distribute_and_restore_under_fake_world_on_card(cuda, tmp_path):
    """Under a fake world of 256, ``distribute_tree`` and
    ``restore(shardings=)`` put on cuda:0 exactly rank 0's slices of a
    smoke model sharded by the production rules."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params_and_axes
    from repro_torch.models.common import tree_leaves
    cfg = registry.get_config("qwen3_14b", smoke=True)
    params, axes = init_params_and_axes(cfg, 0, device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(3, params)
    with M.fake_world(256, "cuda"):
        mesh = M.make_production_mesh()
        sh = M.shardings_for_tree(params, axes, M.rules_for(cfg, True), mesh)
        put = M.distribute_tree(params, sh)
        got, _ = ck.restore(3, params, shardings=sh)
        n_sharded = 0
        for a, b, t, s in zip(tree_leaves(put), tree_leaves(got),
                              tree_leaves(params), _shardings(sh)):
            part = t[s.local_slices(t.shape)]
            for x in (a, b):
                assert x.to_local().device == torch.device("cuda", 0)
                assert torch.equal(x.to_local().cpu(), part)
                assert tuple(x.placements) == s.placements
            n_sharded += part.numel() < t.numel()
        assert n_sharded > 0


def _shardings(tree):
    if hasattr(tree, "placements"):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shardings(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _shardings(v)]
    return []
