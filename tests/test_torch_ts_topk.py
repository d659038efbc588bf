"""TS by slot (``kernels.ops.ts_topk``) on the CPU: its plain route, the
wrapper's refusals, and ``core.search.dc_ts``'s route to it.

The plain route must give what ``dc_ts`` selected before the kernel
existed (``_present`` below, that code as it stood): ``torch.topk`` over
each query's padded distances, then each winner's id by (probe, row), bit
for bit, ties and padding included.  A slot outside [0, nslots) has size
0, so its task is that of an empty cluster (ids all -1).  The kernel runs
only on the card (``tests/test_torch_cuda.py`` holds it to this route).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SearchParams
from repro_torch.core.ivf import PaddedClusters
from repro_torch.core.search import dc_ts, dc_ts_tasks
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _case(seed, qc, p, c, nslots, kind="basic"):
    """(dists, slots, sizes, ids) as DC by slot leaves them: real rows
    random, +inf past each task's size and in every task of a slot
    outside [0, nslots).  ``kind``: "ties" rounds the distances to 1/8;
    "short" gives every cluster at most 2 rows; "outside" puts some slots
    at -1 and past the end."""
    rng = np.random.default_rng(seed)
    hi = 3 if kind == "short" else c + 1
    sizes = rng.integers(0, hi, nslots).astype(np.int32)
    ids = np.full((nslots, c), -1, np.int32)
    real = np.arange(c)[None, :] < sizes[:, None]
    ids[real] = rng.permutation(10 * nslots * c)[:int(real.sum())]
    slots = rng.integers(0, nslots, qc * p).astype(np.int32)
    if kind == "outside":
        slots[::5] = -1
        slots[2::7] = nslots + 3
    valid = (slots >= 0) & (slots < nslots)
    size_t = np.where(valid, sizes[np.clip(slots, 0, nslots - 1)], 0)
    d = rng.random((qc * p, c), np.float32) * 10
    if kind == "ties":
        d = np.round(d * 8) / 8
    d[np.arange(c)[None, :] >= size_t[:, None]] = np.inf
    return tuple(torch.from_numpy(a) for a in (d.astype(np.float32), slots,
                                               sizes, ids))


def _present(dists, probes, ids, k):
    """dc_ts's TS before the kernel: probes (qc, P) int64 in range."""
    qc, cmax = probes.shape[0], dists.shape[1]
    d, pos = torch.topk(dists.reshape(qc, -1), k, dim=-1, largest=False,
                        sorted=True)
    row = probes.gather(1, pos // cmax) * cmax + pos % cmax
    return d, torch.take(ids, row)


def _present_on(dists, slots, ids, qc, k):
    """``_present`` on the same tasks, a slot outside [0, nslots) mapped
    to an empty cluster appended to ``ids``."""
    nslots, c = ids.shape
    s = slots.long()
    s = torch.where((s >= 0) & (s < nslots), s, nslots)
    ids_x = torch.cat([ids, torch.full((1, c), -1, dtype=torch.int32)])
    return _present(dists, s.reshape(qc, -1), ids_x, k)


def _oracle(dists, slots, sizes, ids, qc, k):
    """Each query's real rows sorted by (distance, probe * C + row), the
    first k as (distance, id), (+inf, -1) past them."""
    d, s_all = dists.numpy(), slots.numpy()
    nslots, c = ids.shape
    out_d = np.full((qc, k), np.inf, np.float32)
    out_i = np.full((qc, k), -1, np.int32)
    p = len(s_all) // qc
    for q in range(qc):
        cand = []
        for j in range(p):
            s = int(s_all[q * p + j])
            n = int(sizes[s]) if 0 <= s < nslots else 0
            for r in range(n):
                cand.append((d[q * p + j, r], j * c + r, int(ids[s, r])))
        cand.sort(key=lambda x: (x[0], x[1]))
        for i, (dist, _, idv) in enumerate(cand[:k]):
            out_d[q, i], out_i[q, i] = dist, idv
    return out_d, out_i


CASES = [  # (kind, qc, P, C, nslots, k)
    ("basic", 4, 6, 50, 9, 10),
    ("ties", 4, 6, 50, 9, 10),
    ("short", 5, 3, 40, 7, 10),            # fewer real rows than k
    ("outside", 4, 6, 50, 9, 10),
    ("basic", 16, 5, 33, 11, 10),          # a short last chunk of 16
    ("ties", 4, 6, 50, 9, 1),
    ("ties", 3, 8, 40, 5, 256),
]


@pytest.mark.parametrize("kind,qc,p,c,nslots,k", CASES)
def test_plain_route_equals_present_selection(kind, qc, p, c, nslots, k):
    dists, slots, sizes, ids = _case(1, qc, p, c, nslots, kind)
    got = ops.ts_topk(dists, slots, sizes, ids, qc, k)
    want = _present_on(dists, slots, ids, qc, k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == got[1].shape == (qc, k)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    if kind == "short":
        assert bool(torch.isinf(got[0]).any())
        assert bool((got[1][torch.isinf(got[0])] == -1).all())


@pytest.mark.parametrize("kind,qc,p,c,nslots,k", CASES)
def test_plain_route_selects_the_k_smallest_real_rows(kind, qc, p, c,
                                                      nslots, k):
    """Distances bit for bit the sorted real rows'; ids those rows' up to
    the order of equal distances (a boundary tie may take any of its
    rows)."""
    dists, slots, sizes, ids = _case(2, qc, p, c, nslots, kind)
    gd, gi = (x.numpy() for x in ops.ts_topk(dists, slots, sizes, ids, qc,
                                             k))
    od, oi = _oracle(dists, slots, sizes, ids, qc, k)
    np.testing.assert_array_equal(gd, od)
    for q in range(qc):
        for v in np.unique(od[q]):
            same = od[q] == v
            if v == od[q, -1] and np.isfinite(v):
                continue                   # the boundary group
            assert sorted(gi[q, same]) == sorted(oi[q, same])


def _inputs():
    return _case(3, 4, 6, 50, 9)


def _bad(what):
    dists, slots, sizes, ids = _inputs()
    qc, k = 4, 10
    if what == "dists f64":
        dists = dists.double()
    elif what == "slots i64":
        slots = slots.long()
    elif what == "sizes i64":
        sizes = sizes.long()
    elif what == "ids i64":
        ids = ids.long()
    elif what == "dists 1-D":
        dists = dists.reshape(-1)
    elif what == "slots not one a task":
        slots = slots[:-1]
    elif what == "ids not (nslots, C)":
        ids = ids[:, :-1].contiguous()
    elif what == "qc does not divide the tasks":
        qc = 5
    elif what == "slots on another device":
        slots = torch.empty(slots.shape, dtype=torch.int32, device="meta")
    elif what == "dists not contiguous":
        dists = torch.cat([dists, dists], 1)[:, ::2]
    elif what == "ids not contiguous":
        ids = torch.cat([ids, ids], 1)[:, ::2]
    elif what == "k 0":
        k = 0
    elif what == "k 257":
        k = 257
    elif what == "k past P * C":
        dists, slots, sizes, ids = _case(3, 4, 2, 3, 9)
    return dists, slots, sizes, ids, qc, k


@pytest.mark.parametrize("what", [
    "dists f64", "slots i64", "sizes i64", "ids i64", "dists 1-D",
    "slots not one a task", "ids not (nslots, C)",
    "qc does not divide the tasks", "slots on another device",
    "dists not contiguous", "ids not contiguous", "k 0", "k 257",
    "k past P * C"])
def test_wrapper_refuses(what):
    with pytest.raises((TypeError, ValueError)):
        ops.ts_topk(*_bad(what))


def _clusters(seed, nlist=12, c=40, m=4, cb=16):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, c + 1, nlist).astype(np.int32)
    codes = rng.integers(0, cb, (nlist, c, m)).astype(np.uint8)
    ids = np.full((nlist, c), -1, np.int32)
    real = np.arange(c)[None, :] < sizes[:, None]
    ids[real] = rng.permutation(100 * nlist * c)[:int(real.sum())]
    return PaddedClusters(torch.from_numpy(codes), torch.from_numpy(ids),
                          torch.from_numpy(sizes))


@pytest.mark.parametrize("use_kernels,k,routed", [
    (True, 10, True), (False, 10, False), (True, 300, False)])
def test_dc_ts_routes_ts_by_shape(monkeypatch, use_kernels, k, routed):
    """With use_kernels and k <= MAX_K_PAD dc_ts calls ops.ts_topk, else
    the plain version; either way its answers are dc_ts_tasks' on the
    gathered copy, bit for bit."""
    clusters = _clusters(4)
    qc, p = 6, 8
    g = torch.Generator().manual_seed(5)
    probes = torch.randint(0, clusters.codes.shape[0], (qc, p), generator=g)
    lut = torch.rand((qc * p, 4, 16), generator=g) * 5
    calls = []
    real = ops.ts_topk
    monkeypatch.setattr(ops, "ts_topk",
                        lambda *a: calls.append(a) or real(*a))
    params = SearchParams(nprobe=p, k=k, use_kernels=use_kernels)
    got = dc_ts(lut, probes, clusters, params)
    assert len(calls) == (1 if routed else 0)
    flat = probes.reshape(-1)
    want = dc_ts_tasks(lut, clusters.codes.index_select(0, flat),
                       clusters.ids.index_select(0, flat),
                       clusters.sizes.index_select(0, flat), qc, params)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
