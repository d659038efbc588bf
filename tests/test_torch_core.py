"""Port parity for the index build: k-means, PQ encoding, padding, the
port's own build against the reference build, top-k helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (assign_chunked as ref_assign, encode_pq as ref_encode,
                        exact_search as ref_exact, merge_topk as ref_merge,
                        search_ivfpq as ref_search,
                        SearchParams as RefParams, recall_at_k as ref_recall,
                        topk_smallest as ref_topk)
from repro.kernels import ref as jref

from repro_torch.convert import clusters_from_numpy, index_from_numpy
from repro_torch.core import (PQCodebook, SearchParams, build_ivfpq,
                              decode_pq, encode_pq, exact_search, kmeans, kmeans_multi,
                              l2_sq, merge_topk, pad_clusters, recall_at_k,
                              reconstruct, search_ivfpq, topk_smallest,
                              train_opq)
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)


def _port_index(index, device="cpu"):
    return index_from_numpy(index.centroids, index.codebook.codebooks,
                            index.codebook.sqnorms, index.codes, index.ids,
                            index.offsets, index.rotation, device=device)


def test_l2_sq_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    y = rng.normal(size=(70, 12)).astype(np.float32)
    from repro.core import l2_sq as ref_l2
    np.testing.assert_allclose(l2_sq(torch.from_numpy(x), torch.from_numpy(y)
                                     ).numpy(),
                               np.asarray(ref_l2(x, y)), rtol=1e-4, atol=1e-3)


def test_encode_pq_matches_reference_codes(small_corpus, small_index):
    """Given the reference codebooks, the port's codes equal the
    reference's; where a near-tie flips a code, both codewords are equally
    close within 1e-5 relative."""
    pts = jnp.asarray(small_corpus.points, jnp.float32)
    assign, _ = ref_assign(pts, small_index.centroids)
    res = np.array(pts - small_index.centroids[assign])
    cb = small_index.codebook
    want = np.asarray(ref_encode(cb, jnp.asarray(res)))
    port_cb = PQCodebook(torch.from_numpy(np.array(cb.codebooks)),
                         torch.from_numpy(np.array(cb.sqnorms)))
    got = encode_pq(port_cb, torch.from_numpy(res)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert len(diff) <= 0.001 * got.size
    books = np.asarray(cb.codebooks)
    sub = res.reshape(res.shape[0], cb.m, -1)
    for i, mm in diff:
        da = ((sub[i, mm] - books[mm, got[i, mm]]) ** 2).sum()
        db = ((sub[i, mm] - books[mm, want[i, mm]]) ** 2).sum()
        assert abs(da - db) <= 1e-5 * max(abs(db), 1e-12)


def test_decode_pq_roundtrip():
    rng = np.random.default_rng(2)
    books = torch.from_numpy(rng.normal(size=(4, 16, 3)).astype(np.float32))
    cb = PQCodebook(books, (books * books).sum(-1))
    codes = torch.from_numpy(rng.integers(0, 16, (9, 4)).astype(np.uint8))
    rec = decode_pq(cb, codes)
    assert rec.shape == (9, 12)
    np.testing.assert_array_equal(encode_pq(cb, rec).numpy(), codes.numpy())


def test_pad_clusters_matches_reference(small_index, small_clusters):
    got = pad_clusters(_port_index(small_index))
    np.testing.assert_array_equal(got.codes.numpy(),
                                  np.asarray(small_clusters.codes))
    np.testing.assert_array_equal(got.ids.numpy(),
                                  np.asarray(small_clusters.ids))
    np.testing.assert_array_equal(got.sizes.numpy(),
                                  np.asarray(small_clusters.sizes))


def test_convert_uint16_codes_become_int32():
    codes = np.arange(12, dtype=np.uint16).reshape(2, 2, 3) * 1000
    cl = clusters_from_numpy(codes, np.zeros((2, 2), np.int32),
                             np.array([2, 1], np.int32), device="cpu")
    assert cl.codes.dtype == torch.int32
    np.testing.assert_array_equal(cl.codes.numpy(), codes.astype(np.int32))
    with pytest.raises(TypeError):
        clusters_from_numpy(codes.astype(np.int64), codes[..., 0],
                            np.array([2, 1]), device="cpu")


def test_port_build_recall_tracks_reference(small_corpus, small_index,
                                            small_clusters):
    """Builds differ by RNG, so the port's build is held to recall@10
    against the exact oracle, within 0.05 of the reference build."""
    p = RefParams(nprobe=8, k=10, query_chunk=32)
    _, ri = ref_search(small_index, small_clusters, small_corpus.queries, p)
    ref_r = float(ref_recall(ri, small_corpus.groundtruth))
    idx = build_ivfpq(torch.Generator().manual_seed(0),
                      torch.from_numpy(np.array(small_corpus.points)),
                      nlist=64, m=16, cb=256, kmeans_iters=6, pq_iters=6,
                      device="cpu")
    assert idx.codes.dtype == torch.uint8
    assert int(idx.offsets[-1]) == small_corpus.points.shape[0]
    assert sorted(idx.ids.tolist()) == list(range(idx.codes.shape[0]))
    cl = pad_clusters(idx)
    _, pi = search_ivfpq(idx, cl,
                         torch.from_numpy(np.array(small_corpus.queries)),
                         SearchParams(nprobe=8, k=10, query_chunk=32))
    port_r = recall_at_k(pi, torch.from_numpy(
        np.array(small_corpus.groundtruth)))
    assert port_r >= ref_r - 0.05, (port_r, ref_r)
    # reconstruction lands near the stored point
    rank = 17
    rec = reconstruct(idx, torch.tensor(rank))
    orig = torch.from_numpy(np.array(small_corpus.points))[idx.ids[rank]]
    err = float(((rec - orig.float()) ** 2).sum())
    assert err < float(((orig.float() - idx.centroids) ** 2).sum(-1).max())


def test_kmeans_reseeds_empty_clusters():
    """Duplicate-heavy data makes initial draws collide; the farthest-point
    reseed leaves every centroid on a distinct point."""
    base = torch.arange(6, dtype=torch.float32)[:, None] * torch.ones(1, 3) * 10
    pts = base.repeat(40, 1)
    st = kmeans(pts, k=6, iters=6, generator=torch.Generator().manual_seed(1))
    assert torch.unique(st.centroids, dim=0).shape[0] == 6
    assert float(st.obj) == 0.0
    multi = kmeans_multi(torch.stack([pts, pts + 1]), k=6, iters=6,
                         generator=torch.Generator().manual_seed(2))
    assert multi.centroids.shape == (2, 6, 3)
    assert multi.assign.dtype == torch.int32


def test_train_opq_rotation_is_orthogonal():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(600, 8)).astype(np.float32))
    opq = train_opq(x, m=2, cb=16, outer_iters=2, pq_iters=3,
                    generator=torch.Generator().manual_seed(0))
    eye = opq.rotation @ opq.rotation.T
    np.testing.assert_allclose(eye.numpy(), np.eye(8), atol=1e-4)
    assert opq.pq.codebooks.shape == (2, 16, 4)


def test_topk_helpers_match_reference():
    rng = np.random.default_rng(4)
    d = rng.permutation(300).reshape(3, 100).astype(np.float32)
    ids = rng.integers(0, 1000, (3, 100)).astype(np.int32)
    gd, gi = topk_smallest(torch.from_numpy(d), torch.from_numpy(ids), 7)
    rd, ri = ref_topk(jnp.asarray(d), jnp.asarray(ids), 7)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    a = [torch.from_numpy(v) for v in (d[:, :50], ids[:, :50], d[:, 50:],
                                       ids[:, 50:])]
    md, mi = merge_topk(*a, 5)
    rmd, rmi = ref_merge(*[jnp.asarray(v.numpy()) for v in a], 5)
    np.testing.assert_array_equal(md.numpy(), np.asarray(rmd))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(rmi))


def test_exact_search_matches_reference():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(900, 16)).astype(np.float32)
    qs = rng.normal(size=(30, 16)).astype(np.float32)
    gd, gi = exact_search(torch.from_numpy(pts), torch.from_numpy(qs), k=5,
                          chunk=7)
    rd, ri = ref_exact(jnp.asarray(pts), jnp.asarray(qs), k=5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def test_scan_topk_oracle_matches_reference():
    rng = np.random.default_rng(6)
    lut = rng.normal(size=(3, 4, 16)).astype(np.float32) ** 2
    codes = rng.integers(0, 16, (3, 40, 4)).astype(np.int32)
    ids = rng.integers(0, 999, (3, 40)).astype(np.int32)
    sizes = np.array([0, 5, 40], np.int32)
    gd, gi = tref.pq_scan_topk_ref(*map(torch.from_numpy,
                                        (lut, codes, ids, sizes)), 8)
    rd, ri = jref.pq_scan_topk_ref(*map(jnp.asarray,
                                        (lut, codes, ids, sizes)), 8)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-5)
    for t in range(3):
        assert set(gi[t].tolist()) == set(np.asarray(ri)[t].tolist())
    assert (gi[0] == -1).all() and torch.isinf(gd[0]).all()
