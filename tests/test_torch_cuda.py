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

from repro_torch.core import (SearchParams, build_ivfpq, pad_clusters,
                              recall_at_k, search_ivfpq)
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


@pytest.mark.parametrize("t,m,cb,dsub", [(7, 8, 64, 4), (32, 16, 256, 8),
                                         (130, 8, 256, 16), (9, 32, 32, 2),
                                         (8192, 16, 256, 8)])
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


def test_kernels_refuse_cpu_mixed_inputs(cuda):
    r, b, s, codes, sizes = _mk(9, 4, 4, 16, 32, 2, np.uint8, cuda)
    with pytest.raises(ValueError):
        ops.lut_build(r, b.cpu(), s)
    lut = ops.lut_build(r, b, s)
    with pytest.raises(ValueError):
        ops.pq_scan_dc(lut, codes.cpu(), sizes)


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
