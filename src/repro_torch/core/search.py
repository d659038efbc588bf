"""Single-device five-phase cluster-based ANNS pipeline (paper Fig. 1).

    CL  cluster locating      q x centroids GEMM + top-nprobe
    RC  residual computation  q - centroid[probe]
    LC  LUT construction      build_lut_batch (or the lut_build kernel)
    DC  distance calculation  adc scan (or the pq_scan kernel)
    TS  top-k sorting         torch.topk

``use_kernels=True`` routes LC/DC through ``repro_torch.kernels.ops``:
the hand-written CUDA kernels on CUDA tensors, their plain versions on
CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.adc import (adc_distances, adc_distances_quantized,
                                  build_lut_batch, quantize_lut)
from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.kmeans import l2_sq
from repro_torch.core.topk import topk_smallest
from repro_torch.util import ieee_f32_matmul


class SearchParams(NamedTuple):
    nprobe: int
    k: int
    strategy: str = "gather"        # "gather" | "onehot"; same result here
    query_chunk: int = 256          # queries per scan step
    use_kernels: bool = False       # route LC/DC through the CUDA kernels
    lut_dtype: str = "f32"          # "f32" | "uint8" quantized-LUT path


def cluster_locate(queries: torch.Tensor, centroids: torch.Tensor,
                   nprobe: int, block: Optional[int] = None):
    """CL: (Q, D) x (nlist, D) -> probe ids (Q, nprobe) i64 + centroid
    distances, nearest first.

    ``block`` >= Q runs the GEMM on the queries zero-padded to ``block``
    rows.  cuBLAS picks its algorithm (and so the last bits of each
    distance) by shape, and a near-tie at the nprobe-th centroid would
    otherwise let a query's probes depend on the size of its batch; the
    top-nprobe then runs on the real rows only."""
    q = queries
    if block is not None:
        q = torch.nn.functional.pad(queries, (0, 0, 0, block - len(queries)))
    d = l2_sq(q, centroids)[:len(queries)]
    dist, idx = torch.topk(d, nprobe, dim=-1, largest=False, sorted=True)
    return idx, dist


def _search_chunk(queries, centroids, codebook, clusters: PaddedClusters,
                  rotation, params: SearchParams):
    q = queries.float()
    # CL on a fixed (query_chunk, D) block: batch-size-invariant probes
    probes, _ = cluster_locate(q, centroids, params.nprobe,
                               block=params.query_chunk)          # (Qc, P)
    qc, p = probes.shape
    # RC
    residual = q[:, None, :] - centroids[probes]                  # (Qc, P, D)
    if rotation is not None:
        ieee_f32_matmul()
        residual = residual @ rotation
    flat_res = residual.reshape(qc * p, -1)
    flat_probes = probes.reshape(-1)
    # gather the probed clusters' codes/ids/sizes; codes keep their
    # stored dtype (uint8: 4x fewer gathered bytes than int32)
    codes = clusters.codes.index_select(0, flat_probes)           # (QcP, C, M)
    ids = clusters.ids.index_select(0, flat_probes)               # (QcP, C)
    sizes = clusters.sizes.index_select(0, flat_probes)           # (QcP,)
    quantized = params.lut_dtype == "uint8"
    if params.use_kernels:
        from repro_torch.kernels import ops as kops
        if quantized:                     # LC with fused quantize epilogue
            lut = kops.lut_build_q(flat_res, codebook.codebooks,
                                   codebook.sqnorms)
        else:
            lut = kops.lut_build(flat_res, codebook.codebooks,
                                 codebook.sqnorms)                # (QcP, M, CB)
        dists = kops.pq_scan_dc(lut, codes, sizes, strategy=params.strategy)
    else:
        lut = build_lut_batch(codebook, flat_res)
        if quantized:
            dists = adc_distances_quantized(quantize_lut(lut), codes, sizes,
                                            params.strategy)
        else:
            dists = adc_distances(lut, codes, sizes, params.strategy)
    # TS: per query over all probed candidates
    cand_d = dists.reshape(qc, p * clusters.cmax)
    cand_i = ids.reshape(qc, p * clusters.cmax)
    return topk_smallest(cand_d, cand_i, params.k)


@torch.no_grad()
def search_ivfpq(index: IVFPQIndex, clusters: PaddedClusters,
                 queries: torch.Tensor, params: SearchParams):
    """Full pipeline over (Q, D) queries on the index's device, one query
    chunk at a time to bound the (chunk*P, cmax) DC working set.
    Returns (dists (Q, k) f32, ids (Q, k) i32); padding comes out as
    (+inf, -1)."""
    if params.lut_dtype not in ("f32", "uint8"):
        raise ValueError(f"unknown lut_dtype {params.lut_dtype!r}")
    queries = queries.to(index.centroids.device)
    outs = [_search_chunk(queries[s:s + params.query_chunk],
                          index.centroids, index.codebook, clusters,
                          index.rotation, params)
            for s in range(0, queries.shape[0], params.query_chunk)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


@torch.no_grad()
def exact_search(points: torch.Tensor, queries: torch.Tensor, k: int,
                 chunk: int = 1024):
    """Brute-force oracle for recall measurement, on the points' device,
    chunked over queries (one (chunk, N) f32 distance block at a time).
    Returns (dists (Q, k) f32, ids (Q, k) i32)."""
    queries = queries.to(points.device)
    points = points.float()           # cast once, not once per chunk
    dd, ii = [], []
    for s in range(0, queries.shape[0], chunk):
        d = l2_sq(queries[s:s + chunk], points)
        dist, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        dd.append(dist)
        ii.append(idx.int())
    return torch.cat(dd), torch.cat(ii)


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor) -> float:
    """recall@k: |found ∩ true| / k averaged over queries (paper metric).
    Padding ids are -1 and never match true ids (>= 0)."""
    hits = (found_ids[:, :, None] == true_ids[:, None, :]).any(dim=2)
    return float((hits.sum(dim=1).float() / true_ids.shape[1]).mean())
