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

from repro_torch.core.adc import (QuantizedLUT, adc_distances,
                                  adc_distances_quantized, build_lut_batch,
                                  quantize_lut)
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


def cl_rc(queries: torch.Tensor, centroids: torch.Tensor, rotation,
          params: SearchParams):
    """CL + RC for one chunk of at most ``params.query_chunk`` queries:
    (Qc, D) -> probes (Qc, P) and flat residuals (Qc*P, D).  CL runs on a
    fixed (query_chunk, D) block, so a query's probes do not depend on
    the size of the batch it rode in."""
    q = queries.float()
    probes, _ = cluster_locate(q, centroids, params.nprobe,
                               block=params.query_chunk)          # (Qc, P)
    return probes, rc_from_probes(q, centroids, rotation, probes)


def lc(flat_res: torch.Tensor, codebook, params: SearchParams):
    """LC: (T, D) residuals -> (T, M, CB) f32 tables, or a QuantizedLUT
    on the uint8 path; through the LC kernels with ``use_kernels``."""
    quantized = params.lut_dtype == "uint8"
    if params.use_kernels:
        from repro_torch.kernels import ops as kops
        if quantized:                     # LC with fused quantize epilogue
            return kops.lut_build_q(flat_res, codebook.codebooks,
                                    codebook.sqnorms)
        return kops.lut_build(flat_res, codebook.codebooks, codebook.sqnorms)
    lut = build_lut_batch(codebook, flat_res)
    return quantize_lut(lut) if quantized else lut


def dc_ts(lut, probes: torch.Tensor, clusters: PaddedClusters,
          params: SearchParams):
    """DC + TS over one chunk's tables: ``lut`` (Qc*P, M, CB) f32 or a
    (Qc*P,)-batched QuantizedLUT, one row per (query, probe) in
    ``probes`` order -> ((Qc, k) dists, (Qc, k) ids)."""
    qc, p = probes.shape
    flat_probes = probes.reshape(-1)
    # gather the probed clusters' codes/ids/sizes; codes keep their
    # stored dtype (uint8: 4x fewer gathered bytes than int32)
    codes = clusters.codes.index_select(0, flat_probes)           # (QcP, C, M)
    ids = clusters.ids.index_select(0, flat_probes)               # (QcP, C)
    sizes = clusters.sizes.index_select(0, flat_probes)           # (QcP,)
    return dc_ts_tasks(lut, codes, ids, sizes, qc, params)


def dc_ts_tasks(lut, codes: torch.Tensor, ids: torch.Tensor,
                sizes: torch.Tensor, qc: int, params: SearchParams):
    """DC + TS over pre-gathered task tensors: codes (Qc*P, C, M), ids
    (Qc*P, C), sizes (Qc*P,), one task per (query, probe) in probe order
    -> ((Qc, k) dists, (Qc, k) ids).  The tiered path fetches these rows
    from its store; bytes equal to ``dc_ts``'s gather give equal
    results."""
    if params.use_kernels:
        from repro_torch.kernels import ops as kops
        dists = kops.pq_scan_dc(lut, codes, sizes, strategy=params.strategy)
    elif isinstance(lut, QuantizedLUT):
        dists = adc_distances_quantized(lut, codes, sizes, params.strategy)
    else:
        dists = adc_distances(lut, codes, sizes, params.strategy)
    # TS: per query over all probed candidates
    cand_d = dists.reshape(qc, -1)
    cand_i = ids.reshape(qc, -1)
    return topk_smallest(cand_d, cand_i, params.k)


def rc_from_probes(queries: torch.Tensor, centroids: torch.Tensor, rotation,
                   probes: torch.Tensor) -> torch.Tensor:
    """RC for probes routed elsewhere (two-level CL, or CL run ahead of
    the chunk): (Qc, D) + (Qc, P) -> flat residuals (Qc*P, D), the same
    arithmetic as :func:`cl_rc`'s."""
    q = queries.float()
    residual = q[:, None, :] - centroids[probes]
    if rotation is not None:
        ieee_f32_matmul()
        residual = residual @ rotation
    return residual.reshape(probes.shape[0] * probes.shape[1], -1)


def _search_chunk(queries, centroids, codebook, clusters: PaddedClusters,
                  rotation, params: SearchParams):
    probes, flat_res = cl_rc(queries, centroids, rotation, params)
    return dc_ts(lc(flat_res, codebook, params), probes, clusters, params)


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
