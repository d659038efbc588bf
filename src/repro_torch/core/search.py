"""Single-device five-phase cluster-based ANNS pipeline (paper Fig. 1).

    CL  cluster locating      q x centroids GEMM + top-nprobe
    RC  residual computation  q - centroid[probe]
    LC  LUT construction      build_lut_batch (or the lut_build kernel)
    DC  distance calculation  adc scan (or the pq_scan kernel)
    TS  top-k sorting         torch.topk (or the ts_topk kernel)

``use_kernels=True`` routes LC/DC/TS through ``repro_torch.kernels.ops``:
the hand-written CUDA kernels on CUDA tensors, their plain versions on
CPU tensors.

DC reads each probed cluster where it lies in the ``PaddedClusters``
(by slot); TS looks its winners' ids up.  Each phase runs inside its
span (:func:`repro_torch.obs.span`: ``drim.cl``, ``drim.rc``,
``drim.lc``, ``drim.dc``, ``drim.ts``; a scoped chunk adds
``drim.gather``, the copy of the probed clusters' ids its mask reads),
and DC counts the rows it scans (``dc.rows_scanned``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
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
    with obs.span("drim.cl"):
        q = queries
        if block is not None:
            q = torch.nn.functional.pad(queries,
                                        (0, 0, 0, block - len(queries)))
        d = l2_sq(q, centroids)[:len(queries)]
        dist, idx = torch.topk(d, nprobe, dim=-1, largest=False, sorted=True)
    return idx, dist


def cluster_locate_masked(queries: torch.Tensor, centroids: torch.Tensor,
                          nprobe: int, allowed: torch.Tensor,
                          block: Optional[int] = None):
    """CL over a per-query cluster mask (tenant namespaces).

    ``allowed`` (Q, nlist) bool: disallowed centroids rank ``+inf``, so a
    tenant's probes land on its member clusters first; allowed clusters
    keep their distances, so the ranking is that of a dedicated index
    holding only those clusters.  The GEMM runs on the same fixed block as
    :func:`cluster_locate`'s, so an all-true row gives plain CL's probes
    bit for bit.  When nprobe exceeds a tenant's member count the surplus
    probes fall on disallowed clusters, whose rows the scope mask strikes
    anyway."""
    with obs.span("drim.cl"):
        q = queries
        if block is not None:
            q = torch.nn.functional.pad(queries,
                                        (0, 0, 0, block - len(queries)))
        d = l2_sq(q, centroids)[:len(queries)].masked_fill(~allowed,
                                                            float("inf"))
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
    with obs.span("drim.lc"):
        if params.use_kernels:
            from repro_torch.kernels import ops as kops
            if quantized:                 # LC with fused quantize epilogue
                return kops.lut_build_q(flat_res, codebook.codebooks,
                                        codebook.sqnorms)
            return kops.lut_build(flat_res, codebook.codebooks,
                                  codebook.sqnorms)
        lut = build_lut_batch(codebook, flat_res)
        return quantize_lut(lut) if quantized else lut


def dc_ts(lut, probes: torch.Tensor, clusters: PaddedClusters,
          params: SearchParams, mask=None):
    """DC + TS over one chunk's tables: ``lut`` (Qc*P, M, CB) f32 or a
    (Qc*P,)-batched QuantizedLUT, one row per (query, probe) in
    ``probes`` order -> ((Qc, k) dists, (Qc, k) ids).  ``mask``: as
    :func:`dc_ts_tasks`'.

    DC reads each probed cluster's codes and size where they lie in
    ``clusters`` (the DC kernels by slot; the plain version from a copy),
    and TS turns each winner's position back into its id, so the padded
    rows are never copied.  With ``use_kernels`` and k <= ``MAX_K_PAD``
    (256) TS is :func:`~repro_torch.kernels.ops.ts_topk`, which on the
    card reads only each task's real rows; otherwise (a larger k too) it
    is its plain version, ``torch.topk`` over every row.  With ``mask``
    the mask reads every candidate's id, so the probed clusters' ids are
    gathered (``drim.gather``).  The answers are :func:`dc_ts_tasks`' on the
    gathered codes, ids and sizes, bit for bit."""
    from repro_torch.kernels import ops as kops
    qc = probes.shape[0]
    flat_probes = probes.reshape(-1)
    slots = flat_probes.int()
    dists = _dc(lut, clusters.codes, clusters.sizes, params, slots=slots)
    if mask is not None:
        with obs.span("drim.gather"):
            ids = clusters.ids.index_select(0, flat_probes)       # (QcP, C)
        return _ts(dists, ids, qc, params, mask)
    with obs.span("drim.ts"):
        if params.use_kernels and params.k <= kops.MAX_K_PAD:
            return kops.ts_topk(dists, slots, clusters.sizes, clusters.ids,
                                qc, params.k)
        return kops.ts_topk_plain(dists, slots, clusters.ids, qc, params.k)


def dc_ts_tasks(lut, codes: torch.Tensor, ids: torch.Tensor,
                sizes: torch.Tensor, qc: int, params: SearchParams,
                mask=None):
    """DC + TS over pre-gathered task tensors: codes (Qc*P, C, M), ids
    (Qc*P, C), sizes (Qc*P,), one task per (query, probe) in probe order
    -> ((Qc, k) dists, (Qc, k) ids).  The tiered path fetches these rows
    from its store; bytes equal to the probed clusters' give
    :func:`dc_ts`'s results.

    ``mask`` (a function of the (Qc, P*C) candidate distances and ids
    returning the distances with out-of-scope rows at ``+inf``, e.g. a
    :class:`repro_torch.core.filter.Scope`'s) runs between DC and TS, and
    the ids of non-finite winners become -1: the reference's scoped
    DC/TS (tenant namespaces and predicate filters)."""
    return _ts(_dc(lut, codes, sizes, params), ids, qc, params, mask)


def _dc(lut, codes: torch.Tensor, sizes: torch.Tensor, params: SearchParams,
        slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DC: a (T, C) row of distances per task, T = len(codes), or with
    ``slots`` ((T,) probe ids) T = len(slots) and task t scans code slot
    ``slots[t]`` (one outside the clusters: size 0, as
    :func:`~repro_torch.kernels.ops.gather_slots` has it for both routes);
    counts the T * C rows it is launched over."""
    tasks = codes.shape[0] if slots is None else slots.shape[0]
    obs.count("dc.rows_scanned", tasks * codes.shape[1])
    with obs.span("drim.dc"):
        if params.use_kernels:
            from repro_torch.kernels import ops as kops
            return kops.pq_scan_dc(
                lut, codes, sizes, strategy=params.strategy,
                slots=None if slots is None else slots.int())
        if slots is not None:
            from repro_torch.kernels.ops import gather_slots
            codes, _, sizes = gather_slots(codes, None, sizes, slots)
        if isinstance(lut, QuantizedLUT):
            return adc_distances_quantized(lut, codes, sizes,
                                           params.strategy)
        return adc_distances(lut, codes, sizes, params.strategy)


def _ts(dists: torch.Tensor, ids: torch.Tensor, qc: int,
        params: SearchParams, mask=None):
    """TS: per query over all its probed candidates, the mask (if any)
    first; a masked chunk's non-finite winners get id -1."""
    with obs.span("drim.ts"):
        cand_d = dists.reshape(qc, -1)
        cand_i = ids.reshape(qc, -1)
        if mask is None:
            return topk_smallest(cand_d, cand_i, params.k)
        bd, bi = topk_smallest(mask(cand_d, cand_i), cand_i, params.k)
        return bd, bi.masked_fill(~torch.isfinite(bd), -1)


def rc_from_probes(queries: torch.Tensor, centroids: torch.Tensor, rotation,
                   probes: torch.Tensor) -> torch.Tensor:
    """RC for probes routed elsewhere (two-level CL, or CL run ahead of
    the chunk): (Qc, D) + (Qc, P) -> flat residuals (Qc*P, D), the same
    arithmetic as :func:`cl_rc`'s."""
    with obs.span("drim.rc"):
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
