"""IVF-PQ index construction and the padded cluster layout.

Build pipeline (Faiss IVFPQ / the paper's engine):
  1. coarse k-means over the corpus (or a training sample) -> nlist
     centroids
  2. residual = point - centroid[assign]
  3. PQ-train on residuals (or OPQ rotation first), encode all residuals
  4. group codes by cluster (CSR)

``pad_clusters`` turns the CSR into the dense (nlist, cmax, M) layout
the scan reads, with a size array for masking.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.kmeans import assign_chunked, kmeans
from repro_torch.core.pq import (PQCodebook, decode_pq, encode_pq, train_opq,
                                 train_pq)
from repro_torch.util import resolve_device


class IVFPQIndex(NamedTuple):
    """Flat (CSR-ish) index: codes sorted by cluster id."""
    centroids: torch.Tensor     # (nlist, D) f32
    codebook: PQCodebook
    codes: torch.Tensor         # (N, M) u8/i32, sorted by cluster
    ids: torch.Tensor           # (N,) i32, original point ids, same order
    offsets: torch.Tensor       # (nlist + 1,) i32, CSR row offsets
    rotation: Optional[torch.Tensor] = None   # (D, D) if OPQ

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def sizes(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]


class PaddedClusters(NamedTuple):
    """Dense padded layout: what the scan reads."""
    codes: torch.Tensor     # (ncls, cmax, M) u8/i32
    ids: torch.Tensor       # (ncls, cmax) i32, -1 in padding
    sizes: torch.Tensor     # (ncls,) i32

    @property
    def cmax(self) -> int:
        return self.codes.shape[1]


def build_ivfpq(generator: torch.Generator, points: torch.Tensor, *,
                nlist: int, m: int, cb: int = 256, kmeans_iters: int = 12,
                pq_iters: int = 12, opq: bool = False,
                train_sample: Optional[int] = None, device="cuda"
                ) -> IVFPQIndex:
    """Build an IVF-PQ(-OPQ) index over ``points`` (N, D) on ``device``.

    ``generator`` (a CPU :class:`torch.Generator`) draws the training
    sample and every k-means initialisation, so a seed gives the same
    draws on any device.  Coarse k-means trains on ``train_sample``
    points when that is smaller than N; PQ trains on all residuals.
    """
    dev = resolve_device(device)
    points = points.to(dev)
    n = points.shape[0]
    train_pts = points
    if train_sample is not None and train_sample < n:
        sel = torch.randperm(n, generator=generator)[:train_sample]
        train_pts = points[sel.to(dev)]

    centroids = kmeans(train_pts, k=nlist, iters=kmeans_iters,
                       generator=generator).centroids
    del train_pts
    assign = assign_chunked(points, centroids)[0].long()
    residuals = points.float() - centroids[assign]

    rotation = None
    if opq:
        opq_cb = train_opq(residuals, m=m, cb=cb, pq_iters=pq_iters,
                           generator=generator)
        rotation = opq_cb.rotation
        residuals = residuals @ rotation
        codebook = opq_cb.pq
    else:
        codebook = train_pq(residuals, m=m, cb=cb, iters=pq_iters,
                            generator=generator)

    codes = encode_pq(codebook, residuals)                     # (N, M)
    del residuals
    # group by cluster: stable sort by assignment
    order = torch.sort(assign, stable=True).indices
    sizes = torch.bincount(assign, minlength=nlist)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)]).int()
    return IVFPQIndex(centroids, codebook, codes[order], order.int(), offsets,
                      rotation)


def pad_clusters(index: IVFPQIndex, cmax: Optional[int] = None,
                 pad_multiple: int = 8) -> PaddedClusters:
    """CSR -> dense padded (nlist, cmax, M) on the index's device.  Done
    once offline, on the host."""
    sizes = index.sizes.cpu().numpy()
    offsets = index.offsets.cpu().numpy()
    codes = index.codes.cpu().numpy()
    ids = index.ids.cpu().numpy()
    nlist, m = index.nlist, codes.shape[1]
    if cmax is None:
        cmax = int(sizes.max(initial=1))
    cmax = max(int(cmax), 1)
    cmax = -(-cmax // pad_multiple) * pad_multiple
    out_codes = np.zeros((nlist, cmax, m), dtype=codes.dtype)
    out_ids = np.full((nlist, cmax), -1, dtype=np.int32)
    for c in range(nlist):
        s = min(int(sizes[c]), cmax)
        out_codes[c, :s] = codes[offsets[c]:offsets[c] + s]
        out_ids[c, :s] = ids[offsets[c]:offsets[c] + s]
    dev = index.codes.device
    return PaddedClusters(
        torch.from_numpy(out_codes).to(dev), torch.from_numpy(out_ids).to(dev),
        torch.from_numpy(np.minimum(sizes, cmax).astype(np.int32)).to(dev))


def reconstruct(index: IVFPQIndex, point_rank: torch.Tensor) -> torch.Tensor:
    """Approximate reconstruction of the point stored at sorted rank r:
    centroid + decoded residual (un-rotated if OPQ)."""
    cl = torch.searchsorted(index.offsets, point_rank, right=True) - 1
    res = decode_pq(index.codebook, index.codes[point_rank][None])[0]
    if index.rotation is not None:
        res = res @ index.rotation.T
    return index.centroids[cl] + res
