"""Clustered synthetic vector corpus (numpy-seeded, bit-exact with the
reference generator).

A mixture of Gaussians quantized to uint8 with SIFT-like statistics and
a Zipfian query distribution over the mixture components, so hot
clusters and skewed cluster sizes appear.  The random stream is numpy's,
so the same seed gives the same bits as the JAX package's generator.

The points are drawn in row chunks: numpy's ``Generator.normal`` stream
does not depend on how it is chunked, so chunking keeps the bits while
bounding host memory (10M x 128 points would otherwise hold ~20 GB of
float64).  The uint8 path needs the global min/max before it can scale,
so it regenerates the stream in a second pass.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.util import resolve_device

_ROW_CHUNK = 1 << 16          # rows of float64 noise held at once


class VectorDataset(NamedTuple):
    points: torch.Tensor        # (N, D) uint8 or f32
    queries: torch.Tensor       # (Q, D) same dtype
    groundtruth: torch.Tensor   # (Q, k_gt) i32 exact neighbours


def _mixture(rng, n, d, n_components, size_skew):
    centers = rng.normal(0.0, 40.0, size=(n_components, d))
    alpha = np.full(n_components, 1.0 / max(size_skew, 1e-3))
    weights = rng.dirichlet(alpha)
    comp = rng.choice(n_components, size=n, p=weights)
    return centers, weights, comp


def _point_chunks(rng, centers, comp, d):
    """Yield (row offset, float64 rows) in draw order."""
    n = comp.shape[0]
    for s in range(0, n, _ROW_CHUNK):
        e = min(s + _ROW_CHUNK, n)
        yield s, centers[comp[s:e]] + rng.normal(0.0, 12.0, size=(e - s, d))


def make_clustered_corpus(seed: int, n: int, d: int, *, n_queries: int = 256,
                          n_components: int = 64, zipf_a: float = 1.3,
                          size_skew: float = 1.0, dtype=torch.uint8,
                          k_gt: int = 0, device="cuda") -> VectorDataset:
    """Mixture-of-Gaussians corpus, returned on ``device``.

    size_skew > 0 draws component weights from a Dirichlet with
    concentration 1/size_skew -> skewed cluster populations.  Queries are
    drawn Zipf(zipf_a) over components -> hot clusters.  ``k_gt`` > 0
    fills exact ground truth with :func:`repro_torch.core.search.exact_search`
    on ``device``.
    """
    if dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"dtype must be torch.uint8 or torch.float32, "
                         f"got {dtype}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers, weights, comp = _mixture(rng, n, d, n_components, size_skew)
    out_np = np.uint8 if dtype == torch.uint8 else np.float32
    pts = np.empty((n, d), out_np)
    lo = hi = None
    for s, rows in _point_chunks(rng, centers, comp, d):
        if dtype == torch.uint8:
            lo = rows.min() if lo is None else min(lo, rows.min())
            hi = rows.max() if hi is None else max(hi, rows.max())
        else:
            pts[s:s + rows.shape[0]] = rows.astype(np.float32)

    # Zipfian query component choice over components ranked by weight;
    # the rng now stands exactly where the unchunked draw would leave it
    rank = np.argsort(-weights)
    zipf_p = 1.0 / np.arange(1, n_components + 1) ** zipf_a
    zipf_p /= zipf_p.sum()
    qcomp = rank[rng.choice(n_components, size=n_queries, p=zipf_p)]
    qs = centers[qcomp] + rng.normal(0.0, 12.0, size=(n_queries, d))

    if dtype == torch.uint8:
        scale = 255.0 / (hi - lo)
        rng2 = np.random.default_rng(seed)
        centers2, _, comp2 = _mixture(rng2, n, d, n_components, size_skew)
        for s, rows in _point_chunks(rng2, centers2, comp2, d):
            pts[s:s + rows.shape[0]] = np.clip(
                np.round((rows - lo) * scale), 0, 255).astype(np.uint8)
        qs = np.clip(np.round((qs - lo) * scale), 0, 255).astype(np.uint8)
    else:
        qs = qs.astype(np.float32)

    points = torch.from_numpy(pts).to(dev)
    queries = torch.from_numpy(qs).to(dev)
    gt = torch.zeros((n_queries, max(k_gt, 1)), dtype=torch.int32, device=dev)
    if k_gt > 0:
        from repro_torch.core.search import exact_search
        _, gt = exact_search(points, queries, k=k_gt)
    return VectorDataset(points, queries, gt)
