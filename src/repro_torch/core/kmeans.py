"""Batched Lloyd k-means in PyTorch: coarse quantizer + PQ sub-codebooks.

Used for (a) the IVF coarse quantizer (``nlist`` centroids over the
corpus) and (b) the per-subspace PQ codebooks (a leading batch axis of M
subspaces, one Lloyd run each, advanced together).

* Empty clusters are re-seeded from the points with the largest distance
  to their assigned centroid ("steal farthest point"), one distinct
  point per empty slot.
* Assignment is chunked over points so the (N, K) distance matrix never
  materialises; one (B, chunk, K) f32 block stays under 1 GiB on the card
  (few, large GEMMs) and 16 MiB on the CPU (cache-sized blocks).
* All float32 GEMMs run in IEEE float32 (no TF32), see
  :func:`repro_torch.util.ieee_f32_matmul`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.util import ieee_f32_matmul

# f32 elements in one distance block, by device type
_CHUNK_ELEMS = {"cuda": 1 << 28, "cpu": 1 << 22}


class KMeansState(NamedTuple):
    centroids: torch.Tensor  # (..., K, D) f32
    assign: torch.Tensor     # (..., N) i32
    obj: torch.Tensor        # (...) f32, mean squared distance (inertia / N)


def l2_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 between rows of x (..., n, d) and y (..., m, d)
    -> (..., n, m).

    The expansion ||x||^2 - 2 x.y + ||y||^2 (one GEMM), clamped at 0
    against cancellation.  Leading axes batch (one GEMM per subspace).
    """
    ieee_f32_matmul()
    x = x.float()
    y = y.float()
    xx = (x * x).sum(-1, keepdim=True)                    # (..., n, 1)
    yy = (y * y).sum(-1).unsqueeze(-2)                    # (..., 1, m)
    d = xx + yy - 2.0 * (x @ y.transpose(-1, -2))
    return d.clamp_min_(0.0)


def chunk_rows(batch: int, k: int, n: int, device: torch.device) -> int:
    """Rows per chunk so a (batch, rows, k) f32 block stays in budget."""
    budget = _CHUNK_ELEMS.get(device.type, _CHUNK_ELEMS["cpu"])
    return max(1, min(n, budget // max(batch * k, 1)))


def _assign_batched(points: torch.Tensor, centroids: torch.Tensor):
    """points (B, N, d), centroids (B, K, d) -> (assign (B, N) i64,
    mindist (B, N) f32)."""
    b, n, _ = points.shape
    chunk = chunk_rows(b, centroids.shape[1], n, points.device)
    assign = torch.empty((b, n), dtype=torch.int64, device=points.device)
    mind = torch.empty((b, n), dtype=torch.float32, device=points.device)
    for s in range(0, n, chunk):
        d = l2_sq(points[:, s:s + chunk], centroids)
        mind[:, s:s + chunk], assign[:, s:s + chunk] = d.min(dim=-1)
    return assign, mind


def assign_chunked(points: torch.Tensor, centroids: torch.Tensor):
    """argmin_k ||p - c_k||^2 for every point, chunked over points.
    -> (assign (N,) i32, mindist (N,) f32)."""
    a, m = _assign_batched(points[None], centroids[None])
    return a[0].int(), m[0]


def _update_step(points: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd step over a batch: points (B, N, d) f32."""
    b, n, d = points.shape
    k = centroids.shape[1]
    assign, mind = _assign_batched(points, centroids)
    flat = (assign + torch.arange(b, device=points.device)[:, None] * k
            ).reshape(-1)
    sums = torch.zeros((b * k, d), dtype=torch.float32, device=points.device)
    sums.index_add_(0, flat, points.reshape(b * n, d))
    counts = torch.bincount(flat, minlength=b * k).float()
    new_c = (sums / counts.clamp_min(1.0)[:, None]).reshape(b, k, d)
    empty = (counts < 0.5).reshape(b, k)
    if bool(empty.any()):
        # steal the farthest points, one per empty slot (ranked), so
        # distinct empties get distinct points
        order = torch.argsort(-mind, dim=1)                   # (B, N)
        rank = (torch.cumsum(empty.int(), dim=1) - 1).clamp(0, n - 1)
        src = torch.gather(order, 1, rank.long())             # (B, K)
        steal = torch.gather(points, 1, src[:, :, None].expand(b, k, d))
        new_c = torch.where(empty[:, :, None], steal, new_c)
    return new_c


def _init_idx(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    if n < k:
        return torch.randint(0, n, (k,), generator=generator)
    return torch.randperm(n, generator=generator)[:k]


def kmeans_multi(points: torch.Tensor, k: int, iters: int = 12, *,
                 generator: torch.Generator) -> KMeansState:
    """Lloyd k-means over a leading batch axis: points (B, N, d) ->
    centroids (B, k, d).  Used for PQ sub-codebooks (one run per
    subspace, shared iteration count, independent initial draws)."""
    b, n, _ = points.shape
    pts = points.float().contiguous()
    init = torch.stack([_init_idx(n, k, generator) for _ in range(b)]
                       ).to(pts.device)
    cents = torch.gather(pts, 1, init[:, :, None].expand(b, k, pts.shape[2]))
    for _ in range(iters):
        cents = _update_step(pts, cents)
    assign, mind = _assign_batched(pts, cents)
    return KMeansState(cents, assign.int(), mind.mean(dim=1))


def kmeans(points: torch.Tensor, k: int, iters: int = 12, *,
           generator: torch.Generator) -> KMeansState:
    """Lloyd k-means. points (N, D) any real dtype -> KMeansState (f32)."""
    st = kmeans_multi(points[None], k, iters, generator=generator)
    return KMeansState(st.centroids[0], st.assign[0], st.obj[0])
