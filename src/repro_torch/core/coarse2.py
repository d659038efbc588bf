"""Two-level coarse quantizer: CL over group metadata, not all centroids.

The port of ``repro/core/coarse2.py``.  Flat CL (``core.search.
cluster_locate``) prices every query against all ``nlist`` centroids.  A
second k-means level over the centroids themselves ranks ``n_groups``
level-1 centroids first, then scores only the clusters of the top
``nprobe1`` groups: ``Q x (G + nprobe1 * gmax) x D`` instead of ``Q x
nlist x D``.  With ``nprobe1 == n_groups`` the candidate set is every
cluster, so the probe *set* equals flat CL's up to near-ties at the
nprobe-th centroid (the two GEMMs sum in different orders); a smaller
``nprobe1`` trades recall for routing cost as ``nprobe`` trades recall
for scan cost.

On the card the level-2 step gathers ``(Q, nprobe1 * gmax, D)`` f32
member centroids, so :func:`coarse2_locate` runs the queries in blocks
sized by bytes, each zero-padded to one fixed row count: a query's probes
then do not depend on the size of the batch it rode in (as flat CL's
fixed block).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans
from repro_torch.util import ieee_f32_matmul

# bytes of gathered member centroids one locate block may hold
BLOCK_BYTES = 1 << 29


class Coarse2(NamedTuple):
    """Group-level routing metadata over an index's cluster centroids."""
    l1_centroids: torch.Tensor      # (G, D) f32 -- level-1 (group) centroids
    members: torch.Tensor           # (G, gmax) i64 cluster ids, -1 pad
    member_centroids: torch.Tensor  # (G, gmax, D) f32 -- gathered L2 rows

    @property
    def n_groups(self) -> int:
        return self.l1_centroids.shape[0]

    @property
    def gmax(self) -> int:
        return self.members.shape[1]


def build_coarse2(generator: torch.Generator, centroids: torch.Tensor,
                  n_groups: Optional[int] = None, iters: int = 8) -> Coarse2:
    """k-means over the cluster centroids (on their device, drawing from
    ``generator``) -> grouped routing metadata.

    ``n_groups`` defaults to ``ceil(sqrt(nlist))`` (balances the two
    levels' GEMM costs).  Member lists hold each group's clusters in
    ascending id order, padded with -1 to the largest group.
    """
    cents = centroids.float()
    nlist = cents.shape[0]
    if n_groups is None:
        n_groups = max(int(math.ceil(math.sqrt(nlist))), 1)
    n_groups = min(int(n_groups), nlist)
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    km = kmeans(cents, k=n_groups, iters=iters, generator=generator)
    assign = km.assign.cpu().numpy().astype(np.int64)
    counts = np.bincount(assign, minlength=n_groups)
    gmax = max(int(counts.max()), 1)
    order = np.argsort(assign, kind="stable")        # by group, then id
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(nlist) - starts[assign[order]]
    members = np.full((n_groups, gmax), -1, np.int64)
    members[assign[order], rank] = order
    # gathered member centroid rows; pad rows are zero (their distances
    # are masked to +inf in locate)
    dev = cents.device
    idx = torch.from_numpy(members).to(dev)
    member_cents = cents[idx.clamp_min(0)].masked_fill(idx[..., None] < 0,
                                                       0.0)
    return Coarse2(km.centroids, idx, member_cents)


def _block_rows(coarse: Coarse2, nprobe1: int, block: int) -> int:
    """Rows of one locate block: ``block`` split into as few equal blocks
    as keep the gathered member centroids within :data:`BLOCK_BYTES`."""
    per_query = nprobe1 * coarse.gmax * coarse.l1_centroids.shape[1] * 4
    n_blocks = -(-int(block) // max(1, BLOCK_BYTES // per_query))
    return -(-int(block) // n_blocks)


@torch.no_grad()
def coarse2_locate(coarse: Coarse2, queries: torch.Tensor, *, nprobe: int,
                   nprobe1: int, block: int = 256):
    """Two-level CL: (Q, D) -> probe ids (Q, nprobe) i64 + centroid
    distances, nearest first.

    Same contract as :func:`repro_torch.core.search.cluster_locate`; only
    the top ``nprobe1`` groups' member centroids are scored.  Distances
    use the same ``||q||^2 - 2 q.c + ||c||^2`` expansion (clamped at 0)
    as ``kmeans.l2_sq``, in IEEE f32.  Queries run in blocks of at most
    ``block`` rows (fewer when the gathered member centroids would pass
    :data:`BLOCK_BYTES`), each zero-padded to the same row count.
    """
    ieee_f32_matmul()
    nprobe1 = min(int(nprobe1), coarse.n_groups)
    rows = _block_rows(coarse, nprobe1, block)
    q_all = queries.to(coarse.l1_centroids.device).float()
    l1 = coarse.l1_centroids
    l1_sq = (l1 * l1).sum(-1)[None, :]
    mc = coarse.member_centroids
    mc_sq = (mc * mc).sum(-1)                                 # (G, gmax)
    probes, dists = [], []
    for s in range(0, q_all.shape[0], rows):
        n = min(rows, q_all.shape[0] - s)
        q = torch.nn.functional.pad(q_all[s:s + n], (0, 0, 0, rows - n))
        qq = (q * q).sum(-1, keepdim=True)                       # (B, 1)
        # level 1: rank groups
        d1 = qq + l1_sq - 2.0 * (q @ l1.T)
        groups = torch.topk(d1, nprobe1, dim=-1, largest=False,
                            sorted=True).indices                 # (B, G1)
        # level 2: score only the selected groups' members
        cand = coarse.members[groups].reshape(rows, -1)          # (B, S)
        cc = mc[groups].reshape(rows, cand.shape[1], -1)        # (B, S, D)
        d2 = (qq + mc_sq[groups].reshape(rows, -1)
              - 2.0 * torch.bmm(cc, q[:, :, None])[:, :, 0])
        d2 = d2.clamp_min_(0.0).masked_fill_(cand < 0, float("inf"))
        nd, idx = torch.topk(d2[:n], nprobe, dim=-1, largest=False,
                             sorted=True)
        probes.append(torch.gather(cand[:n], 1, idx))
        dists.append(nd)
    if not probes:
        dev = q_all.device
        return (torch.zeros((0, nprobe), dtype=torch.int64, device=dev),
                torch.zeros((0, nprobe), device=dev))
    return torch.cat(probes), torch.cat(dists)


def routing_rows_touched(nlist: int, n_groups: int, gmax: int,
                         nprobe1: int) -> int:
    """Centroid-metadata rows one query's CL reads: flat = ``nlist``;
    two-level = ``n_groups + nprobe1 * gmax``."""
    del nlist
    return int(n_groups) + int(nprobe1) * int(gmax)
