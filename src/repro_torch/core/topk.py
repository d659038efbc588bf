"""Top-k selection (the paper's TS phase)."""

from __future__ import annotations

import torch


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """k smallest along the last axis, ascending.
    Returns (dists (..., k), ids (..., k))."""
    d, idx = torch.topk(dists, k, dim=-1, largest=False, sorted=True)
    return d, torch.gather(ids, -1, idx)


def merge_topk(d1, i1, d2, i2, k: int):
    """Merge two (..., k') candidate lists -> k smallest."""
    return topk_smallest(torch.cat([d1, d2], -1), torch.cat([i1, i2], -1), k)
