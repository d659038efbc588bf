"""Carry an index's arrays across from numpy onto the port's tensors.

Both packages can then search the same index: the arrays of a reference
``IVFPQIndex`` / ``PaddedClusters`` / ``ShardedIndex`` go through
``numpy.asarray`` and in here.  ``uint16`` codes (CB > 256) become ``int32``, because
``torch.uint16`` has few CUDA ops; ``uint8`` codes stay ``uint8``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.pq import PQCodebook
from repro_torch.core.sharded_search import ShardedIndex
from repro_torch.util import resolve_device


def _codes(codes) -> np.ndarray:
    codes = np.asarray(codes)
    if codes.dtype == np.uint16:
        return codes.astype(np.int32)
    if codes.dtype not in (np.uint8, np.int32):
        raise TypeError(f"codes must be uint8, uint16 or int32, got "
                        f"{codes.dtype}")
    return codes


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype)).to(dev)


def index_from_numpy(centroids, codebooks, sqnorms, codes, ids, offsets,
                     rotation=None, *, device="cuda") -> IVFPQIndex:
    """IVFPQIndex fields as numpy arrays -> the port's IVFPQIndex on
    ``device``."""
    dev = resolve_device(device)
    rot: Optional[torch.Tensor] = (None if rotation is None
                                   else _t(rotation, np.float32, dev))
    return IVFPQIndex(_t(centroids, np.float32, dev),
                      PQCodebook(_t(codebooks, np.float32, dev),
                                 _t(sqnorms, np.float32, dev)),
                      torch.from_numpy(_codes(codes).copy()).to(dev),
                      _t(ids, np.int32, dev), _t(offsets, np.int32, dev), rot)


def clusters_from_numpy(codes, ids, sizes, *, device="cuda"
                        ) -> PaddedClusters:
    """PaddedClusters fields as numpy arrays -> the port's PaddedClusters
    on ``device``."""
    dev = resolve_device(device)
    return PaddedClusters(torch.from_numpy(_codes(codes).copy()).to(dev),
                          _t(ids, np.int32, dev), _t(sizes, np.int32, dev))


def sharded_index_from_numpy(codes, ids, sizes, cluster_of, start_of,
                             slot_of_instance, centroids, codebooks, sqnorms,
                             rotation=None, *, device="cuda") -> ShardedIndex:
    """ShardedIndex fields as numpy arrays (codes (S, slots, cpart, M),
    ids (S, slots, cpart), sizes / cluster_of / start_of (S, slots),
    slot_of_instance (n_instances,), then the replicated centroids,
    codebook and rotation) -> the port's ShardedIndex on ``device``."""
    dev = resolve_device(device)
    rot: Optional[torch.Tensor] = (None if rotation is None
                                   else _t(rotation, np.float32, dev))
    return ShardedIndex(torch.from_numpy(_codes(codes).copy()).to(dev),
                        _t(ids, np.int32, dev), _t(sizes, np.int32, dev),
                        _t(cluster_of, np.int32, dev),
                        _t(start_of, np.int32, dev),
                        np.array(slot_of_instance, np.int64),
                        _t(centroids, np.float32, dev),
                        PQCodebook(_t(codebooks, np.float32, dev),
                                   _t(sqnorms, np.float32, dev)), rot)
