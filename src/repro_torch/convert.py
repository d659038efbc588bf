"""Carry an index's arrays across from numpy onto the port's tensors.

Both packages can then search the same index: the arrays of a reference
``IVFPQIndex`` / ``PaddedClusters`` / ``ShardedIndex`` go through
``numpy.asarray`` and in here.  A reference mutable ``Index`` handle, and
a ``_Generation`` it built, come across whole (store rows, locator, raw
vectors, quantizers, counters), read attribute by attribute through
numpy, so both packages can then apply the same mutations.  A reference
``Coarse2`` comes across through ``coarse2_from_numpy``.  ``uint16``
codes (CB > 256) become ``int32``, because ``torch.uint16`` has few CUDA
ops; ``uint8`` codes stay ``uint8``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.coarse2 import Coarse2
from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.mutable_index import (Index, MutationStats, _Generation,
                                            _Store)
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


def _codebook(cb, dev) -> PQCodebook:
    return PQCodebook(_t(cb.codebooks, np.float32, dev),
                      _t(cb.sqnorms, np.float32, dev))


def _store_from_reference(st, dev) -> _Store:
    """A reference ``_Store`` -> the port's, on ``dev``.  The port derives
    its locator from the rows; the reference's must say the same."""
    store = _Store(torch.from_numpy(_codes(st.codes).copy()).to(dev),
                   _t(st.ids, np.int32, dev), np.asarray(st.sizes),
                   st.pad_multiple)
    pids = np.fromiter(st.loc, np.int64, len(st.loc))
    want = np.array([st.loc[p] for p in pids.tolist()],
                    np.int32).reshape(-1, 2)
    if (len(store.loc) != len(pids)
            or not np.array_equal(store.loc.get_many(pids), want)):
        raise ValueError("the reference store's locator disagrees with its "
                         "rows")
    return store


def mutable_index_from_reference(handle, *, device="cuda") -> Index:
    """A reference mutable ``repro.core.Index`` -> the port's mutable
    ``Index`` on ``device``, in the same state: store rows, locator, raw
    vectors, centroids, codebook, rotation, the touched set, generation,
    counters and compaction threshold."""
    if not handle.mutable:
        raise ValueError("mutable_index_from_reference needs a mutable "
                         "handle (wrap a static index with Index(ivf))")
    if handle.meta is not None:
        raise NotImplementedError("a handle with per-vector metadata needs "
                                  "tenancy, not ported to repro_torch yet "
                                  "(ROADMAP item 8)")
    dev = resolve_device(device)
    pids = np.array(sorted(handle._vecs), np.int64)
    vecs = (np.stack([handle._vecs[p] for p in pids.tolist()]) if len(pids)
            else np.zeros((0, handle.dim), np.float32))
    rot = handle._rotation
    return Index._restore(
        _t(handle._centroids, np.float32, dev),
        _codebook(handle._codebook, dev),
        None if rot is None else _t(rot, np.float32, dev),
        _store_from_reference(handle._store, dev), pids,
        _t(vecs, np.float32, dev), touched=handle._touched,
        removed_since_compact=handle._removed_since_compact,
        generation=handle.generation,
        stats=MutationStats(**handle.stats.as_dict()),
        compact_threshold=handle.compact_threshold)


def generation_from_reference(gen, *, device="cuda") -> _Generation:
    """A reference ``_Generation`` (built, not installed) -> the port's,
    on ``device``; its snapshot id set becomes a sorted array."""
    dev = resolve_device(device)
    rot = gen.rotation
    return _Generation(_t(gen.centroids, np.float32, dev),
                       _codebook(gen.codebook, dev),
                       None if rot is None else _t(rot, np.float32, dev),
                       _store_from_reference(gen.store, dev),
                       np.array(sorted(gen.snapshot_ids), np.int64),
                       int(gen.splits), int(gen.merges), bool(gen.retrained))


def coarse2_from_numpy(l1_centroids, members, member_centroids, *,
                       device="cuda") -> Coarse2:
    """A reference ``Coarse2``'s fields as numpy arrays (level-1 centroids
    (G, D), member cluster ids (G, gmax) with -1 pad, member centroids
    (G, gmax, D)) -> the port's ``Coarse2`` on ``device``, so both
    packages can route with one grouping (the reference builds it with
    ``jax.random``).  A tiered store needs no converter: both packages
    open the same spill directory."""
    dev = resolve_device(device)
    return Coarse2(_t(l1_centroids, np.float32, dev),
                   _t(members, np.int64, dev),
                   _t(member_centroids, np.float32, dev))
