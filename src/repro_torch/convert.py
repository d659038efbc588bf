"""Carry an index's arrays across from numpy onto the port's tensors.

Both packages can then search the same index: the arrays of a reference
``IVFPQIndex`` / ``PaddedClusters`` / ``ShardedIndex`` go through
``numpy.asarray`` and in here.  A reference mutable ``Index`` handle, and
a ``_Generation`` it built, come across whole (store rows, locator, raw
vectors, quantizers, counters), read attribute by attribute through
numpy, so both packages can then apply the same mutations.  A reference
``Coarse2`` comes across through ``coarse2_from_numpy``, and a
reference ``VectorMeta`` (per-vector tenants and tags) through
``vector_meta_from_reference``, a reference ``QuantizedCodebook`` (the
multiplier-less path) through ``quantized_codebook_from_numpy``; a
reference DPQ codebook is an ordinary ``PQCodebook``.  ``uint16``
codes (CB > 256) become ``int32``, because ``torch.uint16`` has few CUDA
ops; ``uint8`` codes stay ``uint8``.

LM weights and AdamW state cross in both directions
(``lm_params_from_numpy`` / ``lm_params_to_numpy``,
``adamw_state_from_numpy`` / ``adamw_state_to_numpy``): the reference
stacks a model's groups on a leading axis, the port keeps a list.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.coarse2 import Coarse2
from repro_torch.core.filter import VectorMeta
from repro_torch.core.ivf import IVFPQIndex, PaddedClusters
from repro_torch.core.multiplierless import QuantizedCodebook
from repro_torch.core.mutable_index import (Index, MutationStats, _Generation,
                                            _Store)
from repro_torch.core.pq import PQCodebook
from repro_torch.core.sharded_search import ShardedIndex
from repro_torch.models.transformer import group_structure
from repro_torch.optim.adamw import AdamWState
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
    counters and compaction threshold; a handle's ``meta`` comes across
    with :func:`vector_meta_from_reference`."""
    if not handle.mutable:
        raise ValueError("mutable_index_from_reference needs a mutable "
                         "handle (wrap a static index with Index(ivf))")
    dev = resolve_device(device)
    pids = np.array(sorted(handle._vecs), np.int64)
    vecs = (np.stack([handle._vecs[p] for p in pids.tolist()]) if len(pids)
            else np.zeros((0, handle.dim), np.float32))
    rot = handle._rotation
    out = Index._restore(
        _t(handle._centroids, np.float32, dev),
        _codebook(handle._codebook, dev),
        None if rot is None else _t(rot, np.float32, dev),
        _store_from_reference(handle._store, dev), pids,
        _t(vecs, np.float32, dev), touched=handle._touched,
        removed_since_compact=handle._removed_since_compact,
        generation=handle.generation,
        stats=MutationStats(**handle.stats.as_dict()),
        compact_threshold=handle.compact_threshold)
    if handle.meta is not None:
        out.meta = vector_meta_from_reference(handle.meta)
    return out


def vector_meta_from_reference(meta) -> VectorMeta:
    """A reference ``VectorMeta`` -> the port's, with the same host tables
    (tenant_of, tags, cluster_of), ``tag_fields`` and ``version``.  The
    tables are read through numpy, so this takes any object with those
    attributes."""
    out = VectorMeta(tag_fields=int(meta.tag_fields))
    out.tenant_of = np.array(meta.tenant_of, np.int32)
    out.tags = np.array(meta.tags, np.uint32).reshape(
        len(out.tenant_of), out.tag_fields)
    out.cluster_of = np.array(meta.cluster_of, np.int32)
    out.version = int(meta.version)
    return out


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


def quantized_codebook_from_numpy(codebooks_q, scale, sq, *, device="cuda"
                                  ) -> QuantizedCodebook:
    """A reference ``QuantizedCodebook``'s fields as numpy arrays (int32
    codebook (M, CB, dsub), the f32 scale, the int32 square table) -> the
    port's on ``device``, so both packages build integer tables from one
    quantization."""
    dev = resolve_device(device)
    return QuantizedCodebook(_t(codebooks_q, np.int32, dev),
                             _t(scale, np.float32, dev).reshape(()),
                             _t(sq, np.int32, dev))


def _leaf(x, dev) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy bf16 in torch
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(cfg, tree, *, device="cuda") -> dict:
    """A reference LM parameter tree (leaves anything ``numpy.asarray``
    reads, bf16 included) -> the port's tree on ``device``, each leaf in
    its own dtype.  The reference's ``groups`` leaves carry a leading
    ``n_groups`` axis; the port keeps a list of per-group dicts.
    ``tail{i}`` and ``encoder`` come across as they are."""
    dev = resolve_device(device)

    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        return _leaf(node if index is None else np.asarray(node)[index], dev)

    out = {k: conv(v) for k, v in tree.items() if k != "groups"}
    _, n_groups, _ = group_structure(cfg)
    if n_groups:
        out["groups"] = [conv(tree["groups"], g) for g in range(n_groups)]
    return out


def lm_params_to_numpy(cfg, tree) -> dict:
    """The port's LM tree (or any tree of its structure: grads, AdamW
    moments) -> the reference's structure as numpy arrays, ``groups``
    stacked on a leading axis.  bf16 / f16 become f32 (numpy has no bf16;
    the widening is exact): cast to the reference's dtype on its side."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy().copy()

    out = {k: conv(v) for k, v in tree.items() if k != "groups"}
    _, n_groups, _ = group_structure(cfg)
    if n_groups:
        per_group = [conv(g) for g in tree["groups"]]
        out["groups"] = _stack(per_group)
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def adamw_state_from_numpy(cfg, state, *, device="cuda") -> AdamWState:
    """A reference ``AdamWState`` (step, mu, nu; leaves anything
    ``numpy.asarray`` reads) -> the port's: the step a 0-dim int32 CPU
    tensor, the moments f32 on ``device`` in the port's structure."""
    mu = lm_params_from_numpy(cfg, state.mu, device=device)
    nu = lm_params_from_numpy(cfg, state.nu, device=device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32)
    return AdamWState(step, mu, nu)


def adamw_state_to_numpy(cfg, state: AdamWState):
    """The port's ``AdamWState`` -> ``(step, mu, nu)`` in the reference's
    structure as numpy (step an int32 scalar array), for
    ``repro.optim.adamw.AdamWState(*...)``."""
    return (np.asarray(int(state.step), np.int32),
            lm_params_to_numpy(cfg, state.mu),
            lm_params_to_numpy(cfg, state.nu))
