"""The unified ``Index`` handle: the front door, static or live.

The port of ``repro/core/mutable_index.py``.  Two jobs in one handle:

  * **Front door** — ``Index`` owns what the engines used to pass around
    as loose tuples (the CSR ``IVFPQIndex``, the padded
    ``PaddedClusters``, centroids / codebook / rotation, a generation
    counter).  ``IndexSpec.build(points)`` and ``Index.build(generator,
    points, ...)`` construct it; ``.ivf`` / ``.clusters`` expose the
    engine-ready tensors; ``.search`` runs the five-phase pipeline
    directly.  Wrapping a prebuilt ``IVFPQIndex`` is free and
    identity-preserving (``.ivf`` is the same object), so a one-replica
    local service searches exactly what ``search_ivfpq`` searches.

  * **Mutation** — built with ``mutable=True`` (raw vectors retained),
    the handle supports ``upsert(ids, vectors)`` / ``delete(ids)`` and
    generation maintenance.  Upserts assign each vector to its nearest
    live centroid, encode the residual with the live PQ codebooks and
    append it to its cluster's padded rows.  Deletes swap the cluster's
    last live row into the hole and shrink ``sizes[c]``, so ``sizes`` is
    the scan mask: a deleted id is never at a scanned position, and id
    ``-1`` keeps meaning "padding" everywhere.

Generation maintenance (``build_generation`` / ``install_generation``):
clusters outside a size band are split (k-means with k=2 over their
members) or merged away (centroid dropped, members reassigned), the PQ
codebooks are optionally retrained on fresh residuals, and every live
vector is re-assigned and re-encoded, all off the serving path on a
snapshot taken under the handle's lock.  ``install_generation``
reconciles the mutations that landed after the snapshot (ids removed
since, and the ``_touched`` ids re-encoded against the new quantizers),
swaps all state at once and bumps ``generation``.  Plain upserts and
deletes keep LUT caches valid: a LUT depends only on (query, centroid,
codebook), none of which move between generations.

Where the port departs from the reference's data structures (the
semantics are the reference's, operation for operation):

  * The store lives on the index's device: codes (nlist, cap, M) and ids
    (nlist, cap), with a host copy of ids and sizes for the bookkeeping.
    An edit changes the host state at once; ``_Store.flush`` writes the
    touched rows on the device in one scatter.  Tensors handed out by
    ``clusters`` are never written again (engine threads may be mid-batch
    on them): the next edit copies them first.
  * No Python object per row: the id locators are dense int32 tables
    (:class:`_IdMap`), the raw vectors one (slots, D) f32 tensor on the
    device addressed by slot, and a generation's snapshot ids a sorted
    array.  Bulk layouts (from CSR, from groups, back to CSR) are tensor
    ops: a stable sort by cluster reproduces the reference's row order.
  * Splits and PQ retraining draw from a ``torch.Generator`` seeded with
    ``seed`` (the reference: ``jax.random``), so a generation the port
    builds is not the reference's bit for bit; given the same
    ``_Generation``, ``install_generation`` is.

Concurrency: one ``threading.RLock`` guards the mutable state; every
operation that writes device tensors under it synchronises the stream
before releasing it, so a reader on another thread or stream only ever
sees complete tensors.  ``build_generation`` runs outside the lock
(snapshot in, tensors out); only the reconcile in
``install_generation`` holds it.

Tiered storage (``storage="tiered"``, static handles only): the built
codes spill to ``storage_dir`` through a :class:`~repro_torch.storage.
TieredStore` that keeps ``storage_budget_bytes`` of hot clusters on the
index's device; the handle then drops the codes and keeps a lean view
(empty codes and ids, real offsets), and engines fetch probed clusters
through ``tiered_store``.

Not ported: per-vector tenant / tag metadata (``meta``; ROADMAP item 8),
which raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ivf import (IVFPQIndex, PaddedClusters, build_ivfpq,
                                  pad_clusters)
from repro_torch.core.kmeans import assign_chunked, kmeans
from repro_torch.core.pq import PQCodebook, encode_pq, train_pq
from repro_torch.util import ieee_f32_matmul


def _settle(device: torch.device) -> None:
    """Wait for the work queued on this thread's stream, so tensors it
    wrote are complete before another thread (or stream) reads them."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass
class MutationStats:
    """Cumulative mutation counters (one dict row in service stats)."""
    upserts: int = 0
    replaced: int = 0
    deletes: int = 0
    compactions: int = 0
    splits: int = 0
    merges: int = 0
    retrains: int = 0
    generations: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _round_up(n: int, multiple: int) -> int:
    return max(-(-int(n) // multiple) * multiple, multiple)


class _IdMap:
    """id -> a row of ``width`` int32 values, with no Python object per id.

    A dense table over ids [0, len) that grows by half, plus a dict for an
    id far past the live count: any int32 id is legal, and a table
    reaching a huge id would cost memory for every id below it.  An id
    lives in exactly one of the two."""

    def __init__(self, width: int):
        self.tab = np.full((0, width), -1, np.int32)
        self.far: dict = {}
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def _reserve(self, top: int) -> None:
        if top > len(self.tab):
            new = max(top, len(self.tab) + len(self.tab) // 2)
            tab = np.full((new, self.tab.shape[1]), -1, np.int32)
            tab[:len(self.tab)] = self.tab
            self.tab = tab

    def _limit(self, extra: int) -> int:
        """Ids below this go in the dense table (about 4x the ids held)."""
        return max(len(self.tab), 4 * (self.n + extra) + (1 << 16))

    def get(self, pid: int) -> Optional[tuple]:
        if pid < len(self.tab) and self.tab[pid, 0] >= 0:
            return tuple(int(v) for v in self.tab[pid])
        return self.far.get(pid)

    def __contains__(self, pid: int) -> bool:
        return self.get(pid) is not None

    def put(self, pid: int, vals) -> None:
        if pid in self.far or pid >= self._limit(1):
            self.n += pid not in self.far
            self.far[pid] = tuple(int(v) for v in vals)
            return
        self._reserve(pid + 1)
        self.n += int(self.tab[pid, 0] < 0)
        self.tab[pid] = vals

    def pop(self, pid: int) -> Optional[tuple]:
        if pid < len(self.tab) and self.tab[pid, 0] >= 0:
            out = tuple(int(v) for v in self.tab[pid])
            self.tab[pid] = -1
            self.n -= 1
            return out
        out = self.far.pop(pid, None)
        self.n -= out is not None
        return out

    def put_many(self, pids: np.ndarray, vals: np.ndarray) -> None:
        """Bulk insert of ids not held yet (a fresh layout's rows)."""
        pids = np.asarray(pids, np.int64)
        if not len(pids):
            return
        dense = pids < self._limit(len(pids))
        if dense.any():
            self._reserve(int(pids[dense].max()) + 1)
            self.tab[pids[dense]] = vals[dense]
        for pid, row in zip(pids[~dense].tolist(), vals[~dense].tolist()):
            self.far[pid] = tuple(row)
        self.n += len(pids)

    def get_many(self, pids: np.ndarray) -> np.ndarray:
        """(n, width) values of ``pids``, -1 rows for ids not held."""
        pids = np.asarray(pids, np.int64)
        out = np.full((len(pids), self.tab.shape[1]), -1, np.int32)
        inside = (pids >= 0) & (pids < len(self.tab))
        out[inside] = self.tab[pids[inside]]
        if self.far:
            for j in np.nonzero(out[:, 0] < 0)[0]:
                row = self.far.get(int(pids[j]))
                if row is not None:
                    out[j] = row
        return out

    def keys(self) -> np.ndarray:
        """Every id held, ascending (int64)."""
        dense = np.nonzero(self.tab[:, 0] >= 0)[0].astype(np.int64)
        if not self.far:
            return dense
        return np.sort(np.concatenate(
            [dense, np.fromiter(self.far, np.int64, len(self.far))]))


class _Store:
    """The mutable mirror of :class:`PaddedClusters`.

    ``codes`` (nlist, cap, M) and ``ids`` (nlist, cap) i32 live on the
    index's device, ``ids_h`` / ``sizes`` on the host, ``loc`` maps id ->
    (cluster, row).  Rows [0, sizes[c]) are live and contiguous: ``remove``
    swaps the cluster's last live row into the hole (``sizes`` IS the scan
    mask, so a removed id is unreachable the instant it is published).

    ``remove`` / ``append`` / ``_grow`` change the host state at once and
    record in ``_src`` where each touched row's code comes from (a row of
    the device tensor as it was at the last flush, a row of the caller's
    new codes, or zero); ``flush`` writes them in one scatter.  Tensors
    handed out by :meth:`snapshot` are never written again: the next
    ``flush`` copies them first.  ``copied_bytes`` counts the device
    bytes those copies (and growth and compaction) moved."""

    def __init__(self, codes: torch.Tensor, ids: torch.Tensor,
                 sizes: np.ndarray, pad_multiple: int = 8):
        self.codes = codes
        self.ids = ids
        self.ids_h = ids.cpu().numpy().copy()
        self.sizes = np.asarray(sizes, np.int32).copy()
        self.pad_multiple = int(pad_multiple)
        self.loc = _IdMap(2)
        cl, row = np.nonzero(np.arange(self.cap)[None, :]
                             < self.sizes[:, None])
        self.loc.put_many(self.ids_h[cl, row],
                          np.stack([cl, row], 1).astype(np.int32))
        self._src: dict = {}
        self._snapshot: Optional[PaddedClusters] = None
        self._shared = False
        self.copied_bytes = 0

    @property
    def nlist(self) -> int:
        return self.ids_h.shape[0]

    @property
    def cap(self) -> int:
        return self.ids_h.shape[1]

    @property
    def m(self) -> int:
        return self.codes.shape[2]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def n_live(self) -> int:
        return int(self.sizes.sum())

    @classmethod
    def from_csr(cls, codes: torch.Tensor, ids: torch.Tensor,
                 offsets: torch.Tensor, nlist: int,
                 pad_multiple: int = 8) -> "_Store":
        """CSR rows (sorted by cluster) -> a padded store on their device."""
        dev = codes.device
        sizes = (offsets[1:] - offsets[:-1]).long()
        cap = _round_up(int(sizes.max()), pad_multiple)
        cl = torch.repeat_interleave(torch.arange(nlist, device=dev), sizes)
        row = (torch.arange(codes.shape[0], device=dev)
               - offsets[:-1].long()[cl])
        out_codes = torch.zeros((nlist, cap, codes.shape[1]),
                                dtype=codes.dtype, device=dev)
        out_ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
        out_codes[cl, row] = codes
        out_ids[cl, row] = ids.to(dev, torch.int32)
        return cls(out_codes, out_ids, sizes.cpu().numpy(), pad_multiple)

    @classmethod
    def from_groups(cls, assign: torch.Tensor, pids: np.ndarray,
                    codes: torch.Tensor, nlist: int,
                    pad_multiple: int = 8) -> "_Store":
        """Group (assign, pid, code) rows into a fresh store; rows keep
        their input order within a cluster (a stable sort by cluster)."""
        dev = codes.device
        assign = assign.to(dev).long()
        order = torch.sort(assign, stable=True).indices
        sizes = torch.bincount(assign, minlength=nlist)[:nlist]
        offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
        ids = torch.from_numpy(np.asarray(pids, np.int32)).to(dev)
        return cls.from_csr(codes[order], ids[order], offsets, nlist,
                            pad_multiple)

    # -- edits (host state now, device rows at flush) ----------------------
    def _grow(self, needed: int) -> None:
        new_cap = _round_up(max(needed, self.cap + self.cap // 2),
                            self.pad_multiple)
        ids_h = np.full((self.nlist, new_cap), -1, np.int32)
        ids_h[:, :self.cap] = self.ids_h
        self.ids_h = ids_h

    def append(self, c: int, pid: int, j: int) -> None:
        """Append ``pid`` to cluster ``c`` with code row ``j`` of the
        ``new_codes`` the next flush is given."""
        r = int(self.sizes[c])
        if r >= self.cap:
            self._grow(r + 1)
        self.ids_h[c, r] = pid
        self.sizes[c] = r + 1
        self.loc.put(pid, (c, r))
        self._src[(c, r)] = ("new", j)

    def remove(self, pid: int) -> bool:
        """Swap-compact delete: the last live row fills the hole and the
        size mask shrinks -- never a mid-cluster tombstone."""
        at = self.loc.pop(pid)
        if at is None:
            return False
        c, r = at
        last = int(self.sizes[c]) - 1
        if r != last:
            moved = int(self.ids_h[c, last])
            self._src[(c, r)] = self._src.get((c, last), ("old", c, last))
            self.ids_h[c, r] = moved
            self.loc.put(moved, (c, r))
        self.ids_h[c, last] = -1
        self._src[(c, last)] = None
        self.sizes[c] = last
        return True

    def flush(self, new_codes: Optional[torch.Tensor] = None) -> None:
        """Write every row touched since the last flush on the device:
        one gather from the tensor as it was, one scatter into a private
        copy (the tensor itself when no snapshot holds it)."""
        old_codes, old_ids = self.codes, self.ids
        cap0 = old_codes.shape[1]
        if not self._src and self.cap == cap0:
            return
        nbytes = old_codes.numel() * old_codes.element_size() \
            + old_ids.numel() * 4
        if self.cap != cap0:
            codes = old_codes.new_zeros((self.nlist, self.cap, self.m))
            ids = old_ids.new_full((self.nlist, self.cap), -1)
            codes[:, :cap0] = old_codes
            ids[:, :cap0] = old_ids
            self.copied_bytes += nbytes
        elif self._shared:
            codes, ids = old_codes.clone(), old_ids.clone()
            self.copied_bytes += nbytes
        else:
            codes, ids = old_codes, old_ids
        if self._src:
            items = list(self._src.items())
            dst = np.array([c * self.cap + r for (c, r), _ in items],
                           np.int64)
            vals = torch.zeros((len(items), self.m), dtype=codes.dtype,
                               device=codes.device)
            old = [(k, s[1] * cap0 + s[2]) for k, (_, s) in enumerate(items)
                   if s is not None and s[0] == "old"]
            new = [(k, s[1]) for k, (_, s) in enumerate(items)
                   if s is not None and s[0] == "new"]
            for pairs, source in ((old, old_codes.reshape(-1, self.m)),
                                  (new, new_codes)):
                if pairs:
                    at, src = (torch.tensor(x, device=codes.device)
                               for x in zip(*pairs))
                    vals[at] = source[src].to(codes.dtype)
            dst_t = torch.from_numpy(dst).to(codes.device)
            codes.view(-1, self.m)[dst_t] = vals
            ids.view(-1)[dst_t] = torch.from_numpy(
                self.ids_h.reshape(-1)[dst]).to(codes.device)
        self.codes, self.ids = codes, ids
        self._src = {}
        self._snapshot = None
        self._shared = False

    def compact(self) -> bool:
        """Shrink the padded capacity back to the live high-water mark
        (rows are always contiguous, so this is a slice)."""
        new_cap = _round_up(int(self.sizes.max(initial=1)),
                            self.pad_multiple)
        if new_cap >= self.cap:
            return False
        self.flush()
        self.codes = self.codes[:, :new_cap].contiguous()
        self.ids = self.ids[:, :new_cap].contiguous()
        self.ids_h = np.ascontiguousarray(self.ids_h[:, :new_cap])
        self.copied_bytes += (self.codes.numel() * self.codes.element_size()
                              + self.ids.numel() * 4)
        self._snapshot = None
        self._shared = False
        return True

    def snapshot(self) -> PaddedClusters:
        """The current rows as engine-ready :class:`PaddedClusters`
        (published: never written again)."""
        if self._snapshot is None:
            self.flush()
            sizes = torch.from_numpy(self.sizes.copy()).to(self.device)
            _settle(self.device)
            self._snapshot = PaddedClusters(self.codes, self.ids, sizes)
            self._shared = True
        return self._snapshot


class _Generation(NamedTuple):
    """A fully-built next index generation, pending installation."""
    centroids: torch.Tensor
    codebook: PQCodebook
    rotation: Optional[torch.Tensor]
    store: _Store
    snapshot_ids: np.ndarray        # live ids at the snapshot, ascending
    splits: int
    merges: int
    retrained: bool


def _encode(vecs: torch.Tensor, centroids: torch.Tensor, codebook,
            rotation) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid and PQ code of each row: -> (assign i64, codes)."""
    assign = assign_chunked(vecs, centroids)[0].long()
    residual = vecs - centroids[assign]
    if rotation is not None:
        ieee_f32_matmul()
        residual = residual @ rotation
    return assign, encode_pq(codebook, residual)


class Index:
    """The one index handle: spec-built or wrapped, static or mutable.

    Static (default): a zero-copy wrapper over a prebuilt
    :class:`IVFPQIndex` on its device -- ``.ivf`` is the same object,
    ``.clusters`` is ``pad_clusters`` of it (computed once), mutation
    methods raise.

    Mutable (``mutable=True`` + the raw ``points``, rows addressed by the
    index's ids): the handle owns the padded store on the index's device,
    the raw vectors and a generation counter; see the module docstring
    for the mutation and maintenance contracts.
    """

    # per-vector tenant / tag metadata (tenancy, ROADMAP item 8)
    meta = None

    def __init__(self, ivf: IVFPQIndex, *, points=None, mutable: bool = False,
                 compact_threshold: float = 0.5, pad_multiple: int = 8,
                 storage: str = "resident", storage_dir=None,
                 storage_budget_bytes: int = 0,
                 storage_promote_margin: float = 1.25,
                 storage_checksum: bool = True):
        if storage not in ("resident", "tiered"):
            raise ValueError(f"storage must be 'resident' or 'tiered', "
                             f"got {storage!r}")
        if storage == "tiered" and mutable:
            raise ValueError("tiered storage currently requires a static "
                             "index (the spill file is written once; "
                             "upserts would need per-cluster rewrite)")
        self._ivf = ivf
        self.storage = storage
        self.tiered_store = None
        if storage == "tiered":
            self._spill(storage_dir, storage_budget_bytes, pad_multiple,
                        storage_promote_margin, storage_checksum)
        self.mutable = bool(mutable)
        self.generation = 0
        self.stats = MutationStats()
        self.compact_threshold = float(compact_threshold)
        self._lock = threading.RLock()
        self._clusters_cache: Optional[PaddedClusters] = None   # static
        self._csr_cache: Optional[IVFPQIndex] = None            # mutable
        self._view_cache: Optional[IVFPQIndex] = None           # mutable
        if not self.mutable:
            return
        if points is None:
            raise ValueError("a mutable Index needs the raw points (vectors "
                             "are re-encoded during maintenance)")
        dev = ivf.centroids.device
        if len(ivf.ids) and int(ivf.ids.max()) >= len(points):
            raise ValueError(f"index ids reference row {int(ivf.ids.max())} "
                             f"but points has {len(points)} rows")
        self._centroids = ivf.centroids.float()
        self._codebook = ivf.codebook
        self._rotation = ivf.rotation
        self._store = _Store.from_csr(ivf.codes, ivf.ids, ivf.offsets,
                                      ivf.nlist, pad_multiple)
        # raw vectors by slot; an index row's slot is its id (its row of
        # points), a new id takes a freed slot or the next one
        self._vecs = (points.to(device=dev, dtype=torch.float32, copy=True)
                      if isinstance(points, torch.Tensor) else
                      torch.from_numpy(np.array(points, np.float32)).to(dev))
        self._slots = _IdMap(1)
        live = self._store.loc.keys()
        self._slots.put_many(live, live[:, None].astype(np.int32))
        self._free: list = []
        self._next_slot = len(self._vecs)
        self._touched: set = set()
        self._removed_since_compact = 0

    def _spill(self, storage_dir, budget_bytes: int, pad_multiple: int,
               promote_margin: float, checksum: bool) -> None:
        """Spill the wrapped codes to a tiered store on the index's device
        and keep a lean view: centroids / codebook / rotation and the real
        offsets (so ``sizes`` stays honest) with EMPTY codes and ids --
        dropping the reference to the codes is what frees the bytes past
        the budget."""
        from repro_torch.storage import TieredStore
        ivf = self._ivf
        if storage_dir is None:
            raise ValueError("storage='tiered' needs storage_dir (the "
                             "spill directory)")
        if budget_bytes <= 0:
            raise ValueError(f"storage='tiered' needs storage_budget_bytes "
                             f"> 0, got {budget_bytes}")
        if ivf.codes.dtype != torch.uint8:
            raise ValueError(f"tiered storage ships uint8 PQ codes (cb <= "
                             f"256); index codes are {ivf.codes.dtype}")
        self.tiered_store = TieredStore.from_index(
            ivf, storage_dir, budget_bytes=int(budget_bytes),
            pad_multiple=pad_multiple, promote_margin=float(promote_margin),
            checksum=bool(checksum), device=ivf.centroids.device)
        self._ivf = ivf._replace(
            codes=ivf.codes.new_zeros((0, ivf.codes.shape[1])),
            ids=ivf.ids.new_zeros((0,)))

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, generator: torch.Generator, points, *, nlist: int, m: int,
              cb: int = 256, kmeans_iters: int = 12, pq_iters: int = 12,
              opq: bool = False, train_sample: Optional[int] = None,
              mutable: bool = False, compact_threshold: float = 0.5,
              storage: str = "resident", storage_dir=None,
              storage_budget_bytes: int = 0,
              storage_promote_margin: float = 1.25,
              storage_checksum: bool = True, device="cuda") -> "Index":
        """Build from raw (N, D) points (``core.ivf.build_ivfpq`` on
        ``device``, draws from ``generator``) and wrap in a handle.
        ``storage="tiered"`` spills the built codes to ``storage_dir`` and
        keeps ``storage_budget_bytes`` of hot clusters on ``device`` (see
        :mod:`repro_torch.storage.tiered`); static indexes only."""
        if storage not in ("resident", "tiered"):
            raise ValueError(f"storage must be 'resident' or 'tiered', "
                             f"got {storage!r}")
        if isinstance(points, torch.Tensor):
            pts = points
        else:
            host = np.asarray(points)
            pts = torch.from_numpy(host if host.flags.writeable
                                   else host.copy())
        ivf = build_ivfpq(generator, pts, nlist=nlist, m=m, cb=cb,
                          kmeans_iters=kmeans_iters, pq_iters=pq_iters,
                          opq=opq, train_sample=train_sample, device=device)
        return cls(ivf, points=pts if mutable else None, mutable=mutable,
                   compact_threshold=compact_threshold, storage=storage,
                   storage_dir=storage_dir,
                   storage_budget_bytes=storage_budget_bytes,
                   storage_promote_margin=storage_promote_margin,
                   storage_checksum=storage_checksum)

    @classmethod
    def _restore(cls, centroids: torch.Tensor, codebook: PQCodebook,
                 rotation, store: _Store, pids: np.ndarray,
                 vecs: torch.Tensor, *, touched, removed_since_compact: int,
                 generation: int, stats: MutationStats,
                 compact_threshold: float) -> "Index":
        """A mutable handle from its state (``convert.py`` carries a
        reference handle across with it): ``vecs[j]`` is id ``pids[j]``'s
        raw vector."""
        dev = centroids.device
        ivf = IVFPQIndex(centroids, codebook,
                         store.codes.new_zeros((0, store.m)),
                         torch.zeros((0,), dtype=torch.int32, device=dev),
                         torch.zeros((len(centroids) + 1,), dtype=torch.int32,
                                     device=dev), rotation)
        h = cls(ivf, compact_threshold=compact_threshold)
        h.mutable = True
        h._centroids, h._codebook, h._rotation = centroids, codebook, rotation
        h._store = store
        h._vecs = vecs
        h._slots = _IdMap(1)
        h._slots.put_many(pids, np.arange(len(pids), dtype=np.int32)[:, None])
        h._free, h._next_slot = [], len(pids)
        h._touched = set(touched)
        h._removed_since_compact = int(removed_since_compact)
        h.generation = int(generation)
        h.stats = stats
        return h

    # -- read surface ------------------------------------------------------
    @property
    def ivf(self) -> IVFPQIndex:
        """Engine-ready CSR snapshot.  Static: the wrapped object itself
        (identity-preserving).  Mutable: rebuilt after mutations."""
        if not self.mutable:
            return self._ivf
        return self.to_ivfpq()

    @property
    def clusters(self) -> PaddedClusters:
        """Engine-ready padded snapshot (cached until the next mutation;
        never written afterwards)."""
        if not self.mutable:
            if self.tiered_store is not None:
                raise RuntimeError(
                    "a tiered Index holds no resident PaddedClusters (that "
                    "is the point) -- fetch probed clusters through "
                    ".tiered_store.gather(...)")
            if self._clusters_cache is None:
                self._clusters_cache = pad_clusters(self._ivf)
            return self._clusters_cache
        with self._lock:
            return self._store.snapshot()

    @property
    def search_view(self) -> IVFPQIndex:
        """The index the engines route with.  Static: the wrapped one.
        Mutable: a lean view -- centroids / codebook / rotation with empty
        code arrays, so it does not grow with N."""
        if not self.mutable:
            return self._ivf
        if self._view_cache is None:
            with self._lock:
                dev = self._centroids.device
                self._view_cache = IVFPQIndex(
                    self._centroids, self._codebook,
                    torch.zeros((0, self._store.m),
                                dtype=self._store.codes.dtype, device=dev),
                    torch.zeros((0,), dtype=torch.int32, device=dev),
                    torch.zeros((self.nlist + 1,), dtype=torch.int32,
                                device=dev),
                    self._rotation)
        return self._view_cache

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def centroids(self) -> torch.Tensor:
        return self._centroids if self.mutable else self._ivf.centroids

    @property
    def codebook(self) -> PQCodebook:
        return self._codebook if self.mutable else self._ivf.codebook

    @property
    def rotation(self) -> Optional[torch.Tensor]:
        return self._rotation if self.mutable else self._ivf.rotation

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def sizes(self) -> np.ndarray:
        """Live per-cluster sizes on the host -- the scan mask."""
        if not self.mutable:
            return self._ivf.sizes.cpu().numpy()
        return self._store.sizes.copy()

    @property
    def copied_bytes(self) -> int:
        """Device bytes the store has copied so far (copy on write, growth
        and compaction); 0 for a static handle."""
        return self._store.copied_bytes if self.mutable else 0

    def __len__(self) -> int:
        if self.mutable:
            return self._store.n_live
        if self.tiered_store is not None:   # lean view: ids live in the tier
            return int(self.tiered_store.sizes.sum())
        return int(self._ivf.ids.shape[0])

    def __contains__(self, pid) -> bool:
        if not self.mutable:
            if self.tiered_store is not None:
                tier = self.tiered_store
                valid = np.arange(tier.cap)[None, :] < tier.sizes[:, None]
                return bool(np.any(np.asarray(tier._ids_mm)[valid]
                                   == int(pid)))
            return bool((self._ivf.ids == int(pid)).any())
        return int(pid) in self._store.loc

    def live_ids(self) -> np.ndarray:
        """All live point ids (sorted, int64)."""
        if not self.mutable:
            return np.sort(self._ivf.ids.cpu().numpy()).astype(np.int64)
        with self._lock:
            return self._store.loc.keys()

    def vector(self, pid: int) -> np.ndarray:
        self._require_mutable("vector")
        with self._lock:
            at = self._slots.get(int(pid))
            if at is None:
                raise KeyError(pid)
            return self._vecs[at[0]].cpu().numpy().copy()

    def to_ivfpq(self) -> IVFPQIndex:
        """Current state as a CSR :class:`IVFPQIndex` (cached until the
        next mutation) -- what the sharded engine materializes from."""
        if not self.mutable:
            return self._ivf
        if self._csr_cache is not None:
            return self._csr_cache
        with self._lock:
            st = self._store
            st.flush()
            sizes = torch.from_numpy(st.sizes.astype(np.int64)).to(st.device)
            live = (torch.arange(st.cap, device=st.device)[None, :]
                    < sizes[:, None])
            offsets = torch.cat([sizes.new_zeros(1),
                                 torch.cumsum(sizes, 0)]).int()
            self._csr_cache = IVFPQIndex(
                self._centroids, self._codebook, st.codes[live],
                st.ids[live], offsets, self._rotation)
            _settle(st.device)
        return self._csr_cache

    def search(self, queries, params=None, *, nprobe: int = 8, k: int = 10):
        """Front-door search: the five-phase pipeline over the handle's
        current snapshot.  Returns ((Q, k) dists, (Q, k) ids) numpy."""
        from repro_torch.core.search import SearchParams, search_ivfpq
        if params is None:
            params = SearchParams(nprobe=nprobe, k=k, use_kernels=True)
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        d, i = search_ivfpq(self.search_view, self.clusters, q, params)
        return d.cpu().numpy(), i.cpu().numpy()

    # -- mutation ----------------------------------------------------------
    def _require_mutable(self, what: str) -> None:
        if not self.mutable:
            raise RuntimeError(
                f"Index.{what} needs a mutable index -- build with "
                f"IndexSpec.build(points, mutable=True) or "
                f"Index.build(..., mutable=True)")

    def _dirty(self) -> None:
        self._csr_cache = None

    def _write_vectors(self, pids: np.ndarray, vecs: torch.Tensor) -> None:
        """Store each id's vector in its slot (a new id takes a freed slot
        or the next one); a later row of the same id wins."""
        last = {}
        for j, pid in enumerate(pids.tolist()):
            last[pid] = j
        slots, rows = [], []
        for pid, j in last.items():
            at = self._slots.get(pid)
            if at is None:
                slot = self._free.pop() if self._free else self._next_slot
                self._next_slot = max(self._next_slot, slot + 1)
                self._slots.put(pid, (slot,))
            else:
                slot = at[0]
            slots.append(slot)
            rows.append(j)
        if self._next_slot > len(self._vecs):
            grown = self._vecs.new_zeros(
                (max(self._next_slot, len(self._vecs) * 3 // 2),
                 self._vecs.shape[1]))
            grown[:len(self._vecs)] = self._vecs
            self._vecs = grown
        dev = self._vecs.device
        self._vecs[torch.tensor(slots, device=dev)] = \
            vecs[torch.tensor(rows, device=dev)]

    def upsert(self, ids, vectors, tenant=None, tags=None) -> dict:
        """Insert or replace vectors by id: assign to the nearest live
        centroid, encode the residual with the live codebooks, append to
        the cluster's padded rows (an existing id's old row is
        swap-compacted out first).  Rows of one call apply in order, so a
        repeated id's later row wins.  Returns insert/replace counts.
        ``tenant`` / ``tags`` need per-vector metadata (ROADMAP item 8)."""
        self._require_mutable("upsert")
        if tenant is not None or tags is not None:
            raise NotImplementedError("upsert(tenant=/tags=) needs per-"
                                      "vector metadata, not ported to "
                                      "repro_torch yet (ROADMAP item 8)")
        pids = np.asarray(ids, np.int64).reshape(-1)
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if vecs.shape != (len(pids), self.dim):
            raise ValueError(f"upsert expects vectors ({len(pids)}, "
                             f"{self.dim}), got {vecs.shape}")
        if len(pids) == 0:
            return {"n": 0, "inserted": 0, "replaced": 0,
                    "generation": self.generation}
        if pids.min() < 0 or pids.max() >= 2 ** 31:
            raise ValueError("upsert ids must be int32-representable and "
                             ">= 0 (-1 is the padding sentinel)")
        vec_t = torch.from_numpy(vecs).to(self.device)
        while True:
            # encode OUTSIDE the lock against a generation-stamped view;
            # if a maintenance install swaps the quantizers mid-flight,
            # loop and re-encode against the new ones
            gen0 = self.generation
            assign, codes = _encode(vec_t, self._centroids, self._codebook,
                                    self._rotation)
            assign = assign.cpu().numpy()
            with self._lock:
                if self.generation != gen0:
                    continue
                replaced = 0
                for j, pid in enumerate(pids.tolist()):
                    if self._store.remove(pid):
                        replaced += 1
                        self._removed_since_compact += 1
                    self._store.append(int(assign[j]), pid, j)
                    self._touched.add(pid)
                self._store.flush(codes)
                self._write_vectors(pids, vec_t)
                self.stats.upserts += len(pids)
                self.stats.replaced += replaced
                self._dirty()
                _settle(self.device)
                return {"n": len(pids), "inserted": len(pids) - replaced,
                        "replaced": replaced, "generation": self.generation}

    def delete(self, ids) -> int:
        """Remove ids from the live set.  Swap-compact: the size mask
        shrinks immediately, so a deleted id is unreachable by the next
        snapshot -- it never appears in any search result.  Returns how
        many of the given ids were actually live."""
        self._require_mutable("delete")
        pids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            removed = 0
            for pid in pids.tolist():
                if self._store.remove(pid):
                    self._free.append(self._slots.pop(pid)[0])
                    self._touched.discard(pid)
                    removed += 1
            if removed:
                self.stats.deletes += removed
                self._removed_since_compact += removed
                self._store.flush()
                live = self._store.n_live
                if (live > 0 and self._removed_since_compact
                        >= self.compact_threshold * live):
                    if self._store.compact():
                        self.stats.compactions += 1
                    self._removed_since_compact = 0
                self._dirty()
                _settle(self.device)
            return removed

    # -- generation maintenance -------------------------------------------
    def size_band(self, band: Optional[Tuple[int, int]] = None
                  ) -> Tuple[int, int]:
        """Resolve the cluster size band: an explicit (lo, hi), or the
        auto band [mean/4, 4*mean] around the current mean live size."""
        if band is not None:
            lo, hi = int(band[0]), int(band[1])
            if lo < 1 or hi <= lo:
                raise ValueError(f"size band needs 1 <= lo < hi, "
                                 f"got ({lo}, {hi})")
            return lo, hi
        mean = self._store.n_live / max(self.nlist, 1)
        lo = max(1, int(mean / 4))
        hi = max(int(np.ceil(mean * 4)), lo + 1, 8)
        return lo, hi

    def maintenance_plan(self, band: Optional[Tuple[int, int]] = None
                         ) -> dict:
        """Which clusters drifted outside the band right now."""
        self._require_mutable("maintenance_plan")
        lo, hi = self.size_band(band)
        with self._lock:
            sizes = self._store.sizes.copy()
        return {"band": (lo, hi),
                "split": [int(c) for c in np.nonzero(sizes > hi)[0]],
                "merge": [int(c) for c in np.nonzero(sizes < lo)[0]]}

    def build_generation(self, band: Optional[Tuple[int, int]] = None,
                         retrain_pq: bool = True, kmeans_iters: int = 4,
                         pq_iters: int = 4, seed: int = 0,
                         train_sample: int = 16384) -> _Generation:
        """Build the next generation off the serving path.

        Snapshots (ids, vectors) under the lock, then -- lock-free --
        splits oversized clusters (k-means k=2 over members), drops
        undersized centroids (members reassigned to the nearest
        survivor), optionally retrains the PQ codebooks on at most
        ``train_sample`` fresh residuals, and re-encodes every
        snapshotted vector.  Mutations landing after the snapshot are
        reconciled at install time."""
        self._require_mutable("build_generation")
        with self._lock:
            snap_ids = self._store.loc.keys()
            slots = self._slots.get_many(snap_ids)[:, 0]
            snap_vecs = self._vecs[torch.from_numpy(slots.astype(np.int64))
                                   .to(self.device)]
            centroids = self._centroids
            codebook, rotation = self._codebook, self._rotation
            pad_multiple = self._store.pad_multiple
            lo, hi = self.size_band(band)
            # post-snapshot mutations are replayed at install: reset the
            # touched set so only genuinely-newer ids get re-encoded
            self._touched = set()
            _settle(self.device)
        gen = torch.Generator().manual_seed(int(seed))
        nlist = centroids.shape[0]
        if len(snap_ids) == 0:
            store = _Store.from_groups(
                torch.zeros(0, dtype=torch.long, device=self.device),
                snap_ids, self._store.codes.new_zeros((0, codebook.m)),
                nlist)
            return _Generation(centroids, codebook, rotation, store,
                               snap_ids, 0, 0, False)
        assign = assign_chunked(snap_vecs, centroids)[0].long()
        counts = torch.bincount(assign, minlength=nlist).cpu().numpy()
        # the next centroids, in cluster order: a kept centroid, the two
        # halves of a split one, nothing for a merged one
        halves, rows = [], []
        splits = merges = 0
        for c in range(nlist):
            if counts[c] > hi and counts[c] >= 2:
                km = kmeans(snap_vecs[assign == c], k=2, iters=kmeans_iters,
                            generator=gen)
                rows += [nlist + 2 * len(halves), nlist + 2 * len(halves) + 1]
                halves.append(km.centroids)
                splits += 1
            elif counts[c] < lo:
                merges += 1            # dropped; members reassign below
            else:
                rows.append(c)
        if not rows:                   # degenerate: everything undersized
            new_centroids = snap_vecs.mean(dim=0, keepdim=True)
            merges = nlist - 1
        else:
            pool = torch.cat([centroids] + halves)
            new_centroids = pool[torch.tensor(rows, device=self.device)]
        new_centroids = new_centroids.float().contiguous()
        assign2 = assign_chunked(snap_vecs, new_centroids)[0].long()
        residual = snap_vecs - new_centroids[assign2]
        del snap_vecs
        if rotation is not None:
            ieee_f32_matmul()
            residual = residual @ rotation
        retrained = False
        if retrain_pq and len(snap_ids) >= codebook.cb:
            train = residual
            if len(train) > train_sample:
                sel = torch.randperm(len(train), generator=gen)[:train_sample]
                train = train[sel.to(self.device)]
            codebook = train_pq(train, m=codebook.m, cb=codebook.cb,
                                iters=pq_iters, generator=gen)
            retrained = True
        codes = encode_pq(codebook, residual)
        del residual
        store = _Store.from_groups(assign2, snap_ids, codes,
                                   new_centroids.shape[0], pad_multiple)
        _settle(self.device)
        return _Generation(new_centroids, codebook, rotation, store,
                           snap_ids, splits, merges, retrained)

    def install_generation(self, gen: _Generation) -> dict:
        """Reconcile post-snapshot mutations into the built generation,
        then swap all state at once and bump ``generation``.

        Holds the lock for O(churn since the snapshot): ids deleted since
        are removed from the new store (ascending, the order the
        reference's frozenset gives ids below its table size); ids
        inserted or re-upserted since (the ``_touched`` set) are
        re-encoded against the new centroids / codebooks and appended."""
        self._require_mutable("install_generation")
        with self._lock:
            snap = gen.snapshot_ids
            removed = snap[self._store.loc.get_many(snap)[:, 0] < 0]
            stale = sorted(pid for pid in self._touched
                           if pid in self._store.loc)
            for pid in removed.tolist():
                gen.store.remove(pid)
            codes = None
            if stale:
                slots = self._slots.get_many(np.array(stale))[:, 0]
                vecs = self._vecs[torch.from_numpy(
                    slots.astype(np.int64)).to(self.device)]
                assign, codes = _encode(vecs, gen.centroids, gen.codebook,
                                        gen.rotation)
                assign = assign.cpu().numpy()
                for j, pid in enumerate(stale):
                    gen.store.remove(pid)
                    gen.store.append(int(assign[j]), pid, j)
            gen.store.flush(codes)
            self._centroids = gen.centroids
            self._codebook = gen.codebook
            self._rotation = gen.rotation
            self._store = gen.store
            self._touched = set()
            self._removed_since_compact = 0
            self.generation += 1
            self.stats.splits += gen.splits
            self.stats.merges += gen.merges
            self.stats.retrains += int(gen.retrained)
            self.stats.generations += 1
            self._dirty()
            self._view_cache = None
            _settle(self.device)
            return {"generation": self.generation,
                    "nlist": self.nlist,
                    "splits": gen.splits, "merges": gen.merges,
                    "retrained": gen.retrained,
                    "reconciled_upserts": len(stale),
                    "reconciled_deletes": len(removed)}

    def run_maintenance(self, band: Optional[Tuple[int, int]] = None,
                        force: bool = False, retrain_pq: bool = True,
                        seed: int = 0) -> dict:
        """Plan + build + install in one call (the service tier's
        MutationCoordinator runs build on a background thread instead)."""
        plan = self.maintenance_plan(band)
        if not force and not plan["split"] and not plan["merge"]:
            return {"ran": False, "plan": plan}
        gen = self.build_generation(band, retrain_pq=retrain_pq, seed=seed)
        info = self.install_generation(gen)
        return {"ran": True, "plan": plan, **info}
