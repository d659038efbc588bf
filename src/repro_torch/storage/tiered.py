"""Tiered cluster storage: heat-driven card / host residency for PQ codes.

The port of ``repro/storage/tiered.py``.  The full padded cluster arrays
-- codes ``(nlist, cap, M)`` u8 and ids ``(nlist, cap)`` i32, exactly the
:class:`~repro_torch.core.ivf.PaddedClusters` layout -- are spilled once
to files on the host (crash-safe via :func:`repro_torch.util.
atomic_write`), and only a *resident set* of hot clusters is held on the
card under an explicit byte budget.  On an H100 the two tiers are:

  * **resident: a slab in device memory.**  ``n_slots = budget_bytes //
    (cap * (M + 4))`` whole-cluster slots, ``_hot_codes (n_slots, cap, M)``
    u8 and ``_hot_ids (n_slots, cap)`` i32 on the store's ``device``.  The
    bookkeeping (``_slot_of``, ``_cluster_of``, ``sizes``, the CRC lists)
    stays on the host as numpy arrays; a device copy of ``_slot_of`` is
    refreshed whenever residency changes, and the gather reads it.
  * **cold: the spill files**, ``codes.u8`` / ``ids.i32`` raw
    little-endian arrays plus a ``meta.json`` with shapes, sizes, byte
    counts and per-cluster ``zlib.crc32`` checksums: the reference's
    format byte for byte, so a spill either package writes opens in the
    other.  They are read through ``np.memmap``.

``gather(cluster_ids)`` returns device tensors: hot rows are gathered
from the slab on the card by slot; cold rows are deduplicated and read
in one fancy-indexed read into a pinned host buffer, CRC-checked there
(re-read once on a mismatch, quarantined if the second read fails too),
copied to the card in one transfer and scattered into the output.  The
output is byte-identical to ``pad_clusters(...)``'s rows for the same
cluster ids, so residency can never change a search result, only its
cost.

:class:`ResidencyController` is the policy, driven by the same
:class:`~repro_torch.runtime.cache.OnlineHeatEstimator` units as layout
and cache admission: it promotes clusters whose probe heat exceeds the
coldest resident's by a hysteresis margin and demotes the coldest to
make room; the budget is never exceeded, by construction.

Self-verification: every cold fetch and every promotion is CRC-checked
before its bytes can reach a scan or the slab; ``open`` validates file
sizes against ``meta.json`` before mapping and then checks every
cluster; a demotion re-verifies the spill row and rebuilds it from the
slab (a copy from the card) when it has rotted; an unrepairable cluster
is quarantined and surfaces as :class:`CorruptClusterError` naming it.

Threads and streams: replicas share one store, so one ``RLock`` guards
it.  A slab gather is only *enqueued* on the card under the lock, and a
promotion on another thread could otherwise overwrite that slot before
the gather runs; every operation that reads or writes the slab (or the
pinned staging buffer) therefore synchronises its stream before it
releases the lock.

Chaos hooks (:mod:`repro_torch.runtime.faults`): ``faults`` is None
by default; armed with a ``FaultInjector``, every gather consults
``tier.spill_corrupt`` under the lock before its slab gather (a firing
rots one cluster's spill bytes through ``corrupt_spill``), and the cold
fetch consults ``tier.cold_read`` (a strict gather raises
:class:`InjectedIOError`, an ``IOError``; a degraded one drops every
cold row, which comes out as zero codes, ids -1 and size 0 on the card).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
import time
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime.cache import OnlineHeatEstimator
from repro_torch.runtime.faults import InjectedFault
from repro_torch.util import (atomic_write, atomic_write_text, next_pow2,
                              resolve_device)

_CODES_FILE = "codes.u8"
_IDS_FILE = "ids.i32"
_META_FILE = "meta.json"
_CHECKSUM_ALGO = "crc32"          # stdlib zlib.crc32


class TieredStoreError(RuntimeError):
    """Damaged or inconsistent on-disk tier state (fails by name)."""


class CorruptClusterError(TieredStoreError):
    """A cluster's spill bytes fail checksum verification."""

    def __init__(self, cluster: int, detail: str = ""):
        self.cluster = int(cluster)
        super().__init__(f"cluster {self.cluster} failed checksum "
                         f"verification" + (f" ({detail})" if detail else ""))


class InjectedIOError(InjectedFault, OSError):
    """The injected ``tier.cold_read`` failure of a strict gather: an
    ``IOError`` (callers catch it as the reference's), and an
    :class:`InjectedFault`, so a chaos run tells it from a real one by
    type."""


def _crc_rows(arr: np.ndarray) -> list:
    """Per-cluster CRC over each leading-axis row's raw bytes."""
    return [zlib.crc32(np.ascontiguousarray(arr[i]))
            for i in range(arr.shape[0])]


def _settle(device: torch.device) -> None:
    """Wait for the work queued on this thread's stream (slab gathers and
    writes, the staging copy) before the store's lock is released."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass
class TierStats:
    """Cumulative fetch-path + residency-churn + integrity counters."""
    hot_hits: int = 0          # probed clusters served from the slab
    cold_fetches: int = 0      # unique cold clusters read from the spill
    cold_requests: int = 0     # probed clusters that were cold (pre-dedup)
    cold_bytes: int = 0        # bytes read from the spill
    promotions: int = 0
    demotions: int = 0
    crc_failures: int = 0      # checksum mismatches observed (any path)
    rebuilds: int = 0          # spill regions rewritten from the slab
    degraded_gathers: int = 0  # gathers that dropped probes (fault/budget)
    dropped_probes: int = 0    # probe rows dropped across degraded gathers

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def probes(self) -> int:
        return self.hot_hits + self.cold_requests

    @property
    def hot_rate(self) -> float:
        return self.hot_hits / self.probes if self.probes else 0.0


class ResidencyController:
    """Promote/demote policy over observed probe heat.

    Wraps an :class:`OnlineHeatEstimator` (shared with layout/admission --
    one heat vector, one unit).  ``plan(resident_mask, n_slots)`` returns
    the (promote, demote) cluster lists that move the resident set toward
    the top-``n_slots``-by-heat clusters, with hysteresis: a cold cluster
    displaces the coldest resident only when ``heat[cold] >
    promote_margin * heat[victim]``, so one-off scans cannot thrash
    residency.  Free slots are filled unconditionally.
    """

    def __init__(self, estimator: OnlineHeatEstimator,
                 promote_margin: float = 1.25):
        if promote_margin < 1.0:
            raise ValueError(f"promote_margin must be >= 1, "
                             f"got {promote_margin}")
        self.estimator = estimator
        self.promote_margin = float(promote_margin)

    def observe(self, probe_lists: np.ndarray) -> None:
        self.estimator.observe(probe_lists)

    def plan(self, resident_mask: np.ndarray,
             n_slots: int) -> Tuple[list, list]:
        """-> (promote, demote) cluster-id lists; |promote| - |demote| =
        free slots consumed, so applying them never exceeds the budget."""
        heat = self.estimator.heat()
        resident = np.nonzero(resident_mask)[0]
        cold = np.nonzero(~resident_mask)[0]
        if n_slots <= 0 or cold.size == 0:
            return [], []
        promote: list = []
        demote: list = []
        # hottest cold first; coldest resident is the standing victim
        cold = cold[np.argsort(-heat[cold], kind="stable")]
        victims = list(resident[np.argsort(heat[resident],
                                           kind="stable")])
        free = n_slots - resident.size
        for c in cold:
            if free > 0:
                promote.append(int(c))
                free -= 1
                continue
            if not victims:
                break
            v = victims[0]
            if heat[c] > self.promote_margin * heat[v] + 1e-12:
                promote.append(int(c))
                demote.append(int(victims.pop(0)))
            else:
                break          # neither this nor any colder cold qualifies
        return promote, demote


class TieredStore:
    """Hot-on-the-card / cold-on-the-host padded cluster storage.

    The array contract is exactly :class:`~repro_torch.core.ivf.
    PaddedClusters` (the same ``pad_multiple`` capacity rounding), so a
    gather from this store is byte for byte what the all-resident
    engine's ``clusters.codes[flat_probes]`` gather produces.

    Residency is slot-based: ``n_slots = budget_bytes //
    bytes_per_cluster`` rows of a preallocated slab on ``device``, so
    ``resident_bytes <= budget_bytes`` is an invariant, not a goal.

    ``checksum=True`` (default) arms self-verification: per-cluster CRCs
    are recorded in ``meta.json`` at spill time, every cold fetch,
    promotion and demotion re-verifies, and ``verify()`` scrubs the whole
    tier.
    """

    def __init__(self, directory, codes: np.ndarray, ids: np.ndarray,
                 sizes: np.ndarray, *, budget_bytes: int,
                 estimator: Optional[OnlineHeatEstimator] = None,
                 promote_margin: float = 1.25,
                 heat_halflife_batches: float = 64.0,
                 checksum: bool = True, device="cuda"):
        codes = np.ascontiguousarray(codes, np.uint8)
        ids = np.ascontiguousarray(ids, np.int32)
        sizes = np.ascontiguousarray(sizes, np.int32)
        if codes.ndim != 3 or ids.shape != codes.shape[:2] \
                or sizes.shape != codes.shape[:1]:
            raise ValueError(f"inconsistent cluster arrays: codes "
                             f"{codes.shape}, ids {ids.shape}, sizes "
                             f"{sizes.shape}")
        self._setup(directory, codes.shape, sizes, budget_bytes, checksum,
                    device)
        self._codes_crc = _crc_rows(codes)
        self._ids_crc = _crc_rows(ids)
        self._spill(codes, ids)
        self._attach(estimator, promote_margin, heat_halflife_batches,
                     codes, ids)

    def _setup(self, directory, shape, sizes: np.ndarray, budget_bytes: int,
               checksum: bool, device) -> None:
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, "
                             f"got {budget_bytes}")
        self.device = resolve_device(device)
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.nlist, self.cap, self.m = (int(s) for s in shape)
        self.sizes = sizes                      # tiny; always on the host
        self.budget_bytes = int(budget_bytes)
        self.checksum = bool(checksum)
        self.stats = TierStats()
        self.quarantined: set = set()           # cluster ids, unrepairable
        self._lock = threading.RLock()
        # EWMA of measured per-cluster cold-fetch seconds: feeds the
        # engine's "can the cold fetch make the deadline?" estimate
        self._cold_s_per_cluster = 2e-4
        # host seconds of the cold fetch path, by part
        self.fetch_s = {"cold_read": 0.0, "crc": 0.0, "to_device": 0.0}
        self._stage: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.faults = None                      # FaultInjector | None
        self.fault_corrupted: list = []         # clusters the site rotted

    def _attach(self, estimator, promote_margin: float,
                heat_halflife_batches: float, codes_src, ids_src) -> None:
        """Map the spill, allocate the slab on the card and seed it."""
        shape = (self.nlist, self.cap, self.m)
        self._codes_mm = np.memmap(self.dir / _CODES_FILE, np.uint8,
                                   mode="r", shape=shape)
        self._ids_mm = np.memmap(self.dir / _IDS_FILE, np.int32, mode="r",
                                 shape=shape[:2])
        self.n_slots = min(self.budget_bytes // self.bytes_per_cluster,
                           self.nlist)
        ns = max(self.n_slots, 1)
        dev = self.device
        self._slot_of = np.full(self.nlist, -1, np.int64)
        self._cluster_of = np.full(ns, -1, np.int64)
        self._slot_of_dev = torch.full((self.nlist,), -1, dtype=torch.int64,
                                       device=dev)
        self._hot_codes = torch.zeros((ns, self.cap, self.m),
                                      dtype=torch.uint8, device=dev)
        self._hot_ids = torch.full((ns, self.cap), -1, dtype=torch.int32,
                                   device=dev)
        self.controller = ResidencyController(
            estimator or OnlineHeatEstimator(
                self.nlist, halflife_batches=heat_halflife_batches),
            promote_margin=promote_margin)
        # seed residency deterministically: largest clusters first (the
        # best prior before traffic -- big clusters cost the most to
        # fetch), ties by cluster id
        order = np.argsort(-self.sizes.astype(np.int64), kind="stable")
        seed = order[:self.n_slots]
        with self._lock:
            self._write_slots(np.arange(seed.size), seed,
                              np.take(codes_src, seed, axis=0),
                              np.take(ids_src, seed, axis=0))
            self._publish()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_clusters(cls, clusters, directory, *, budget_bytes: int,
                      **kwargs) -> "TieredStore":
        """Spill a :class:`PaddedClusters` (tensors on any device, or
        numpy arrays)."""
        host = [x.cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in clusters]
        return cls(directory, *host, budget_bytes=budget_bytes, **kwargs)

    @classmethod
    def from_index(cls, index, directory, *, budget_bytes: int,
                   pad_multiple: int = 8, **kwargs) -> "TieredStore":
        """Spill an :class:`IVFPQIndex` via the canonical padding (built
        on the host: the full padded tensors never go to the card)."""
        from repro_torch.core.ivf import pad_clusters
        host = index._replace(codes=index.codes.cpu(), ids=index.ids.cpu(),
                              offsets=index.offsets.cpu())
        return cls.from_clusters(pad_clusters(host,
                                              pad_multiple=pad_multiple),
                                 directory, budget_bytes=budget_bytes,
                                 **kwargs)

    @classmethod
    def open(cls, directory, *, budget_bytes: int, checksum: bool = True,
             estimator: Optional[OnlineHeatEstimator] = None,
             promote_margin: float = 1.25,
             heat_halflife_batches: float = 64.0,
             device="cuda") -> "TieredStore":
        """Re-open a previously spilled directory (the restart path).

        Validates the on-disk state *before* anything is mapped: a
        missing ``meta.json``, a truncated or oversized payload file, or a
        meta/shape mismatch raises :class:`TieredStoreError` naming the
        file; with ``checksum=True`` every cluster is then CRC-verified
        against the recorded checksums and the first flipped-byte cluster
        raises :class:`CorruptClusterError` with its id.  The payload
        files are served in place, not rewritten; without recorded (or
        checked) checksums, ``meta.json`` is rewritten with the CRCs of
        the bytes as opened.
        """
        directory = pathlib.Path(directory)
        meta_path = directory / _META_FILE
        if not meta_path.exists():
            raise TieredStoreError(f"{meta_path} is missing -- not a "
                                   f"spilled tier directory (or the "
                                   f"spill never completed)")
        try:
            meta = json.loads(meta_path.read_text())
        except ValueError as e:
            raise TieredStoreError(f"{meta_path} is not valid JSON: {e}") \
                from e
        for key in ("codes_shape", "sizes"):
            if key not in meta:
                raise TieredStoreError(f"{meta_path} is missing required "
                                       f"key {key!r}")
        shape = tuple(int(s) for s in meta["codes_shape"])
        if len(shape) != 3:
            raise TieredStoreError(f"{meta_path}: codes_shape must have "
                                   f"3 dims, got {list(shape)}")
        sizes = np.asarray(meta["sizes"], np.int32)
        if sizes.shape != shape[:1]:
            raise TieredStoreError(f"{meta_path}: sizes has "
                                   f"{sizes.shape[0]} entries but "
                                   f"codes_shape names {shape[0]} clusters")
        expected = {_CODES_FILE: int(np.prod(shape)),
                    _IDS_FILE: int(np.prod(shape[:2])) * 4}
        for fname, want in expected.items():
            fpath = directory / fname
            if not fpath.exists():
                raise TieredStoreError(f"{fpath} is missing (meta.json "
                                       f"expects {want} bytes)")
            got = fpath.stat().st_size
            if got != want:
                kind = "truncated" if got < want else "oversized"
                raise TieredStoreError(f"{fpath} is {kind}: {got} bytes "
                                       f"on disk, meta.json expects "
                                       f"{want}")
        codes = np.memmap(directory / _CODES_FILE, np.uint8, mode="r",
                          shape=shape)
        ids = np.memmap(directory / _IDS_FILE, np.int32, mode="r",
                        shape=shape[:2])
        recorded = checksum and "codes_crc" in meta and "ids_crc" in meta
        if recorded:
            codes_crc, ids_crc = meta["codes_crc"], meta["ids_crc"]
            for c in range(shape[0]):
                if zlib.crc32(codes[c]) != codes_crc[c]:
                    raise CorruptClusterError(c, f"codes payload in "
                                              f"{directory / _CODES_FILE}")
                if zlib.crc32(ids[c]) != ids_crc[c]:
                    raise CorruptClusterError(c, f"ids payload in "
                                              f"{directory / _IDS_FILE}")
        store = cls.__new__(cls)
        store._setup(directory, shape, sizes, budget_bytes, checksum, device)
        if recorded:
            store._codes_crc, store._ids_crc = list(codes_crc), list(ids_crc)
        else:
            store._codes_crc, store._ids_crc = _crc_rows(codes), _crc_rows(ids)
            store._write_meta()
        store._attach(estimator, promote_margin, heat_halflife_batches,
                      codes, ids)
        return store

    def _spill(self, codes: np.ndarray, ids: np.ndarray) -> None:
        """Write the full cold tier atomically (tmp + fsync + rename per
        file, meta last): a crash mid-spill leaves the directory either
        absent or fully readable."""
        with atomic_write(self.dir / _CODES_FILE, "wb") as f:
            f.write(memoryview(codes).cast("B"))
        with atomic_write(self.dir / _IDS_FILE, "wb") as f:
            f.write(memoryview(ids).cast("B"))
        self._write_meta()

    def _write_meta(self) -> None:
        atomic_write_text(self.dir / _META_FILE, json.dumps({
            "codes_shape": [self.nlist, self.cap, self.m],
            "codes_dtype": "uint8", "ids_dtype": "int32",
            "codes_bytes": self.nlist * self.cap * self.m,
            "ids_bytes": self.nlist * self.cap * 4,
            "checksum_algo": _CHECKSUM_ALGO,
            "codes_crc": self._codes_crc, "ids_crc": self._ids_crc,
            "sizes": [int(s) for s in self.sizes]}, indent=1))

    # -- accounting --------------------------------------------------------
    @property
    def bytes_per_cluster(self) -> int:
        """Device cost of one resident cluster: padded u8 codes + i32 ids."""
        return self.cap * self.m + self.cap * 4

    @property
    def total_bytes(self) -> int:
        """Full index code bytes (what an all-resident engine holds)."""
        return self.nlist * self.bytes_per_cluster

    @property
    def resident_bytes(self) -> int:
        return int((self._slot_of >= 0).sum()) * self.bytes_per_cluster

    @property
    def resident_mask(self) -> np.ndarray:
        """(nlist,) bool -- True where the cluster is on the card."""
        return self._slot_of >= 0

    def estimate_cold_seconds(self, n_cold: int) -> float:
        """Predicted wall seconds to fetch ``n_cold`` unique cold
        clusters, from the online EWMA of measured cold-fetch cost (read,
        CRC and copy to the card) -- the engine's input to the deadline/degrade decision."""
        return float(n_cold) * self._cold_s_per_cluster

    def serving_info(self) -> dict:
        return dict(self.stats.as_dict(),
                    hot_rate=round(self.stats.hot_rate, 4),
                    resident_clusters=int((self._slot_of >= 0).sum()),
                    resident_bytes=self.resident_bytes,
                    budget_bytes=self.budget_bytes,
                    total_bytes=self.total_bytes, n_slots=self.n_slots,
                    checksum=self.checksum,
                    quarantined=sorted(self.quarantined))

    # -- integrity ---------------------------------------------------------
    def _row_offsets(self, c: int) -> Tuple[int, int, int, int]:
        """(codes_off, codes_len, ids_off, ids_len) byte ranges of one
        cluster's spill regions."""
        codes_len = self.cap * self.m
        ids_len = self.cap * 4
        return c * codes_len, codes_len, c * ids_len, ids_len

    def _rows_ok(self, c: int, codes_row, ids_row) -> bool:
        return (zlib.crc32(codes_row) == self._codes_crc[c]
                and zlib.crc32(ids_row) == self._ids_crc[c])

    def _spill_row_ok(self, c: int) -> bool:
        """CRC-check cluster ``c``'s on-disk bytes against the meta."""
        return self._rows_ok(c, self._codes_mm[c], self._ids_mm[c])

    def _evict(self, c: int) -> None:
        slot = int(self._slot_of[c])
        self._slot_of[c] = -1
        self._cluster_of[slot] = -1

    def _rewrite_from_slab(self, c: int) -> None:
        """Rebuild cluster ``c``'s spill regions from its copy on the card
        (in-place region write: the data being replaced is already
        corrupt, so non-atomicity cannot make it worse).  The slab copy is
        verified against the recorded CRC first: a "heal" that rewrites
        rotten bytes would report success while the cluster stays
        corrupt."""
        slot = int(self._slot_of[c])
        if slot < 0:
            raise CorruptClusterError(c, "no resident copy to rebuild from")
        codes_payload = self._hot_codes[slot].cpu().numpy()
        ids_payload = self._hot_ids[slot].cpu().numpy()
        if not self._rows_ok(c, codes_payload, ids_payload):
            self.stats.crc_failures += 1
            self.quarantined.add(int(c))
            # evict the rotten resident copy: hot hits are served
            # unchecked, so it must not stay in the slab
            self._evict(c)
            raise CorruptClusterError(c, "resident copy also fails "
                                      "checksum; refusing to rebuild "
                                      "from it")
        co, _, io_, _ = self._row_offsets(c)
        for fname, off, payload in ((_CODES_FILE, co, codes_payload),
                                    (_IDS_FILE, io_, ids_payload)):
            with open(self.dir / fname, "r+b") as f:
                f.seek(off)
                f.write(memoryview(payload).cast("B"))
                f.flush()
                os.fsync(f.fileno())
        self.stats.rebuilds += 1
        self.quarantined.discard(int(c))

    def corrupt_spill(self, c: int, nbytes: int = 8) -> None:
        """Flip ``nbytes`` of cluster ``c``'s on-disk codes region (the
        ``tier.spill_corrupt`` chaos effect, also used directly by the
        damage tests).  Deterministic: XORs with 0xFF."""
        co, cl, _, _ = self._row_offsets(int(c))
        n = min(int(nbytes), cl)
        with open(self.dir / _CODES_FILE, "r+b") as f:
            f.seek(co)
            raw = f.read(n)
            f.seek(co)
            f.write(bytes(b ^ 0xFF for b in raw))
            f.flush()
            os.fsync(f.fileno())

    def verify(self, *, repair: bool = True, strict: bool = False) -> dict:
        """Scrub every cluster's spill bytes against the recorded CRCs.

        Corrupt clusters with a copy on the card are rebuilt in place when
        ``repair=True``; corrupt cold clusters are quarantined (degraded
        gathers drop them, strict gathers raise).  Returns ``{checked,
        corrupt, rebuilt, quarantined}``; with ``strict=True`` an
        unrepairable cluster raises :class:`CorruptClusterError` instead.
        """
        with self._lock:
            corrupt, rebuilt, quarantined = [], [], []
            try:
                for c in range(self.nlist):
                    if self._spill_row_ok(c):
                        self.quarantined.discard(c)
                        continue
                    corrupt.append(c)
                    self.stats.crc_failures += 1
                    healed = False
                    if repair and self._slot_of[c] >= 0:
                        try:
                            self._rewrite_from_slab(c)
                            rebuilt.append(c)
                            healed = True
                        except CorruptClusterError:
                            pass    # resident copy rotten too: fall through
                    if not healed:
                        self.quarantined.add(c)
                        quarantined.append(c)
                        if strict:
                            raise CorruptClusterError(c, "no intact copy "
                                                      "to rebuild from")
            finally:
                self._publish()
            return {"checked": self.nlist, "corrupt": corrupt,
                    "rebuilt": rebuilt, "quarantined": quarantined}

    # -- residency ---------------------------------------------------------
    def _write_slots(self, slots, cids, codes_rows: np.ndarray,
                     ids_rows: np.ndarray) -> None:
        """Copy whole clusters into slab slots in one transfer each for
        codes and ids, and record them (the caller publishes)."""
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return
        dev = self.device
        idx = torch.from_numpy(slots).to(dev)
        self._hot_codes.index_copy_(
            0, idx, torch.from_numpy(np.ascontiguousarray(codes_rows)).to(dev))
        self._hot_ids.index_copy_(
            0, idx, torch.from_numpy(np.ascontiguousarray(ids_rows)).to(dev))
        self._slot_of[np.asarray(cids, np.int64)] = slots
        self._cluster_of[slots] = np.asarray(cids, np.int64)

    def _publish(self) -> None:
        """Refresh the device copy of ``_slot_of`` and wait for the slab
        writes, before the lock is released."""
        self._slot_of_dev.copy_(torch.from_numpy(self._slot_of))
        _settle(self.device)

    def _promote_many(self, cids: Sequence[int], slot: Optional[int] = None
                      ) -> int:
        """The reference's ``promote`` for each of ``cids`` in order, with
        one spill read and one copy to the card for all of them.  Returns
        the number promoted; the caller publishes."""
        cids = [int(c) for c in cids]
        if not cids or self.n_slots == 0:
            return 0
        rows_c = np.take(self._codes_mm, cids, axis=0)   # one batched read
        rows_i = np.take(self._ids_mm, cids, axis=0)
        free = (list(np.nonzero(self._cluster_of[:self.n_slots] < 0)[0])
                if slot is None else [int(slot)])
        taken, keep = [], []
        for j, c in enumerate(cids):
            if self._slot_of[c] >= 0 or c in self.quarantined:
                continue           # resident, or never promote rotten bytes
            if self.checksum and not self._rows_ok(c, rows_c[j], rows_i[j]):
                # the slab is the trusted tier (hot hits are served
                # unchecked), so rotten spill bytes must never enter it
                self.stats.crc_failures += 1
                self.quarantined.add(c)
                continue
            if not free:
                continue
            s = int(free.pop(0))
            self._slot_of[c] = s
            self._cluster_of[s] = c
            taken.append(s)
            keep.append(j)
            self.stats.promotions += 1
        self._write_slots(taken, [cids[j] for j in keep], rows_c[keep],
                          rows_i[keep])
        return len(taken)

    def promote(self, c: int, slot: Optional[int] = None) -> bool:
        with self._lock:
            ok = self._promote_many([c], slot) == 1
            self._publish()
            return ok

    def _demote(self, c: int) -> bool:
        if self._slot_of[c] < 0:
            return False
        if self.checksum and not self._spill_row_ok(c):
            self.stats.crc_failures += 1
            try:
                self._rewrite_from_slab(c)
            except CorruptClusterError:
                # both copies rotten: the rebuild evicted the slab copy and
                # left the cluster quarantined, so the cold path drops or
                # raises instead of serving the bytes
                pass
        if self._slot_of[c] >= 0:
            self._evict(c)
        self.stats.demotions += 1
        return True

    def demote(self, c: int) -> bool:
        """Drop ``c`` from the slab.  With checksums armed this is the
        last moment a good copy provably exists, so the spill bytes are
        verified first and rebuilt from the slab on mismatch --
        corruption-while-resident self-heals instead of surfacing later
        as a cold-read quarantine."""
        with self._lock:
            out = self._demote(int(c))
            self._publish()
            return out

    def observe(self, probe_lists: np.ndarray) -> None:
        """Fold one served batch's CL output into the heat estimate and
        apply the controller's promote/demote plan.  Caller pre-slices
        padding rows (same contract as the heat estimator)."""
        probe_lists = np.asarray(probe_lists)
        if probe_lists.size == 0:
            return
        with self._lock:
            self.controller.observe(probe_lists)
            promote, demote = self.controller.plan(self.resident_mask,
                                                   self.n_slots)
            for v in demote:
                self._demote(v)
            self._promote_many(promote)
            self._publish()

    def peek(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """Residency-aware read of one cluster's padded (codes, ids) as
        host arrays, WITHOUT touching stats or residency (the offline
        materialize path must not count as serving traffic).  Cold reads
        are still checksum-verified: shard tensors built from rotten bytes
        would serve wrong results for the cluster's whole lifetime."""
        with self._lock:
            c = int(c)
            slot = int(self._slot_of[c])
            if slot >= 0:
                return (self._hot_codes[slot].cpu().numpy(),
                        self._hot_ids[slot].cpu().numpy())
            self._check_cold(c, "detected during peek")
            return np.asarray(self._codes_mm[c]), np.asarray(self._ids_mm[c])

    def _check_cold(self, c: int, detail: str) -> None:
        if self.checksum and not self._spill_row_ok(c):
            self.stats.crc_failures += 1
            self.quarantined.add(c)
            raise CorruptClusterError(c, detail)

    def resident_snapshot(self):
        """(resident mask, slot of each cluster, slab codes, slab ids) on
        the host, the slab in one copy from the card: the sharded
        engine's materialize reads every resident instance from it
        instead of one synchronised copy per instance."""
        with self._lock:
            return (self.resident_mask.copy(), self._slot_of.copy(),
                    self._hot_codes.cpu().numpy(),
                    self._hot_ids.cpu().numpy())

    # -- fetch path --------------------------------------------------------
    def gather(self, cluster_ids) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """Batched residency-aware fetch: (T,) cluster ids -> device
        tensors (codes (T, cap, M) u8, ids (T, cap) i32, sizes (T,) i32).

        Hot rows come from the slab on the card; cold rows are
        deduplicated and read from the spill in one fancy-indexed read per
        call.  Output bytes are independent of residency.  Strict:
        cold-read failures and checksum mismatches raise (``IOError`` /
        :class:`CorruptClusterError`); the degraded path is
        :meth:`gather_degraded`."""
        codes, ids, sizes, _ = self._gather(cluster_ids, resident_only=False,
                                            degrade=False)
        return codes, ids, sizes

    def gather_degraded(self, cluster_ids, *, resident_only: bool = False):
        """Fail-operational fetch: like :meth:`gather` plus a (T,) bool
        host ``dropped`` mask.  Cold probes that cannot be served -- tier
        read errors, quarantined / corrupt clusters, or *all* cold probes
        when ``resident_only=True`` (deadline pressure) -- come back with
        ``sizes == 0``, zero codes and ids -1 instead of raising, so the
        scan's size masking yields a result exact over what was
        scanned."""
        return self._gather(cluster_ids, resident_only=resident_only,
                            degrade=True)

    def _gather(self, cluster_ids, *, resident_only: bool, degrade: bool):
        if isinstance(cluster_ids, torch.Tensor):
            cids_dev = cluster_ids.reshape(-1).to(self.device, torch.int64)
            cids = cluster_ids.reshape(-1).cpu().numpy().astype(np.int64)
        else:
            cids = np.asarray(cluster_ids, np.int64).reshape(-1)
            cids_dev = torch.from_numpy(cids).to(self.device)
        t = cids.shape[0]
        dev = self.device
        with self._lock:
            if self.faults is not None:
                rule = self.faults.fire("tier.spill_corrupt")
                if rule is not None:
                    self._fire_spill_corrupt(rule)
            # every row from the slab by slot (cold rows read slot 0 and
            # are overwritten below): one gather on the card
            src = self._slot_of_dev.index_select(0, cids_dev).clamp_min_(0)
            out_codes = self._hot_codes.index_select(0, src)
            out_ids = self._hot_ids.index_select(0, src)
            hot = self._slot_of[cids] >= 0
            self.stats.hot_hits += int(hot.sum())
            dropped = np.zeros(t, bool)
            cold_rows = np.nonzero(~hot)[0]
            if cold_rows.size:
                try:
                    self._fetch_cold(cids, cold_rows, out_codes, out_ids,
                                     dropped, resident_only, degrade)
                except BaseException:
                    _settle(dev)     # a strict gather that raises leaves
                    raise            # no slab gather in flight either
            sizes = self.sizes[cids].copy()
            if dropped.any():
                n_drop = int(dropped.sum())
                sizes[dropped] = 0          # size masking: contribute 0
                rows = torch.from_numpy(np.nonzero(dropped)[0]).to(dev)
                out_codes.index_fill_(0, rows, 0)
                out_ids.index_fill_(0, rows, -1)
                self.stats.degraded_gathers += 1
                self.stats.dropped_probes += n_drop
            sizes_dev = torch.from_numpy(sizes).to(dev)
            _settle(dev)
            return out_codes, out_ids, sizes_dev, dropped

    def _staging(self, rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host buffers for ``rows`` cold clusters (pinned when the store
        lives on the card, so the copy is one DMA), grown to a power of
        two and reused: the copy out of them completes before the lock is
        released."""
        if self._stage is None or self._stage[0].shape[0] < rows:
            pin = self.device.type == "cuda"
            n = next_pow2(rows)
            self._stage = (
                torch.empty((n, self.cap, self.m), dtype=torch.uint8,
                            pin_memory=pin),
                torch.empty((n, self.cap), dtype=torch.int32,
                            pin_memory=pin))
        return self._stage[0].numpy()[:rows], self._stage[1].numpy()[:rows]

    def _fetch_cold(self, cids, cold_rows, out_codes, out_ids, dropped,
                    resident_only: bool, degrade: bool) -> None:
        if resident_only:
            dropped[cold_rows] = True
            return
        if self.faults is not None \
                and self.faults.fire("tier.cold_read") is not None:
            if not degrade:
                raise InjectedIOError("tier.cold_read")
            dropped[cold_rows] = True       # the host said no: serve resident
            return
        uniq, inv = np.unique(cids[cold_rows], return_inverse=True)
        inv = inv.reshape(-1)
        u = uniq.size
        blk_codes, blk_ids = self._staging(u)
        t0 = time.perf_counter()
        # one read; mode='clip' skips numpy's buffered copy (the ids are
        # valid: they indexed _slot_of above)
        np.take(self._codes_mm, uniq, axis=0, out=blk_codes, mode="clip")
        np.take(self._ids_mm, uniq, axis=0, out=blk_ids, mode="clip")
        t1 = time.perf_counter()
        self.fetch_s["cold_read"] += t1 - t0
        bad = np.zeros(u, bool)
        if self.checksum:
            for j, c in enumerate(uniq.tolist()):
                if c in self.quarantined:
                    if not degrade:
                        raise CorruptClusterError(c, "cluster is quarantined")
                    bad[j] = True
                    continue
                if self._rows_ok(c, blk_codes[j], blk_ids[j]):
                    continue
                # one re-read: a torn or transient read heals, rotten spill
                # bytes do not
                blk_codes[j] = self._codes_mm[c]
                blk_ids[j] = self._ids_mm[c]
                if self._rows_ok(c, blk_codes[j], blk_ids[j]):
                    continue
                self.stats.crc_failures += 1
                self.quarantined.add(c)
                bad[j] = True
                if not degrade:
                    raise CorruptClusterError(c, "detected on cold fetch")
        t2 = time.perf_counter()
        self.fetch_s["crc"] += t2 - t1
        ok = ~bad[inv]
        tgt = cold_rows[ok]
        if tgt.size:
            dev = self.device
            codes_dev = self._stage[0][:u].to(dev, non_blocking=True)
            ids_dev = self._stage[1][:u].to(dev, non_blocking=True)
            src = torch.from_numpy(inv[ok]).to(dev)
            tgt_dev = torch.from_numpy(tgt).to(dev)
            out_codes.index_copy_(0, tgt_dev, codes_dev.index_select(0, src))
            out_ids.index_copy_(0, tgt_dev, ids_dev.index_select(0, src))
            _settle(dev)
        t3 = time.perf_counter()
        self.fetch_s["to_device"] += t3 - t2
        # online cold-cost EWMA over the whole fetch: on the card the CRC
        # and the copy cost as much as the read, so the read alone would
        # underestimate the deadline check's cold cost
        per = (t3 - t0) / u
        self._cold_s_per_cluster += 0.3 * (per - self._cold_s_per_cluster)
        dropped[cold_rows[~ok]] = True
        n_uniq_ok = int((~bad).sum())
        self.stats.cold_fetches += n_uniq_ok
        self.stats.cold_requests += int(cold_rows.size)
        self.stats.cold_bytes += n_uniq_ok * self.bytes_per_cluster

    def _fire_spill_corrupt(self, rule) -> None:
        """Apply a ``tier.spill_corrupt`` firing: rot the rule's cluster's
        spill bytes (or the first resident cluster's, so the demote-time
        rebuild has a good copy on the card to heal from)."""
        if rule.cluster is not None:
            c = int(rule.cluster)
        else:
            resident = np.nonzero(self._slot_of >= 0)[0]
            if resident.size == 0:
                return
            c = int(resident[0])
        self.corrupt_spill(c)
        self.fault_corrupted.append(c)
