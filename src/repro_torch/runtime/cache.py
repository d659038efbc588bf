"""Hot-cluster LUT caching for skewed online query streams.

The port of ``repro/runtime/cache.py``.  Keys, admission, accounting and
the host-side entries (numpy arrays, or ``(lut_q, scale, bias)`` numpy
triples) are the reference's; the cached LC (:func:`lut_fill_misses`)
runs through ``repro_torch.kernels.ops`` -- the same LC kernels as the
uncached step on CUDA tensors, their plain versions on CPU tensors -- and
:func:`stack_lut_bank` puts the bank on a given device.

The paper's load balancer exists because real query streams are skewed:
a few hot clusters absorb most probes (§IV).  The same skew makes the LC
phase redundant online — near-duplicate queries probing the same hot
cluster rebuild near-identical (M, CB) LUTs.  This module provides the
cache that lets a repeat hit skip LC for that (query, cluster) pair
entirely, plus the heat machinery that makes admission skew-aware:

  * :class:`LRUCache` / :class:`HotClusterLUTCache` — bounded cache keyed
    on ``(cluster id, query hash bucket)`` holding (M, CB) f32 LUTs, or —
    with ``lut_dtype="uint8"`` — quantized ``(lut_q u8, scale, bias)``
    triples (:func:`repro_torch.core.adc.quantize_lut`), ~4x more entries per
    byte.  Budgeting is by entry count (``capacity``), by bytes
    (``capacity_bytes``), or both;
  * :class:`OnlineHeatEstimator` — exponentially-decayed per-cluster
    probe counts fed from the served stream; units match
    ``layout.estimate_heat`` (expected accesses per query), so the same
    vector seeds offline layout and online admission;
  * :class:`HeatAwareAdmission` — replaces pure-LRU victim selection:
    evict the *coldest-cluster* entry from an LRU-tail sample, and
    reject inserts whose cluster is colder than that victim (cold scan
    traffic can no longer flush hot clusters out of the cache).

Query hash buckets: with ``granularity=None`` (default) the key is the
hash of the exact f32 query bytes — only true repeats hit, and served
results stay bit-identical to the uncached path.  A positive
``granularity`` g quantizes the query to a grid of cell size g before
hashing, so *near*-duplicates also hit at the cost of an approximation
error bounded by the grid (knob for the serving bench).

Invariants:
  * ``len(cache) <= capacity`` and ``bytes <= capacity_bytes`` always
    (admission can only shrink churn);
  * with ``admission=None`` behaviour is plain LRU;
  * with all-zero heat, :class:`HeatAwareAdmission` degrades to LRU
    (ties admit and evict the oldest sampled entry).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Hashable, Optional, Sequence

import numpy as np

import torch

from repro_torch.util import next_pow2, resolve_device


def entry_nbytes(value: Any) -> int:
    """Resident bytes of a cache value: an array, a tuple of arrays (the
    quantized ``(lut_q, scale, bias)`` triple), or — fallback for plain
    Python values in generic LRUCache use — ``sys.getsizeof``."""
    if isinstance(value, (tuple, list)):
        return int(sum(entry_nbytes(v) for v in value))
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    import sys
    return int(sys.getsizeof(value))


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    rejects: int = 0      # admission-denied inserts (heat-aware policy)
    clears: int = 0       # whole-cache invalidations (generation swaps)
    # current content accounting (kept in sync by LRUCache on every
    # mutation — byte budgeting made the resident footprint a first-class
    # metric, not just the entry count)
    entries: int = 0
    bytes: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "rejects": self.rejects, "clears": self.clears,
                "entries": self.entries, "bytes": self.bytes,
                "hit_rate": round(self.hit_rate, 4)}


class AdmissionPolicy:
    """Victim selection + admission gate for a full cache.

    ``pick_victim(candidate_key, sample)`` returns the key to evict from
    ``sample`` (ordered oldest-first), or ``None`` to reject the insert.
    The default policy is plain LRU: always evict the oldest, never
    reject.
    """

    def pick_victim(self, candidate_key: Hashable,
                    sample: Sequence[Hashable]) -> Optional[Hashable]:
        return sample[0]


class OnlineHeatEstimator:
    """Per-cluster heat refreshed online from the served probe stream.

    Maintains exponentially-decayed probe counts: each ``observe`` call
    (one served batch) decays history by ``0.5 ** (1 / halflife_batches)``
    and adds the batch's probe histogram.  ``heat()`` normalizes by the
    equally-decayed query count, so the output unit is *expected accesses
    per query* — identical to ``layout.estimate_heat``, which means the
    same vector can seed :func:`repro_torch.core.layout.build_layout` for
    periodic re-layout.

    ``seed`` (optional, from the offline sample) is weighted as
    ``seed_weight`` queries' worth of evidence, so cold-start admission
    is sane before real traffic accumulates.
    """

    def __init__(self, nlist: int, halflife_batches: float = 64.0,
                 seed: Optional[np.ndarray] = None,
                 seed_weight: float = 32.0):
        if halflife_batches <= 0:
            raise ValueError("halflife_batches must be positive")
        self.nlist = int(nlist)
        self.decay = 0.5 ** (1.0 / float(halflife_batches))
        self._counts = np.zeros(self.nlist, np.float64)
        self._queries = 0.0
        self.batches_observed = 0
        if seed is not None:
            seed = np.asarray(seed, np.float64)
            if seed.shape != (self.nlist,):
                raise ValueError(f"seed shape {seed.shape} != ({nlist},)")
            self._counts = seed * seed_weight
            self._queries = float(seed_weight)

    def observe(self, probe_lists: np.ndarray) -> None:
        """Fold one batch's CL output (Q, P) int cluster ids into the
        decayed counts.  Caller must pre-slice padding rows away."""
        probe_lists = np.asarray(probe_lists)
        if probe_lists.size == 0:
            return
        self._counts *= self.decay
        self._queries *= self.decay
        self._counts += np.bincount(probe_lists.reshape(-1).astype(np.int64),
                                    minlength=self.nlist)[:self.nlist]
        self._queries += probe_lists.shape[0]
        self.batches_observed += 1

    def heat(self) -> np.ndarray:
        """(nlist,) expected accesses/query — ``estimate_heat`` units."""
        return self._counts / max(self._queries, 1e-12)

    def heat_of(self, cluster_id: int) -> float:
        return float(self._counts[int(cluster_id)] /
                     max(self._queries, 1e-12))

    def reset(self, nlist: Optional[int] = None,
              seed: Optional[np.ndarray] = None,
              seed_weight: float = 32.0) -> None:
        """Forget all decayed history *in place* — the per-generation
        invalidation hook.  When index maintenance splits/merges
        clusters, cluster ids change meaning, so stale heat must not
        steer admission, layout, or routing; resetting in place (rather
        than swapping the object) means every holder of this estimator —
        cache admission policy, engine, router — sees the reset.
        ``nlist`` resizes to the new generation's cluster count; ``seed``
        optionally re-seeds (same semantics as the constructor)."""
        if nlist is not None:
            self.nlist = int(nlist)
        self._counts = np.zeros(self.nlist, np.float64)
        self._queries = 0.0
        self.batches_observed = 0
        if seed is not None:
            seed = np.asarray(seed, np.float64)
            if seed.shape != (self.nlist,):
                raise ValueError(f"seed shape {seed.shape} != "
                                 f"({self.nlist},)")
            self._counts = seed * float(seed_weight)
            self._queries = float(seed_weight)


class HeatAwareAdmission(AdmissionPolicy):
    """Heat-aware admission for :class:`HotClusterLUTCache`.

    On a full cache, sample the ``sample_size`` least-recently-used
    entries, score each by its cluster's current heat, and evict the
    coldest (oldest wins ties).  The candidate is admitted only if its
    cluster is at least as hot as that victim; otherwise the insert is
    *rejected* (counted in ``stats.rejects``) and the cache is left
    untouched — one-off cold probes cannot displace hot-cluster LUTs.
    """

    def __init__(self, estimator: OnlineHeatEstimator, sample_size: int = 8):
        self.estimator = estimator
        self.sample_size = int(sample_size)

    def pick_victim(self, candidate_key, sample):
        heat = self.estimator.heat_of
        victim = min(sample, key=lambda k: heat(k[0]))
        if heat(candidate_key[0]) < heat(victim[0]):
            return None                       # reject: colder than everyone
        return victim


class LRUCache:
    """Bounded cache over hashable keys with hit/miss/eviction accounting.

    Bounds: ``capacity`` (max entries; None = unbounded) and/or
    ``capacity_bytes`` (max resident value bytes via
    :func:`entry_nbytes`; None = unbounded) — at least one must be set.
    Recency order is LRU; when full, victim selection is delegated to the
    optional :class:`AdmissionPolicy` (default: evict oldest, admit all).
    A byte budget may evict several victims for one insert (quantized
    entries are smaller than the f32 ones they displace).
    """

    def __init__(self, capacity: Optional[int],
                 admission: Optional[AdmissionPolicy] = None,
                 capacity_bytes: Optional[int] = None):
        if capacity is None and capacity_bytes is None:
            raise ValueError("need capacity and/or capacity_bytes")
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError("capacity_bytes must be >= 1")
        self.capacity = None if capacity is None else int(capacity)
        self.capacity_bytes = (None if capacity_bytes is None
                               else int(capacity_bytes))
        self.admission = admission
        self._od: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._size: dict = {}              # key -> entry_nbytes(value)
        self.bytes = 0                     # resident value bytes
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key) -> bool:
        return key in self._od

    def _sync_stats(self) -> None:
        self.stats.entries = len(self._od)
        self.stats.bytes = self.bytes

    def _drop(self, key) -> None:
        del self._od[key]
        self.bytes -= self._size.pop(key)
        self.stats.evictions += 1

    def _needs_room(self, incoming_bytes: int, evicting: set) -> bool:
        """Would inserting ``incoming_bytes`` still violate a bound after
        evicting the (not-yet-dropped) keys in ``evicting``?"""
        n = len(self._od) - len(evicting)
        if self.capacity is not None and n >= self.capacity:
            return True
        if self.capacity_bytes is None:
            return False
        freed = sum(self._size[k] for k in evicting)
        return self.bytes - freed + incoming_bytes > self.capacity_bytes

    def get(self, key) -> Optional[Any]:
        v = self._od.get(key)
        if v is None:
            self.stats.misses += 1
            return None
        self._od.move_to_end(key)
        self.stats.hits += 1
        return v

    def put(self, key, value) -> bool:
        """Insert (or refresh) ``key``.  Returns False iff the admission
        policy rejected the insert on a full cache, or the value alone
        exceeds the byte budget."""
        nb = entry_nbytes(value)
        if self.capacity_bytes is not None and nb > self.capacity_bytes:
            self.stats.rejects += 1
            return False
        if key in self._od:
            self._od.move_to_end(key)
            self._od[key] = value
            self.bytes += nb - self._size[key]
            self._size[key] = nb
            while (self.capacity_bytes is not None
                   and self.bytes > self.capacity_bytes):
                oldest = next(iter(self._od))   # refresh never self-evicts:
                if oldest == key:               # key is at the MRU end
                    break
                self._drop(oldest)
            self._sync_stats()
            return True
        # Select the FULL victim set before touching the cache: a byte
        # budget may need several evictions for one insert, and a late
        # admission rejection must leave the cache untouched (the
        # HeatAwareAdmission contract — rejected inserts cannot churn
        # resident entries).
        victims: set = set()
        while self._needs_room(nb, victims) and len(victims) < len(self._od):
            if self.admission is not None:
                n = min(getattr(self.admission, "sample_size", 8),
                        len(self._od) - len(victims))
                sample = []                       # oldest first, unpicked
                for k in self._od:
                    if k not in victims:
                        sample.append(k)
                        if len(sample) == n:
                            break
                victim = self.admission.pick_victim(key, sample)
                if victim is None:
                    self.stats.rejects += 1
                    self._sync_stats()
                    return False
            else:
                victim = next(k for k in self._od if k not in victims)
            victims.add(victim)
        for v in victims:
            self._drop(v)
        self._od[key] = value
        self._size[key] = nb
        self.bytes += nb
        self.stats.inserts += 1
        self._sync_stats()
        return True

    def clear(self) -> None:
        """Drop every resident entry at once (generation invalidation:
        a new index generation re-keys cluster ids and re-trains
        codebooks, so the whole cache is stale).  Cumulative hit/miss/
        insert/eviction counters are kept — a clear is a lifecycle
        event, not an eviction storm — and content accounting re-syncs
        to empty."""
        self._od.clear()
        self._size.clear()
        self.bytes = 0
        self.stats.clears += 1
        self._sync_stats()


def query_hash_bucket(query: np.ndarray,
                      granularity: Optional[float] = None) -> int:
    """Stable 64-bit bucket id for a query vector (optionally quantized)."""
    q = np.ascontiguousarray(query, np.float32)
    if granularity is not None:
        q = np.round(q / np.float32(granularity)).astype(np.int64)
        q = np.ascontiguousarray(q)
    digest = hashlib.blake2b(q.tobytes(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


# ---------------------------------------------------------------------------
# Shared cached-LC assembly: an engine (here DistributedEngine._lut_bank;
# the reference's LocalEngine too) scans the cache per (cluster,
# query-bucket) key, batch-builds the misses padded to a power of two, and
# inserts only valid rows — one implementation so pad-guard/pow2/accounting
# fixes land in one place.
# ---------------------------------------------------------------------------

def lut_miss_scan(cache: "HotClusterLUTCache", flat_probes: np.ndarray,
                  buckets: Sequence[int], nprobe: int, n_rows: int):
    """Look up rows 0..n_rows-1 (row t = pair (t // nprobe, probe t)).

    ``buckets`` holds one query-hash per *valid* query; rows of queries
    beyond ``len(buckets)`` are serving padding — they are returned as
    misses without touching the cache (no lookup, no stats).
    Returns (luts, miss_rows): luts[t] is the cached (M, CB) LUT or None.

    The row math is batched in numpy: ``flat_probes`` is pulled to the
    host once (per-row indexing of a device array syncs per element),
    pad rows are the contiguous tail so they never enter the loop, and
    duplicate (cluster, bucket) keys within the batch resolve through a
    local memo — one LRU traversal per *unique* key, with hit/miss
    counters bumped per row so the stats match the per-row scan exactly.
    """
    luts = [None] * n_rows
    n_valid = min(len(buckets) * nprobe, n_rows)
    pad_rows = list(range(n_valid, n_rows))    # pad: compute, don't cache
    if n_valid == 0:
        return luts, pad_rows
    probes = np.asarray(flat_probes)[:n_valid].astype(np.int64, copy=False)
    keys = [(int(c), buckets[t // nprobe]) for t, c in enumerate(probes)]
    miss_rows = []
    seen: dict = {}
    stats = cache.stats
    for t, k in enumerate(keys):
        if k in seen:
            v = seen[k]
            if v is None:
                stats.misses += 1
                miss_rows.append(t)
            else:
                stats.hits += 1
                luts[t] = v
            continue
        v = cache.get_by_bucket(k[0], k[1])
        seen[k] = v
        if v is None:
            miss_rows.append(t)
        else:
            luts[t] = v
    return luts, miss_rows + pad_rows


def lut_fill_misses(cache: "HotClusterLUTCache", codebook, luts,
                    miss_rows, flat_probes: np.ndarray,
                    buckets: Sequence[int], nprobe: int,
                    residuals) -> None:
    """Build the missing LUTs in one batched LC and insert valid rows.

    ``residuals`` rows align with ``miss_rows``: either (nmiss, D) host
    rows -- padded here to the next power of two -- or an already
    pow2-padded (mpad, D) tensor, used as-is so callers that computed
    residuals on the device skip a host round trip.  The LC is
    ``kernels.ops.lut_build`` (``lut_build_q`` for a uint8 cache) on the
    codebook's device: the uncached step's own kernel on CUDA.  Pad rows
    of the *serving batch* (query index >= len(buckets)) never enter the
    cache.  Filled ``luts`` rows and cached entries are host arrays:
    (M, CB) f32, or ``(lut_q, scale, bias)`` triples for uint8."""
    from repro_torch.kernels import ops
    nmiss = len(miss_rows)
    if nmiss == 0:
        return
    mpad = next_pow2(nmiss)
    dev = codebook.codebooks.device
    if residuals.shape[0] == mpad and isinstance(residuals, torch.Tensor):
        miss = residuals.to(dev)
    else:
        host = np.zeros((mpad, residuals.shape[1]), np.float32)
        host[:nmiss] = np.asarray(residuals)[:nmiss]
        miss = torch.from_numpy(host).to(dev)
    miss = miss.float().contiguous()
    if cache.lut_dtype == "uint8":
        qlut = ops.lut_build_q(miss, codebook.codebooks, codebook.sqnorms)
        lq, sc, bs = (x[:nmiss].cpu().numpy() for x in qlut)
        fresh = [(lq[j], sc[j], bs[j]) for j in range(nmiss)]
    else:
        fresh = ops.lut_build(miss, codebook.codebooks,
                              codebook.sqnorms)[:nmiss].cpu().numpy()
    probes = np.asarray(flat_probes)           # host once, not per row
    for j, t in enumerate(miss_rows):
        luts[t] = fresh[j]
        qi = t // nprobe
        if qi < len(buckets):
            cache.put_by_bucket(int(probes[t]), buckets[qi], fresh[j])


def stack_lut_bank(luts: Sequence, device="cuda"):
    """Assemble per-row cache values into one bank on ``device``: f32
    rows -> a (T, M, CB) tensor; quantized triples -> a
    :class:`repro_torch.core.adc.QuantizedLUT` of (T, M, CB) u8 + (T, M)
    scale/bias -- the layout the scan kernels take."""
    from repro_torch.core.adc import QuantizedLUT
    dev = resolve_device(device)
    n = len(luts)
    first = luts[0]
    if isinstance(first, tuple):
        lq = np.empty((n,) + first[0].shape, first[0].dtype)
        sc = np.empty((n,) + first[1].shape, first[1].dtype)
        bs = np.empty((n,) + first[2].shape, first[2].dtype)
        for i, (a, b, c) in enumerate(luts):
            lq[i], sc[i], bs[i] = a, b, c
        return QuantizedLUT(*(torch.from_numpy(x).to(dev)
                              for x in (lq, sc, bs)))
    first = np.asarray(first)
    bank = np.empty((n,) + first.shape, first.dtype)
    for i, v in enumerate(luts):
        bank[i] = v
    return torch.from_numpy(bank).to(dev)


def precompile_lut_shapes(codebook, max_rows: int,
                          lut_dtype: str = "f32") -> None:
    """Run the miss-batch LC once at every power of two up to
    ``max_rows`` ahead of traffic, on the codebook's device (on the card
    this loads the kernel library before the first real batch)."""
    from repro_torch.kernels import ops
    build = ops.lut_build_q if lut_dtype == "uint8" else ops.lut_build
    dev = codebook.codebooks.device
    max_rows = next_pow2(max_rows)
    s = 1
    while s <= max_rows:
        build(torch.zeros((s, codebook.m * codebook.dsub), device=dev),
              codebook.codebooks, codebook.sqnorms)
        s *= 2


class HotClusterLUTCache:
    """Cache of per-(cluster, query-bucket) LC outputs.

    Entries are (M, CB) f32 LUTs, or — with ``lut_dtype="uint8"`` —
    quantized ``(lut_q (M, CB) u8, scale (M,), bias (M,))`` triples.  A
    full f32 LUT is M*CB*4 bytes (16 KiB at M=16, CB=256); the quantized
    entry is M*CB + 8*M bytes (~4.1 KiB), so a fixed ``capacity_bytes``
    budget holds ~3.9x the entries — the serving-visible half of the
    uint8 fast path (the other half is the shrunken DC traffic).

    Budget by entry count (``capacity``), bytes (``capacity_bytes``), or
    both; ``capacity=None`` leaves only the byte bound.

    ``admission`` switches victim selection from pure LRU to a policy —
    in practice :class:`HeatAwareAdmission` wired to the engine's
    :class:`OnlineHeatEstimator` — without changing keys or lookup:
    hit/miss behaviour and stored values are policy-independent, so
    exact-granularity served results stay bit-identical either way.
    """

    def __init__(self, capacity: Optional[int] = 4096,
                 granularity: Optional[float] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 capacity_bytes: Optional[int] = None,
                 lut_dtype: str = "f32"):
        if lut_dtype not in ("f32", "uint8"):
            raise ValueError(f"lut_dtype must be 'f32' or 'uint8', "
                             f"got {lut_dtype!r}")
        self._lru = LRUCache(capacity, admission=admission,
                             capacity_bytes=capacity_bytes)
        self.granularity = granularity
        self.lut_dtype = lut_dtype

    @property
    def stats(self) -> CacheStats:
        return self._lru.stats

    @property
    def admission(self) -> Optional[AdmissionPolicy]:
        return self._lru.admission

    @property
    def capacity_bytes(self) -> Optional[int]:
        return self._lru.capacity_bytes

    @property
    def bytes(self) -> int:
        """Resident value bytes currently held."""
        return self._lru.bytes

    def bucket_of(self, query: np.ndarray) -> int:
        """Hash a query once; reuse the bucket across its nprobe keys."""
        return query_hash_bucket(query, self.granularity)

    def key(self, cluster_id: int, query: np.ndarray):
        return (int(cluster_id), self.bucket_of(query))

    def get(self, cluster_id: int, query: np.ndarray):
        return self._lru.get(self.key(cluster_id, query))

    def get_by_bucket(self, cluster_id: int, bucket: int):
        return self._lru.get((int(cluster_id), bucket))

    def put(self, cluster_id: int, query: np.ndarray,
            lut: np.ndarray) -> None:
        self._lru.put(self.key(cluster_id, query), lut)

    def put_by_bucket(self, cluster_id: int, bucket: int,
                      lut: np.ndarray) -> None:
        self._lru.put((int(cluster_id), bucket), lut)

    def clear(self) -> None:
        """Generation invalidation: drop every cached LUT (see
        :meth:`LRUCache.clear`)."""
        self._lru.clear()

    def __len__(self) -> int:
        return len(self._lru)
