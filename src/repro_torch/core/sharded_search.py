"""Sharded DRIM-ANN engine: layout-sharded clusters + scheduled scans.

The port of ``repro/core/sharded_search.py``.  The UPMEM execution model
maps onto one card as follows:

  DPU                      -> shard: one (slots, cpart, M) slice of the
                              (S, slots, cpart, M) instance tensors
  per-DPU (q, c) task list -> the (S, T) ShardSchedule tables
                              (scheduler.py)
  DPU kernel (RC+LC+DC+TS) -> one step over a flat task axis (below)
  host merge barrier       -> every task's top-k back on the host;
                              per-query merge (``merge_host``)

The reference runs its per-shard function under ``vmap`` over S.  Here
(S, T) is flattened into one axis of S*T tasks, and slot ``slot`` of
shard ``s`` becomes row ``s * slots + slot`` of the flattened
(S*slots, cpart, M) code tensor, so RC, LC (``lut_build`` or
``lut_build_q``) and the fused DC+TS kernel (``pq_scan_topk``) launch
once per step instead of once per shard.  The fused kernel reads each
task's codes and ids from its row of that tensor in place (its
``slots=``), so a step copies no codes.  Padding tasks (``qidx == -1``)
get slot -1, size 0, and come out as (+inf, -1).  The steps always call
``repro_torch.kernels.ops``, which launches the kernels on the card and
runs their plain versions on CPU tensors, so ``EngineConfig`` has no
``use_kernels`` switch.

Serving collaborators, as in the reference: ``lut_cache`` (a
:class:`repro_torch.runtime.cache.HotClusterLUTCache`; LUTs assembled
through the cache into a per-(query, probed cluster) bank and the step
runs DC+TS only), ``heat_estimator`` (online heat; with
``cfg.relayout_every > 0`` periodic double-buffered re-layout) and
``tasks_controller`` (per-batch-size task-table width).

CL runs on fixed (``CL_BLOCK``, D) blocks, as ``core.search`` does, so a
query's probes -- and so its results -- do not depend on the size of the
batch it rode in.

Live-index generation swaps (``prepare_index`` / ``stage_index`` /
``install_index``) materialize a placement for a new index off to the
side and install it between batches, as the re-layout does.  One lock
guards the pending placement, so a placement staged on one thread while
a batch on another swaps the previous one in is never lost.

Tiered storage (``tiered_store=``, a :class:`~repro_torch.storage.
TieredStore`): the shard tensors hold only the clusters resident when
the placement was built (``materialize_shards_tiered``); probes of the
others are scanned per batch through the tier (``_scan_cold``: one
deduplicated fetch, LC from the cache's bank or the LC kernels, then the
fused DC+TS kernel in its dense form), and their candidates join the
host merge.

Not ported yet, each raises ``NotImplementedError``: ``mesh=`` (the
``shard_map`` steps become ``torch.distributed`` across cards),
``meta=`` and tenant/predicate scoped search.

Shapes and units: queries (Q, D) f32; probes (Q, P) cluster ids; task
tables (S, T) i32 with -1 padding; step outputs (S, T, k); heat is
expected cluster accesses per query; latencies in seconds.  Host seconds
of each phase accumulate in :attr:`DistributedEngine.phase_s`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.adc import (QuantizedLUT, scan_codes,
                                  scan_codes_quantized)
from repro_torch.core.ivf import IVFPQIndex
from repro_torch.core.layout import Layout, build_layout, estimate_heat
from repro_torch.core.perf_model import (IndexParams, TaskLatencyModel,
                                         UPMEM_PROFILE, lut_width_bytes,
                                         make_task_latency_model)
from repro_torch.core.pq import PQCodebook
from repro_torch.core.scheduler import (ShardSchedule, schedule_batch,
                                        schedule_naive)
from repro_torch.core.search import cluster_locate
from repro_torch.core.topk import topk_smallest
from repro_torch.util import ieee_f32_matmul, next_pow2

# CL block: the rows each CL GEMM runs on (zero-padded), the same as
# SearchParams.query_chunk's default, so local and sharded engines probe
# alike and a query's probes do not depend on its batch.
CL_BLOCK = 256


def locate_probes(queries, centroids: torch.Tensor,
                  nprobe: int) -> np.ndarray:
    """CL for (Q, D) queries on fixed (CL_BLOCK, D) blocks on the
    centroids' device -> (Q, nprobe) probe ids on the host."""
    q = torch.as_tensor(queries).to(centroids.device).float()
    parts = [cluster_locate(q[s:s + CL_BLOCK], centroids, nprobe,
                            block=CL_BLOCK)[0]
             for s in range(0, q.shape[0], CL_BLOCK)]
    if not parts:
        return np.zeros((0, nprobe), np.int64)
    return torch.cat(parts).cpu().numpy()


class ShardedIndex(NamedTuple):
    """Per-shard instance tensors, materialized from a Layout (offline)."""
    codes: torch.Tensor      # (S, slots, cpart, M) u8/i32
    ids: torch.Tensor        # (S, slots, cpart) i32, -1 pad
    sizes: torch.Tensor      # (S, slots) i32
    cluster_of: torch.Tensor  # (S, slots) i32, original cluster id (-1 empty)
    start_of: torch.Tensor   # (S, slots) i32, part row offset (diagnostics)
    slot_of_instance: np.ndarray   # (n_instances,) host-side
    centroids: torch.Tensor  # (nlist, D) f32
    codebook: PQCodebook
    rotation: Optional[torch.Tensor]

    @property
    def n_shards(self) -> int:
        return self.codes.shape[0]

    @property
    def slots(self) -> int:
        return self.codes.shape[1]

    @property
    def cpart(self) -> int:
        return self.codes.shape[2]


def materialize_shards(index: IVFPQIndex, layout: Layout,
                       pad_multiple: int = 8) -> ShardedIndex:
    """Offline: CSR index + layout -> dense per-shard tensors, filled on
    the host and copied to the index's device."""
    codes_np = index.codes.cpu().numpy()
    ids_np = index.ids.cpu().numpy()
    offsets = index.offsets.cpu().numpy()

    def rows_of(inst):
        row0 = offsets[inst.cluster] + inst.start
        return (codes_np[row0:row0 + inst.size],
                ids_np[row0:row0 + inst.size])

    return _fill_shards(index, layout, rows_of, codes_np.dtype,
                        pad_multiple)


def materialize_shards_tiered(index: IVFPQIndex, layout: Layout, tier,
                              pad_multiple: int = 8):
    """Tiered materialize: the shard tensors hold only resident clusters.

    ``index`` is a tiered handle's lean view (real offsets, empty code
    arrays); rows come from the :class:`~repro_torch.storage.TieredStore`
    instead, its whole slab in one copy from the card.  Instances of
    clusters cold at snapshot time get ``sizes = 0``: the step yields
    (+inf, -1) for them and the engine scans those probes through the
    tier.  Returns ``(sindex, cold_mask)``; the mask is the snapshot the
    serving path routes by until the next placement (a cluster promoted
    in between still scans through the tier: exact, just not in the
    shard tensors yet)."""
    resident, slot_of, hot_codes, hot_ids = tier.resident_snapshot()

    def rows_of(inst):
        if not resident[inst.cluster]:
            return None          # sizes stay 0: the tier scan owns it
        row = int(slot_of[inst.cluster])
        part = slice(inst.start, inst.start + inst.size)
        return hot_codes[row, part], hot_ids[row, part]

    return (_fill_shards(index, layout, rows_of, np.uint8, pad_multiple),
            ~resident)


def _fill_shards(index: IVFPQIndex, layout: Layout, rows_of, code_dtype,
                 pad_multiple: int) -> ShardedIndex:
    """Dense per-shard tensors of a layout; ``rows_of(instance)`` gives an
    instance's (codes, ids) rows, or None to leave it empty (size 0)."""
    m = index.codebook.m
    s = layout.n_shards
    slots = max(int((layout.shard_of == sh).sum()) for sh in range(s))
    slots = max(slots, 1)
    cpart = max(i.size for i in layout.instances)
    cpart = max(-(-cpart // pad_multiple) * pad_multiple, pad_multiple)

    sh_codes = np.zeros((s, slots, cpart, m), dtype=code_dtype)
    sh_ids = np.full((s, slots, cpart), -1, np.int32)
    sh_sizes = np.zeros((s, slots), np.int32)
    sh_cluster = np.full((s, slots), -1, np.int32)
    sh_start = np.zeros((s, slots), np.int32)
    slot_of = np.full(len(layout.instances), -1, np.int64)

    cursor = np.zeros(s, np.int64)
    for inst in layout.instances:
        sh = int(layout.shard_of[inst.instance_id])
        slot = int(cursor[sh])
        cursor[sh] += 1
        rows = rows_of(inst)
        if rows is not None:
            sz = int(inst.size)
            sh_codes[sh, slot, :sz], sh_ids[sh, slot, :sz] = rows
            sh_sizes[sh, slot] = sz
        sh_cluster[sh, slot] = inst.cluster
        sh_start[sh, slot] = inst.start
        slot_of[inst.instance_id] = slot

    dev = index.centroids.device
    return ShardedIndex(*(torch.from_numpy(a).to(dev) for a in (
                            sh_codes, sh_ids, sh_sizes, sh_cluster, sh_start)),
                        slot_of, index.centroids, index.codebook,
                        index.rotation)


# ---------------------------------------------------------------------------
# The step: RC + LC + DC + TS over a flat task axis
# ---------------------------------------------------------------------------

def _flat(sindex: ShardedIndex):
    """(codes, ids, sizes, cluster_of) with the shard and slot axes
    flattened into one slot axis of S * slots rows (views)."""
    s, slots = sindex.n_shards, sindex.slots
    return (sindex.codes.reshape(s * slots, *sindex.codes.shape[2:]),
            sindex.ids.reshape(s * slots, -1), sindex.sizes.reshape(-1),
            sindex.cluster_of.reshape(-1))


def _flat_slots(sidx: torch.Tensor, slots: int) -> torch.Tensor:
    """(S, T) shard-local slots -> (S*T,) rows of the flattened slot axis
    (-1 stays -1)."""
    base = torch.arange(sidx.shape[0], device=sidx.device)[:, None] * slots
    return torch.where(sidx >= 0, sidx + base, -1).reshape(-1)


def _task_slots(si: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(T,) int32 code slot of each task, -1 for a task that is not valid:
    the fused kernel reads each task's codes and ids in place."""
    return torch.where(valid, si, -1).to(torch.int32)


def _shard_tasks_fn(codes, ids, sizes, cluster_of, qidx, sidx, queries,
                    centroids, codebook: PQCodebook, rotation, *, k: int,
                    strategy: str, quantize: bool = False):
    """One step's tasks: flat (T,) task table -> (T, k) candidates.

    codes (slots, cpart, M), ids (slots, cpart), sizes / cluster_of
    (slots,), qidx / sidx (T,) with -1 padding.  The reference calls this
    once per shard; the port calls it once on the flattened slot axis.

    LC runs through ``kernels.ops.lut_build`` (``lut_build_q`` for
    ``quantize``, the uint8 path) and DC+TS through the fused
    ``ops.pq_scan_topk``: the CUDA kernels on the card, their plain
    versions on CPU tensors.  DC+TS reads each task's codes and ids from
    its slot in place (``slots=``); nothing is gathered."""
    from repro_torch.kernels import ops as kops
    valid = qidx >= 0
    qi = qidx.clamp(0, queries.shape[0] - 1).long()
    si = sidx.clamp(0, codes.shape[0] - 1).long()
    q = queries.index_select(0, qi).float()                   # (T, D)
    cl = cluster_of.index_select(0, si).clamp(0, centroids.shape[0] - 1)
    residual = q - centroids.index_select(0, cl.long())       # RC
    if rotation is not None:
        ieee_f32_matmul()
        residual = residual @ rotation
    residual = residual.contiguous()
    lc = kops.lut_build_q if quantize else kops.lut_build
    lut = lc(residual, codebook.codebooks, codebook.sqnorms)      # LC
    bd, bi = kops.pq_scan_topk(lut, codes, ids, sizes, k, strategy=strategy,
                               slots=_task_slots(si, valid))      # DC + TS
    return bd, bi.masked_fill(~torch.isfinite(bd), -1)


def _fused_scan_topk(lut, task_codes, task_ids, task_sizes, k: int,
                     block: int = 512, *, slots: Optional[torch.Tensor] = None):
    """Streaming DC+TS in plain PyTorch: scan C in blocks, carrying the
    (T, k) running winners -- the dataflow of the fused kernels.  ``lut``
    is the f32 (T, M, CB) table or a (T,)-batched QuantizedLUT; ``slots``
    as ``ops.pq_scan_topk``'s (codes, ids and sizes are then P slots).

    No step selects it: the steps call ``ops.pq_scan_topk``.  It is the
    reference's function of the same name, kept as a blockwise oracle
    for the fused kernels' contract (ragged blocks, empty tasks)."""
    if slots is not None:
        from repro_torch.kernels import ops as kops
        task_codes, task_ids, task_sizes = kops.gather_slots(
            task_codes, task_ids, task_sizes, slots)
    scan_fn = (scan_codes_quantized if isinstance(lut, QuantizedLUT)
               else scan_codes)
    t, c, _ = task_codes.shape
    bd = torch.full((t, k), float("inf"), device=task_codes.device)
    bi = torch.full((t, k), -1, dtype=task_ids.dtype,
                    device=task_codes.device)
    for c0 in range(0, c, block):
        d = scan_fn(lut, task_codes[:, c0:c0 + block]).float()
        col = c0 + torch.arange(d.shape[1], device=d.device)[None, :]
        d = d.masked_fill(col >= task_sizes[:, None], float("inf"))
        bd, bi = topk_smallest(torch.cat([bd, d], 1),
                               torch.cat([bi, task_ids[:, c0:c0 + block]], 1),
                               k)
    return bd, bi


def run_shards_vmap(sindex: ShardedIndex, qidx: torch.Tensor,
                    sidx: torch.Tensor, queries: torch.Tensor, *, k: int,
                    strategy: str = "onehot", quantize: bool = False):
    """The uncached step over every shard: (S, T) task tables -> (S, T, k)
    candidates.  The reference vmaps over shards; here one flat call."""
    s, t = qidx.shape
    codes, ids, sizes, cluster_of = _flat(sindex)
    bd, bi = _shard_tasks_fn(codes, ids, sizes, cluster_of, qidx.reshape(-1),
                             _flat_slots(sidx, sindex.slots), queries,
                             sindex.centroids, sindex.codebook,
                             sindex.rotation, k=k, strategy=strategy,
                             quantize=quantize)
    return bd.reshape(s, t, k), bi.reshape(s, t, k)


def make_sharded_step(mesh, sindex: ShardedIndex, **kw):
    """The reference's ``shard_map`` step over a device mesh."""
    raise NotImplementedError("make_sharded_step (mesh over torch.distributed "
                              "across cards) is not ported to repro_torch "
                              "yet")


def miss_residuals(miss_queries: torch.Tensor, centroids: torch.Tensor,
                   crows: torch.Tensor, rotation: Optional[torch.Tensor]):
    """RC for cache-miss (query, cluster) pairs only: (R, D) f32 residuals
    ``miss_queries[r] - centroids[crows[r]]`` (rotated under OPQ), the
    cached path's LC input.  The same elementwise arithmetic as the
    uncached step's RC, so a miss's LUT equals the uncached one."""
    residual = (miss_queries.float()
                - centroids.index_select(0, crows.long()))
    if rotation is not None:
        ieee_f32_matmul()
        residual = residual @ rotation
    return residual


def _shard_tasks_lut_fn(codes, ids, sizes, qidx, sidx, lidx, lut_bank, *,
                        k: int, strategy: str):
    """One step's tasks with LUTs precomputed: DC + TS only.

    The task-table contract of ``_shard_tasks_fn`` plus ``lidx`` (T,)
    indexing each task's LUT in ``lut_bank`` -- the f32 (Q*P, M, CB)
    table or a (Q*P,)-batched QuantizedLUT.  DC+TS is the uncached
    step's ``ops.pq_scan_topk``, so results are bit-identical per dtype.
    ``lidx == -1`` marks a task with no bank row: it is invalidated,
    never scored against row 0."""
    from repro_torch.kernels import ops as kops
    quantized = isinstance(lut_bank, QuantizedLUT)
    n_rows = (lut_bank.lut_q if quantized else lut_bank).shape[0]
    valid = (qidx >= 0) & (lidx >= 0)
    si = sidx.clamp(0, codes.shape[0] - 1).long()
    li = lidx.clamp(0, n_rows - 1).long()
    if quantized:
        lut = QuantizedLUT(*(a.index_select(0, li) for a in lut_bank))
    else:
        lut = lut_bank.index_select(0, li)                    # (T, M, CB)
    bd, bi = kops.pq_scan_topk(lut, codes, ids, sizes, k, strategy=strategy,
                               slots=_task_slots(si, valid))      # DC + TS
    return bd, bi.masked_fill(~torch.isfinite(bd), -1)


def run_shards_vmap_lut(sindex: ShardedIndex, qidx: torch.Tensor,
                        sidx: torch.Tensor, lidx: torch.Tensor, lut_bank, *,
                        k: int, strategy: str = "onehot"):
    """The cached step over every shard: (S, T) task tables + bank rows
    -> (S, T, k) candidates."""
    s, t = qidx.shape
    codes, ids, sizes, _ = _flat(sindex)
    bd, bi = _shard_tasks_lut_fn(codes, ids, sizes, qidx.reshape(-1),
                                 _flat_slots(sidx, sindex.slots),
                                 lidx.reshape(-1), lut_bank, k=k,
                                 strategy=strategy)
    return bd.reshape(s, t, k), bi.reshape(s, t, k)


def make_sharded_step_lut(mesh, sindex: ShardedIndex, **kw):
    """The reference's cached ``shard_map`` step over a device mesh."""
    raise NotImplementedError("make_sharded_step_lut (mesh over "
                              "torch.distributed across cards) is not "
                              "ported to repro_torch yet")


def merge_host(qidx: np.ndarray, best_d: np.ndarray, best_i: np.ndarray,
               n_queries: int, k: int):
    """UPMEM-faithful host merge: per-query top-k over all task candidates.

    Vectorised form of the reference's loop: candidates of tasks with
    ``qidx >= 0`` are sorted stably by (query, distance), so equal
    distances keep task order, then each query keeps its first k."""
    out_d = np.full((n_queries, k), np.inf, np.float32)
    out_i = np.full((n_queries, k), -1, np.int32)
    flat_q = np.asarray(qidx).reshape(-1)
    keep = flat_q >= 0
    if not keep.any():
        return out_d, out_i
    q = np.repeat(flat_q[keep].astype(np.int64), k)
    d = np.asarray(best_d).reshape(-1, k)[keep].reshape(-1)
    i = np.asarray(best_i).reshape(-1, k)[keep].reshape(-1)
    order = np.lexsort((d, q))                     # stable: task order ties
    q, d, i = q[order], d[order], i[order]
    start = np.searchsorted(q, q, side="left")
    rank = np.arange(q.shape[0]) - start
    top = rank < k
    out_d[q[top], rank[top]] = d[top]
    out_i[q[top], rank[top]] = i[top]
    return out_d, out_i


def merge_on_device(qidx: torch.Tensor, best_d: torch.Tensor,
                    best_i: torch.Tensor, *, n_queries: int, k: int):
    """On-device merge: mask-per-query + top-k, O(Q * S*T*k) compares --
    fine for serving batches, avoided on UPMEM by design."""
    flat_q = qidx.reshape(-1)
    flat_d = best_d.reshape(-1)
    flat_i = best_i.reshape(-1)
    task_q = flat_q.repeat_interleave(k)                      # (ST*k,)
    qmat = task_q[None, :] == torch.arange(n_queries,
                                           device=flat_q.device)[:, None]
    dmat = torch.where(qmat, flat_d[None, :], float("inf"))
    nd, idx = torch.topk(dmat, k, dim=-1, largest=False, sorted=True)
    return nd, torch.where(torch.isfinite(nd), flat_i[idx], -1)


# ---------------------------------------------------------------------------
# End-to-end engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    n_shards: int
    nprobe: int
    k: int
    split_max: Optional[int] = None
    dup_budget_bytes: int = 0
    tasks_per_shard: int = 1024
    strategy: str = "onehot"
    enable_filter: bool = False
    filter_ratio: float = 1.35
    naive_layout: bool = False
    naive_schedule: bool = False
    # batches between heat-driven re-layouts (0 = never; requires a
    # heat_estimator on the engine)
    relayout_every: int = 0
    # "uint8": quantized LUTs end to end (LC epilogue, DC scan, the cached
    # path's bank, and the perf model's byte pricing, b_lut 4 -> 1)
    lut_dtype: str = "f32"


class _Placement(NamedTuple):
    """One materialized placement: layout + shard tensors.  Built off to
    the side by :meth:`DistributedEngine.prepare_layout` and installed
    atomically by ``swap_layout``.

    ``index`` / ``latency`` are set only by :meth:`DistributedEngine.
    prepare_index` (a live-index generation swap): the placement then
    carries the NEW index and its re-priced latency model, and installing
    it also swaps ``engine.index`` and invalidates per-generation state
    (LUT cache, heat estimator).  Plain re-layouts leave them None."""
    layout: Layout
    sindex: ShardedIndex
    cluster_of_host: np.ndarray
    index: Optional[IVFPQIndex] = None
    latency: Optional[TaskLatencyModel] = None
    cold_mask: Optional[np.ndarray] = None   # tiered: True = not in shards


def _not_ported(what: str):
    return NotImplementedError(f"DistributedEngine({what}) is not ported to "
                               f"repro_torch yet")


class DistributedEngine:
    """Offline build (layout + shards) and online batched search.

    ``index`` lives on the device the engine runs on (its tensors' device).
    Optional collaborators: ``lut_cache`` (skip LC on hits),
    ``heat_estimator`` (online heat + periodic re-layout),
    ``tasks_controller`` (per-batch-size task-table width),
    ``tiered_store`` (shards hold the resident clusters; the rest are
    scanned through the tier).
    """

    def __init__(self, index: IVFPQIndex, cfg: EngineConfig,
                 sample_probes: np.ndarray,
                 latency: Optional[TaskLatencyModel] = None,
                 mesh=None, lut_cache=None, heat_estimator=None,
                 tasks_controller=None, tiered_store=None, meta=None):
        for name, val in (("mesh", mesh), ("meta", meta)):
            if val is not None:
                raise _not_ported(f"{name}=...")
        if cfg.lut_dtype not in ("f32", "uint8"):
            raise ValueError(f"EngineConfig.lut_dtype must be 'f32' or "
                             f"'uint8', got {cfg.lut_dtype!r}")
        self.cfg = cfg
        self.index = index
        self.device = index.centroids.device
        self.heat = estimate_heat(np.asarray(sample_probes), index.nlist)
        sizes = index.sizes.cpu().numpy()
        self.latency = latency or make_task_latency_model(
            IndexParams(n_total=int(sizes.sum()), nlist=index.nlist, q=1,
                        d=index.dim, k=cfg.k, p=cfg.nprobe,
                        m=index.codebook.m, cb=index.codebook.cb,
                        b_lut=lut_width_bytes(cfg.lut_dtype)),
            UPMEM_PROFILE)
        if (lut_cache is not None
                and getattr(lut_cache, "lut_dtype", "f32") != cfg.lut_dtype):
            raise ValueError(
                f"lut_cache.lut_dtype={lut_cache.lut_dtype!r} disagrees "
                f"with EngineConfig.lut_dtype={cfg.lut_dtype!r}; cached "
                f"and uncached scans must run the same dtype")
        self.lut_cache = lut_cache
        self.heat_estimator = heat_estimator
        self.tasks_controller = tasks_controller
        self.tiered_store = tiered_store
        self._cold_mask: Optional[np.ndarray] = None
        # per-batch degrade report, read by the serving adapter after
        # search() returns (one worker serves a replica)
        self.last_batch_info: dict = {"degraded": False,
                                      "dropped_probes": 0}
        self.batches_served = 0
        self.relayouts = 0
        self.generations = 0
        # host seconds per phase, accumulated over searches and builds
        # (the caller may reset it); "step" ends with the results' copy
        # to the host, so it includes the device time of the step
        self.phase_s: dict = {}
        # the placement built off to the side and its heat; every
        # read-modify-write of the two (and of _swap_on_next_batch) holds
        # _pending_lock, so a stage on one thread and a swap on another
        # cannot lose the newer placement
        self._pending_lock = threading.Lock()
        self._pending: Optional[_Placement] = None
        self._pending_heat: Optional[np.ndarray] = None
        self._swap_on_next_batch = False
        self._relayout_thread: Optional[threading.Thread] = None
        self._relayout_error: Optional[BaseException] = None
        self._build(self.heat)

    def _clock(self, phase: str, t0: float) -> float:
        now = time.perf_counter()
        self.phase_s[phase] = self.phase_s.get(phase, 0.0) + (now - t0)
        return now

    def _materialize(self, heat: np.ndarray,
                     index: Optional[IVFPQIndex] = None,
                     latency: Optional[TaskLatencyModel] = None
                     ) -> _Placement:
        """Build a placement from a heat vector without touching serving
        state.  Plain re-layouts (``index=None``) place the engine's
        current index: cluster ids -- and so LUT-cache keys -- are stable
        across rebuilds; only placement changes.  A generation swap
        passes the NEW index (+ re-priced latency model), which rides
        inside the placement until install."""
        idx = self.index if index is None else index
        lat = self.latency if latency is None else latency
        t0 = time.perf_counter()
        layout = build_layout(
            idx.sizes.cpu().numpy(), heat, self.cfg.n_shards,
            split_max=self.cfg.split_max,
            dup_budget_bytes=self.cfg.dup_budget_bytes,
            bytes_per_row=idx.codebook.m + 4, latency=lat,
            naive=self.cfg.naive_layout)
        t0 = self._clock("layout", t0)
        cold_mask = None
        if self.tiered_store is not None:
            sindex, cold_mask = materialize_shards_tiered(
                idx, layout, self.tiered_store)
        else:
            sindex = materialize_shards(idx, layout)
        cluster_of = sindex.cluster_of.cpu().numpy()
        self._clock("materialize", t0)
        return _Placement(layout, sindex, cluster_of, index=index,
                          latency=None if index is None else lat,
                          cold_mask=cold_mask)

    def _install(self, placement: _Placement) -> None:
        """Point the serving path at ``placement``.  Deferred-task carry
        is dropped -- callers re-issue via flush rounds.  A placement
        carrying a new index generation also swaps the engine's index
        and latency model (``swap_layout``, the only caller that can see
        one, invalidates the per-generation state)."""
        if placement.index is not None:
            self.index = placement.index
            self.latency = placement.latency
        self.layout = placement.layout
        self.sindex = placement.sindex
        self._cluster_of_host = placement.cluster_of_host
        self._cold_mask = placement.cold_mask
        self.carry: list = []

    def _build(self, heat: np.ndarray) -> None:
        self._install(self._materialize(heat))

    # -- re-layout ---------------------------------------------------------
    @property
    def nprobe(self) -> int:
        return self.cfg.nprobe

    def prepare_layout(self, heat: Optional[np.ndarray] = None) -> dict:
        """Double-buffered re-layout, phase 1: re-run split / duplicate /
        allocate with refreshed heat and materialize the NEXT placement
        off to the side while the current one keeps serving.  Returns the
        predicted imbalance of current vs pending."""
        self._sync_relayout_thread()
        if heat is None:
            if self.heat_estimator is None:
                raise ValueError("prepare_layout needs heat or an estimator")
            heat = self.heat_estimator.heat()
        heat = np.asarray(heat, np.float64)
        pending = self._materialize(heat)
        self._set_pending(pending, heat, swap=False)
        return {"imbalance_current": self.layout.stats(
                    self.latency)["imbalance"],
                "imbalance_pending": pending.layout.stats(
                    self.latency)["imbalance"]}

    def swap_layout(self) -> dict:
        """Double-buffered re-layout, phase 2: install the placement built
        by :meth:`prepare_layout` between batches.  Returns before/after
        predicted-imbalance stats."""
        self._sync_relayout_thread()
        with self._pending_lock:      # take the pending placement whole
            pending, heat = self._pending, self._pending_heat
            if pending is None:
                raise ValueError("swap_layout: no pending placement "
                                 "(call prepare_layout first)")
            self._pending = self._pending_heat = None
            self._swap_on_next_batch = False
        before = self.layout.stats(self.latency)["imbalance"]
        new_generation = pending.index is not None
        self.heat = heat
        self._install(pending)
        self.relayouts += 1
        if new_generation:
            # per-generation invalidation: cluster ids changed meaning
            # (splits / merges renumber) and codebooks may have retrained,
            # so cached LUTs and decayed heat are both stale.  The
            # estimator resets IN PLACE (admission policy and router hold
            # references to it), seeded with the heat the new placement
            # was built from
            self.generations += 1
            if self.lut_cache is not None:
                self.lut_cache.clear()
            if self.heat_estimator is not None:
                self.heat_estimator.reset(nlist=self.index.nlist,
                                          seed=self.heat)
        if self.tasks_controller is not None:
            self.tasks_controller.retune(*self._layout_task_stats())
        after = self.layout.stats(self.latency)["imbalance"]
        return {"imbalance_before": before, "imbalance_after": after}

    def refresh_layout(self, heat: Optional[np.ndarray] = None) -> dict:
        """prepare_layout + swap_layout in one synchronous call."""
        self.prepare_layout(heat)
        return self.swap_layout()

    # -- live-index generation swaps --------------------------------------
    def prepare_index(self, index: IVFPQIndex,
                      heat: Optional[np.ndarray] = None) -> None:
        """Double-buffered *generation* swap, phase 1: materialize a
        placement for a NEW index (mutated, split / merged or retrained
        by the live index) off to the side, while the current one keeps
        serving.

        The latency model is re-priced for the new index's size and
        cluster count.  ``heat`` defaults to the online estimator's view
        when the cluster count is unchanged, else to the engine's last
        heat if it fits, else to uniform (splits / merges renumbered the
        clusters).  ``swap_layout`` installs it."""
        self._set_pending(*self._build_index_placement(index, heat),
                          swap=False)

    def _build_index_placement(self, index: IVFPQIndex,
                               heat: Optional[np.ndarray]):
        self._sync_relayout_thread()
        nlist = index.nlist
        if heat is None:
            if (self.heat_estimator is not None
                    and self.heat_estimator.nlist == nlist):
                heat = self.heat_estimator.heat()
            elif len(self.heat) == nlist:
                heat = self.heat
            else:
                heat = np.full(nlist, self.cfg.nprobe / max(nlist, 1),
                               np.float64)
        sizes = index.sizes.cpu().numpy()
        latency = make_task_latency_model(
            IndexParams(n_total=int(sizes.sum()), nlist=nlist, q=1,
                        d=index.dim, k=self.cfg.k, p=self.cfg.nprobe,
                        m=index.codebook.m, cb=index.codebook.cb,
                        b_lut=lut_width_bytes(self.cfg.lut_dtype)),
            UPMEM_PROFILE)
        heat = np.asarray(heat, np.float64)
        return self._materialize(heat, index=index, latency=latency), heat

    def _set_pending(self, pending: _Placement, heat: np.ndarray, *,
                     swap: bool) -> None:
        with self._pending_lock:
            self._pending, self._pending_heat = pending, heat
            self._swap_on_next_batch = swap

    def stage_index(self, index: IVFPQIndex,
                    heat: Optional[np.ndarray] = None) -> None:
        """prepare_index + install at the start of the next served batch
        (the ``_swap_on_next_batch`` hook periodic re-layout uses): the
        non-blocking install path, searches never wait on a build.  The
        placement and the flag are set together under the pending lock,
        so a batch swapping in an older placement meanwhile leaves this
        one pending."""
        self._set_pending(*self._build_index_placement(index, heat),
                          swap=True)

    def install_index(self, index: IVFPQIndex,
                      heat: Optional[np.ndarray] = None) -> dict:
        """prepare_index + swap_layout in one synchronous call.  Callers
        must not have searches in flight (the non-blocking path is
        ``stage_index``)."""
        self.prepare_index(index, heat)
        return self.swap_layout()

    def _sync_relayout_thread(self) -> None:
        """Join an in-flight background rebuild and surface its error."""
        t = self._relayout_thread
        if t is not None:
            t.join()
            self._relayout_thread = None
            if self._relayout_error is not None:
                err, self._relayout_error = self._relayout_error, None
                raise err

    def _begin_prepare_async(self) -> None:
        """Periodic-relayout trigger: snapshot the estimator's heat here,
        build the next placement on a background thread; the next batch
        joins and swaps (``_join_pending_relayout``)."""
        self._sync_relayout_thread()
        if self._staged_generation():
            # a staged index generation is waiting to swap: a periodic
            # re-layout must not clobber it (the swap installs fresh heat;
            # re-layout resumes on the new generation)
            return
        heat = np.asarray(self.heat_estimator.heat(), np.float64)

        def build():
            try:
                pending = self._materialize(heat)
            except BaseException as e:           # surfaced at join
                self._relayout_error = e
                return
            with self._pending_lock:
                # a generation staged meanwhile wins over this re-layout
                if not self._staged_generation():
                    self._pending, self._pending_heat = pending, heat

        self._relayout_thread = threading.Thread(target=build, daemon=True)
        self._relayout_thread.start()

    def _staged_generation(self) -> bool:
        pending = self._pending
        return pending is not None and pending.index is not None

    def _join_pending_relayout(self) -> None:
        try:
            self._sync_relayout_thread()
        except BaseException:
            with self._pending_lock:
                self._swap_on_next_batch = False
            raise
        with self._pending_lock:
            if self._pending is None:
                self._swap_on_next_batch = False
                return
        self.swap_layout()

    def _layout_task_stats(self):
        """(tasks_per_query, mean_task_s) of the current layout: nprobe x
        heat-weighted mean split parts per probed cluster, and the Eq. 15
        latency of a mean-size instance."""
        parts = np.zeros(self.index.nlist, np.float64)
        mean_size = 0.0
        n0 = 0
        for inst in self.layout.instances:
            if inst.replica == 0:
                parts[inst.cluster] += 1.0
                mean_size += inst.size
                n0 += 1
        mean_size /= max(n0, 1)
        w = np.maximum(self.heat, 0.0)
        mean_parts = (float((parts * w).sum() / w.sum()) if w.sum() > 0
                      else float(parts.mean()))
        return (self.cfg.nprobe * max(mean_parts, 1.0),
                self.latency.task_latency(mean_size))

    def make_tasks_controller(self, headroom: float = 1.5, floor: int = 16,
                              max_shard_time_s: Optional[float] = None):
        """A perf-model-driven TasksPerShardController for this layout."""
        from repro_torch.runtime.batching import TasksPerShardController
        tasks_per_query, mean_task_s = self._layout_task_stats()
        return TasksPerShardController(
            self.cfg.n_shards, tasks_per_query,
            headroom=headroom, floor=floor, cap=self.cfg.tasks_per_shard,
            mean_task_s=mean_task_s, max_shard_time_s=max_shard_time_s)

    def precompile_lc(self, max_rows: int) -> None:
        """Run the cached path's miss-batch LC shapes (powers of two up to
        ``max_rows``) once ahead of traffic, so the first real batch is
        not charged the kernel library's load."""
        from repro_torch.runtime.cache import precompile_lut_shapes
        precompile_lut_shapes(self.index.codebook, max_rows,
                              lut_dtype=self.cfg.lut_dtype)

    def serving_info(self) -> dict:
        """Engine-side counters surfaced in ServingRuntime.metrics()."""
        info = {"batches": self.batches_served,
                "relayouts": self.relayouts,
                "generations": self.generations,
                "pending_relayout": self._pending is not None,
                "tasks_per_shard": self.cfg.tasks_per_shard}
        if self.tasks_controller is not None:
            info["tasks_controller"] = self.tasks_controller.summary()
        if self.heat_estimator is not None:
            info["heat_batches"] = self.heat_estimator.batches_observed
        if self.tiered_store is not None:
            info["tier"] = self.tiered_store.serving_info()
        return info

    # -- online ------------------------------------------------------------
    def schedule(self, probes: Optional[np.ndarray] = None, *,
                 tasks_per_shard: Optional[int] = None,
                 drain: bool = False) -> ShardSchedule:
        """Build one batch's static task tables from the (Q, P) probed
        cluster lists; deferred tasks land in ``self.carry``."""
        if probes is None:
            raise TypeError("schedule() requires probes=(Q, P) "
                            "cluster ids from cluster_locate")
        return self._schedule(np.asarray(probes),
                              tasks_per_shard=tasks_per_shard, drain=drain)

    def _schedule(self, probes: np.ndarray,
                  tasks_per_shard: Optional[int] = None,
                  drain: bool = False) -> ShardSchedule:
        if tasks_per_shard is None:
            tasks_per_shard = self.cfg.tasks_per_shard
        if self.cfg.naive_schedule:
            return schedule_naive(probes, self.layout, self.latency,
                                  self.sindex.slot_of_instance,
                                  tasks_per_shard=tasks_per_shard)
        # drain rounds keep the hard capacity cap but not the balance
        # filter, or deferred work ping-pongs forever
        sched = schedule_batch(probes, self.layout, self.latency,
                               self.sindex.slot_of_instance,
                               tasks_per_shard=tasks_per_shard,
                               carry_in=self.carry,
                               filter_ratio=self.cfg.filter_ratio,
                               enable_filter=(self.cfg.enable_filter
                                              and not drain))
        self.carry = list(sched.deferred)
        return sched

    def locate(self, queries: torch.Tensor) -> np.ndarray:
        """CL for (Q, D) queries on fixed (CL_BLOCK, D) blocks -> (Q, P)
        probe ids on the host."""
        return locate_probes(queries, self.sindex.centroids, self.cfg.nprobe)

    def _lut_bank(self, queries_np: np.ndarray, probes: np.ndarray,
                  n_valid: int):
        """Assemble the per-(query, probed cluster) LUT bank through the
        cache: (Q*P, M, CB) f32, or a (Q*P,)-batched QuantizedLUT when the
        cache runs uint8.  One LUT per (query, probed cluster) pair --
        split parts and replicas share it.  Pad rows (>= n_valid) are
        built but never looked up or inserted.  RC+LC run over the miss
        rows only, padded to a power of two."""
        from repro_torch.runtime.cache import (lut_fill_misses, lut_miss_scan,
                                               stack_lut_bank)
        cache = self.lut_cache
        nq, npr = probes.shape
        flat_probes = probes.reshape(-1)
        buckets = [cache.bucket_of(queries_np[qi]) for qi in range(n_valid)]
        luts, miss_rows = lut_miss_scan(cache, flat_probes, buckets, npr,
                                        nq * npr)
        if miss_rows:
            nmiss = len(miss_rows)
            mpad = next_pow2(nmiss)
            miss_q = np.zeros((mpad, queries_np.shape[1]), np.float32)
            miss_q[:nmiss] = queries_np[[t // npr for t in miss_rows]]
            crows = np.zeros(mpad, np.int32)
            crows[:nmiss] = flat_probes[miss_rows]
            res = miss_residuals(torch.from_numpy(miss_q).to(self.device),
                                 self.sindex.centroids,
                                 torch.from_numpy(crows).to(self.device),
                                 self.sindex.rotation)
            lut_fill_misses(cache, self.index.codebook, luts, miss_rows,
                            flat_probes, buckets, npr, res)
        return stack_lut_bank(luts, device=self.device)

    def _scan_cold(self, q_dev: torch.Tensor, probes: np.ndarray, bank,
                   budget_s: Optional[float], n_valid: int):
        """Scan this batch's snapshot-cold probes through the tier.

        (q, pos) pairs whose cluster is not in the shard tensors are
        fetched from the tier (one deduplicated spill read per batch),
        scored with the same tables the shards would use -- bank rows
        when the cache is on (row ``q * nprobe + pos``), else RC + LC
        (the LC kernels) over those pairs -- by the fused DC+TS kernel in
        its dense form, and returned as extra (T, k) candidate rows for
        the host merge.  ``None`` when nothing is cold.  Padding rows
        (``q >= n_valid``) get no cold scan: their results are thrown
        away, and their probes must not shed or degrade the batch.

        Fail-operational: the fetch runs degraded; probes the tier cannot
        serve (quarantined clusters, or all of them when ``budget_s`` says
        the predicted cold cost would blow the deadline) come back with
        size 0, so the scan stays exact over what it scanned; the drop
        count lands in ``last_batch_info``."""
        from repro_torch.kernels import ops as kops
        mask = self._cold_mask
        if mask is None or not mask.any():
            return None
        cold_q, cold_pos = np.nonzero(mask[probes[:n_valid]])
        if cold_q.size == 0:
            return None
        clusters = probes[cold_q, cold_pos]
        tier = self.tiered_store
        resident_only = False
        if budget_s is not None:
            n_cold = int(np.unique(clusters).size)
            resident_only = bool(n_cold) and (
                budget_s <= 0 or tier.estimate_cold_seconds(n_cold)
                > budget_s)
        codes, ids, sizes, dropped = tier.gather_degraded(
            clusters, resident_only=resident_only)
        n_dropped = int(dropped.sum())
        if n_dropped:
            self.last_batch_info = {
                "degraded": True,
                "dropped_probes":
                    self.last_batch_info.get("dropped_probes", 0)
                    + n_dropped}
        if bank is not None:
            li = self._dev(cold_q.astype(np.int64) * self.cfg.nprobe
                           + cold_pos)
            lut = (QuantizedLUT(*(a.index_select(0, li) for a in bank))
                   if isinstance(bank, QuantizedLUT)
                   else bank.index_select(0, li))
        else:
            res = miss_residuals(q_dev.index_select(0, self._dev(cold_q)),
                                 self.sindex.centroids,
                                 self._dev(clusters),
                                 self.sindex.rotation).contiguous()
            lc = (kops.lut_build_q if self.cfg.lut_dtype == "uint8"
                  else kops.lut_build)
            cb = self.index.codebook
            lut = lc(res, cb.codebooks, cb.sqnorms)
        bd, bi = kops.pq_scan_topk(lut, codes, ids, sizes, self.cfg.k,
                                   strategy=self.cfg.strategy)   # DC + TS
        bi = bi.masked_fill(~torch.isfinite(bd), -1)
        return bd.cpu().numpy(), bi.cpu().numpy(), cold_q

    def _probe_posmap(self, probes: np.ndarray) -> np.ndarray:
        """(nq, nlist) position of each cluster in its query's probe list
        (-1 absent).  Built once per batch; every drain round reuses it."""
        nq, npr = probes.shape
        posmap = np.full((max(nq, 1), self.index.nlist), -1, np.int64)
        if nq:
            posmap[np.arange(nq)[:, None], probes] = np.arange(npr)[None, :]
        return posmap

    def _lut_idx(self, sched: ShardSchedule, posmap: np.ndarray,
                 nprobe: int) -> np.ndarray:
        """Map the schedule's (S, T) tasks to LUT-bank rows: task (q, slot)
        -> q * nprobe + position of slot's cluster in probes[q].  -1 marks
        tasks with no bank row; the step masks them out."""
        qi = sched.query_idx
        si = sched.slot_idx
        s_rows = np.arange(qi.shape[0])[:, None]
        cl = self._cluster_of_host[s_rows, np.clip(si, 0, None)]
        pos = posmap[np.clip(qi, 0, None), np.clip(cl, 0, None)]
        lidx = qi.astype(np.int64) * nprobe + pos
        return np.where((qi >= 0) & (pos >= 0), lidx, -1).astype(np.int32)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def search(self, queries, flush: bool = True,
               n_valid: Optional[int] = None,
               budget_s: Optional[float] = None,
               tenants: Optional[np.ndarray] = None,
               terms: Optional[np.ndarray] = None):
        """Batched search -> ((Q, k) f32 dists, (Q, k) i32 ids, info) on
        the host.  With flush=True deferred tasks are drained in
        follow-up rounds so results are complete.

        ``n_valid``: rows >= n_valid are serving-batch padding, kept out
        of heat observation and the LUT cache.  ``budget_s``: remaining
        deadline budget; only the tiered cold scan consults it (when the
        predicted cold-read cost would blow it, the cold probes are
        dropped and the batch is reported degraded in
        ``last_batch_info``)."""
        if tenants is not None or terms is not None:
            raise NotImplementedError("tenant / predicate scoped search is "
                                      "not ported to repro_torch yet")
        self.last_batch_info = {"degraded": False, "dropped_probes": 0}
        if self._swap_on_next_batch:
            self._join_pending_relayout()
        t0 = time.perf_counter()
        q_dev = torch.as_tensor(np.asarray(queries, np.float32)
                                if isinstance(queries, np.ndarray)
                                else queries).to(self.device).float()
        nq = q_dev.shape[0]
        nv = nq if n_valid is None else min(n_valid, nq)
        probes = self.locate(q_dev)
        t0 = self._clock("cl", t0)
        if nv > 0:      # all-padding warmup batches are not traffic
            if self.heat_estimator is not None:
                self.heat_estimator.observe(probes[:nv])
            if self.tiered_store is not None:
                # tier heat drives promote / demote; residency changes
                # reach the shard tensors at the next placement (the cold
                # mask is a snapshot), and the tier scan serves the
                # batches in between exactly
                self.tiered_store.observe(probes[:nv])
            self.batches_served += 1
            if (self.cfg.relayout_every > 0
                    and self.heat_estimator is not None
                    and self.batches_served % self.cfg.relayout_every == 0):
                self._begin_prepare_async()
                self._swap_on_next_batch = True
        k = self.cfg.k
        if nq == 0:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32),
                    {"rounds": 0})
        tps = (self.tasks_controller.tasks_for(nq)
               if self.tasks_controller is not None
               else self.cfg.tasks_per_shard)
        bank = posmap = None
        if self.lut_cache is not None:
            bank = self._lut_bank(q_dev.cpu().numpy(), probes, nv)
            posmap = self._probe_posmap(probes)
            t0 = self._clock("lut_bank", t0)
        all_d, all_i, all_q = [], [], []
        rounds = 0
        pending = probes
        quantize = self.cfg.lut_dtype == "uint8"
        while True:
            sched = self._schedule(pending, tps, drain=rounds > 0)
            if rounds == 0 and nv > 0 and self.tasks_controller is not None:
                full = bool((sched.n_tasks >= tps).any())
                self.tasks_controller.observe(
                    nq, len(sched.deferred) if full else 0)
            qidx = self._dev(sched.query_idx)
            sidx = self._dev(sched.slot_idx)
            t0 = self._clock("schedule", t0)
            if bank is not None:
                lidx = self._dev(self._lut_idx(sched, posmap,
                                               self.cfg.nprobe))
                bd, bi = run_shards_vmap_lut(
                    self.sindex, qidx, sidx, lidx, bank, k=k,
                    strategy=self.cfg.strategy)
            else:
                bd, bi = run_shards_vmap(
                    self.sindex, qidx, sidx, q_dev, k=k,
                    strategy=self.cfg.strategy, quantize=quantize)
            all_d.append(bd.cpu().numpy())
            all_i.append(bi.cpu().numpy())
            all_q.append(sched.query_idx)
            t0 = self._clock("step", t0)
            rounds += 1
            if not (flush and self.carry):
                break
            pending = np.zeros((0, 0), np.int64)   # only carry-in tasks
        if self.tiered_store is not None:
            cold = self._scan_cold(q_dev, probes, bank, budget_s, nv)
            if cold is not None:
                for out, part in zip((all_d, all_i, all_q), cold):
                    out.append(part)
            t0 = self._clock("cold", t0)
        d = np.concatenate([a.reshape(-1, k) for a in all_d])
        i = np.concatenate([a.reshape(-1, k) for a in all_i])
        q = np.concatenate([a.reshape(-1) for a in all_q])
        out_d, out_i = merge_host(q, d, i, nq, k)
        self._clock("merge", t0)
        return out_d, out_i, {"rounds": rounds}
