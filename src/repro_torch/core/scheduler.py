"""Runtime query scheduling (paper §IV-D): predictor + filter.

Online path, per batch:
  1. CL (on host / replicated) gives each query its probe list.
  2. Every (q, cluster) pair maps to (q, instance) tasks — one per split
     part; for replicated parts the PREDICTOR picks the replica whose shard
     has the least predicted load (Eq. 15: lat = l_LUT + x·l_calc + x·l_sort).
  3. The FILTER defers tasks from shards predicted to run long into the next
     batch's buffer (straggler mitigation across batches — the paper's
     inter-batch filter; also our training-side straggler hook).

The output is a static-shape per-shard task table (padded) that shard_map
consumes directly — no dynamic shapes inside the compiled search step.

Shapes and units: ``probe_lists`` (Q, P) i32 original cluster ids;
``query_idx``/``slot_idx`` (n_shards, tasks_per_shard) i32 with -1
padding (slot = shard-local row in the materialized instance tensors);
``predicted_load`` (n_shards,) seconds under the Eq. 15 latency model.

``tasks_per_shard`` fixes the compiled step's shape: one distinct width
= one XLA compile.  A single global width wastes compute on padding for
small batches and overflows (deferring work into drain rounds) for
large ones — serving tunes it per batch-size bucket via
``runtime.batching.TasksPerShardController``.

Invariants: every non-deferred (q, cluster) probe appears as exactly one
task per split part (one replica chosen); deferred tasks are returned as
(query, cluster, part) triples and re-expanded by the next batch, so a
flush-draining caller always ends with complete results.

A framework-free copy of the reference's ``repro/core/scheduler.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.layout import Layout
from repro_torch.core.perf_model import TaskLatencyModel


@dataclasses.dataclass
class ShardSchedule:
    """Padded per-shard task table (static shapes for the compiled step)."""
    query_idx: np.ndarray     # (S, T) i32 — batch-local query index (-1 pad)
    slot_idx: np.ndarray      # (S, T) i32 — shard-local cluster slot (-1 pad)
    n_tasks: np.ndarray       # (S,)  i32
    deferred: List[Tuple[int, int, int]]     # [(query, cluster, part)]
    predicted_load: np.ndarray               # (S,) seconds

    @property
    def tasks_per_shard(self) -> int:
        return self.query_idx.shape[1]

    @property
    def imbalance(self) -> float:
        m = self.predicted_load.mean()
        return float(self.predicted_load.max() / max(m, 1e-12))


def schedule_batch(probe_lists: np.ndarray, layout: Layout,
                   latency: TaskLatencyModel,
                   slot_of_instance: np.ndarray, *,
                   tasks_per_shard: int,
                   carry_in: Optional[List[Tuple[int, int]]] = None,
                   filter_ratio: float = 1.35,
                   enable_filter: bool = True) -> ShardSchedule:
    """Greedy least-load assignment of (q, instance) tasks to shards.

    probe_lists (Q, P): per-query located cluster ids (CL output).
    slot_of_instance (n_instances,): shard-local slot of every instance
    (from the materialized shard tensors).
    carry_in: tasks deferred by the previous batch's filter (scheduled
    first — they are already late).
    """
    n_shards = layout.n_shards
    insts = layout.instances
    loads = np.zeros(n_shards)
    assigned: List[List[Tuple[int, int]]] = [[] for _ in range(n_shards)]

    # expand (q, cluster) -> per-part task units with replica choices
    units = []   # (est_latency, q, [instance ids of replicas])
    def expand(q: int, cluster: int, only_part: Optional[int] = None):
        group: dict = {}
        for iid in layout.by_cluster.get(int(cluster), []):
            inst = insts[iid]
            if only_part is not None and inst.part != only_part:
                continue
            group.setdefault(inst.part, []).append(iid)
        for part, iids in group.items():
            est = latency.task_latency(insts[iids[0]].size)
            units.append((est, q, iids))

    for (q, cluster, part) in (carry_in or []):
        expand(q, cluster, only_part=part)
    for q in range(probe_lists.shape[0]):
        for cluster in probe_lists[q]:
            expand(q, int(cluster))

    # LPT greedy: longest tasks first onto the coolest replica shard
    units.sort(key=lambda u: -u[0])
    for est, q, iids in units:
        shard_choices = [(loads[layout.shard_of[i]], i) for i in iids]
        _, pick = min(shard_choices, key=lambda t: t[0])
        s = int(layout.shard_of[pick])
        loads[s] += est
        assigned[s].append((q, int(pick), est))

    # FILTER: defer the tail of overloaded shards to the next batch
    deferred: List[Tuple[int, int, int]] = []
    if enable_filter:
        target = filter_ratio * max(loads.mean(), 1e-12)
        for s in range(n_shards):
            while loads[s] > target and assigned[s]:
                # defer the *last-assigned shortest* task (cheap to redo,
                # likely cold); paper defers from predicted-slow DPUs.
                assigned[s].sort(key=lambda t: -t[2])
                q, iid, est = assigned[s].pop()
                loads[s] -= est
                deferred.append((q, insts[iid].cluster, insts[iid].part))

    # also hard-cap at the static table size
    for s in range(n_shards):
        while len(assigned[s]) > tasks_per_shard:
            q, iid, est = assigned[s].pop()
            loads[s] -= est
            deferred.append((q, insts[iid].cluster, insts[iid].part))

    qi = np.full((n_shards, tasks_per_shard), -1, np.int32)
    si = np.full((n_shards, tasks_per_shard), -1, np.int32)
    nt = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        for t, (q, iid, est) in enumerate(assigned[s]):
            qi[s, t] = q
            si[s, t] = slot_of_instance[iid]
        nt[s] = len(assigned[s])
    return ShardSchedule(qi, si, nt, deferred, loads)


def schedule_naive(probe_lists: np.ndarray, layout: Layout,
                   latency: TaskLatencyModel, slot_of_instance: np.ndarray,
                   *, tasks_per_shard: int) -> ShardSchedule:
    """Baseline: first replica, no balancing, no filter (Fig. 11 baseline)."""
    n_shards = layout.n_shards
    insts = layout.instances
    loads = np.zeros(n_shards)
    assigned: List[List[Tuple[int, int, float]]] = [[] for _ in range(n_shards)]
    dropped: List[Tuple[int, int, int]] = []
    for q in range(probe_lists.shape[0]):
        for cluster in probe_lists[q]:
            group: dict = {}
            for iid in layout.by_cluster.get(int(cluster), []):
                inst = insts[iid]
                group.setdefault(inst.part, []).append(iid)
            for part, iids in group.items():
                iid = iids[0]                      # always replica 0
                s = int(layout.shard_of[iid])
                est = latency.task_latency(insts[iid].size)
                if len(assigned[s]) < tasks_per_shard:
                    loads[s] += est
                    assigned[s].append((q, iid, est))
                else:
                    dropped.append((q, insts[iid].cluster, insts[iid].part))
    qi = np.full((n_shards, tasks_per_shard), -1, np.int32)
    si = np.full((n_shards, tasks_per_shard), -1, np.int32)
    nt = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        for t, (q, iid, est) in enumerate(assigned[s]):
            qi[s, t] = q
            si[s, t] = slot_of_instance[iid]
        nt[s] = len(assigned[s])
    return ShardSchedule(qi, si, nt, dropped, loads)
