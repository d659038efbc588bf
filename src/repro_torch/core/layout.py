"""Offline data-layout generation (paper §IV-C): split, duplicate, allocate.

Observations driving the design (paper §IV-B):
  1. cluster sizes are skewed  -> SPLIT big clusters into parts;
  2. one instance per cluster serializes same-batch queries -> DUPLICATE
     hot clusters;
  3. random placement piles hot clusters onto one DPU -> ALLOCATE greedily
     by accumulated heat (lowest-heat bin first).

"Heat" = expected access frequency in units of *cluster accesses per
query*, estimated by running CL over a sample query set (the paper does
exactly this; ``estimate_heat``).  Online, the serving runtime refreshes
the same vector from served traffic (``runtime.cache.OnlineHeatEstimator``
— identical units, so it can re-drive ``build_layout`` via
``DistributedEngine.refresh_layout``).

All of this is host-side and produces a static per-shard layout — the
only things the online path does are pick replicas (scheduler.py) and,
optionally, re-run this optimizer every ``relayout_every`` batches.

Shapes and invariants:
  * ``sizes``/``heat`` are (nlist,) over *original* cluster ids; layouts
    never renumber clusters, so LUT-cache keys and search results are
    layout-independent (tests assert re-layout preserves results);
  * split parts of a cluster are disjoint row ranges covering it exactly;
    replicas of a part carry ``heat / n_replicas`` each and avoid sharing
    a shard (they exist to parallelize);
  * ``Layout.shard_of`` is (n_instances,) -> shard id; ``stats`` reports
    predicted per-shard load (heat x Eq. 15 task latency, seconds).

The same optimizer drives 2,560 UPMEM DPUs or a 256-chip TPU pod: bins are
abstract shards.

A framework-free copy of the reference's ``repro/core/layout.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.perf_model import TaskLatencyModel


@dataclasses.dataclass(frozen=True)
class ClusterInstance:
    """One placed piece of a cluster: a split part and/or a replica."""
    instance_id: int
    cluster: int          # original cluster id
    part: int             # split-part index within the cluster
    n_parts: int
    start: int            # row offset of this part within the cluster
    size: int             # rows in this part
    replica: int          # replica index of this (cluster, part)
    heat: float           # expected accesses/batch (split across replicas)


@dataclasses.dataclass
class Layout:
    instances: List[ClusterInstance]
    shard_of: np.ndarray          # (n_instances,) -> shard id
    n_shards: int
    # lookup: cluster -> instance ids (all parts x replicas)
    by_cluster: dict

    def instances_on(self, shard: int) -> List[ClusterInstance]:
        return [self.instances[i] for i in np.where(self.shard_of == shard)[0]]

    def stats(self, latency: Optional[TaskLatencyModel] = None) -> dict:
        loads = np.zeros(self.n_shards)
        for inst in self.instances:
            t = (latency.task_latency(inst.size) if latency else inst.size)
            loads[self.shard_of[inst.instance_id]] += inst.heat * t
        return {"max": float(loads.max()), "mean": float(loads.mean()),
                "imbalance": float(loads.max() / max(loads.mean(), 1e-12)),
                "loads": loads}


def estimate_heat(probe_lists: np.ndarray, nlist: int) -> np.ndarray:
    """Heat from a sample query set's CL output (Q, P) -> accesses/query."""
    counts = np.bincount(probe_lists.reshape(-1), minlength=nlist)
    return counts / max(probe_lists.shape[0], 1)


def split_clusters(sizes: np.ndarray, heat: np.ndarray,
                   split_max: int) -> List[ClusterInstance]:
    """Observation 1: cut every cluster into parts of <= split_max rows."""
    out: List[ClusterInstance] = []
    iid = 0
    for c, (sz, h) in enumerate(zip(sizes.tolist(), heat.tolist())):
        n_parts = max(1, -(-sz // split_max)) if sz > 0 else 1
        base = sz // n_parts
        rem = sz - base * n_parts
        start = 0
        for p in range(n_parts):
            psz = base + (1 if p < rem else 0)
            out.append(ClusterInstance(iid, c, p, n_parts, start, psz, 0,
                                       h / n_parts))
            start += psz
            iid += 1
    return out


def duplicate_hot(instances: List[ClusterInstance], *, bytes_per_row: int,
                  dup_budget_bytes: int, max_replicas: int = 8
                  ) -> List[ClusterInstance]:
    """Observation 2: replicate the hottest instances within a memory budget.

    Greedy: always duplicate the instance with the highest heat *per
    replica*; heat is re-split across replicas after each copy.  This is the
    marginal-gain-optimal greedy for makespan under replication.
    """
    insts = list(instances)
    replicas = {i.instance_id: [i] for i in insts}
    spent = 0
    while True:
        # highest current per-replica heat
        cand = max(insts, key=lambda i: i.heat)
        cost = cand.size * bytes_per_row
        if cand.heat <= 0 or spent + cost > dup_budget_bytes:
            break
        group = replicas[cand.instance_id]
        if len(group) >= max_replicas:
            # mark saturated by zeroing its pick priority
            insts = [i for i in insts if i.instance_id != cand.instance_id]
            if not insts:
                break
            continue
        spent += cost
        new_heat = group[0].heat * len(group) / (len(group) + 1)
        group = [dataclasses.replace(g, heat=new_heat) for g in group]
        group.append(dataclasses.replace(group[0], replica=len(group),
                                         heat=new_heat))
        replicas[cand.instance_id] = group
        insts = [dataclasses.replace(i, heat=new_heat)
                 if i.instance_id == cand.instance_id else i for i in insts]
    # flatten + renumber
    flat: List[ClusterInstance] = []
    iid = 0
    for group in replicas.values():
        for g in group:
            flat.append(dataclasses.replace(g, instance_id=iid))
            iid += 1
    return flat


def allocate_greedy(instances: List[ClusterInstance], n_shards: int,
                    latency: Optional[TaskLatencyModel] = None,
                    forbid_same_shard: bool = True) -> np.ndarray:
    """Observation 3: LPT-style greedy — place instances in descending
    expected load onto the currently coolest shard.  Replicas of the same
    (cluster, part) avoid sharing a shard (they exist to parallelize)."""
    loads = np.zeros(n_shards)
    shard_of = np.zeros(len(instances), dtype=np.int64)
    used = {}   # (cluster, part) -> set of shards
    order = sorted(range(len(instances)),
                   key=lambda i: -(instances[i].heat *
                                   (latency.task_latency(instances[i].size)
                                    if latency else instances[i].size)))
    for i in order:
        inst = instances[i]
        key = (inst.cluster, inst.part)
        taken = used.setdefault(key, set())
        ranked = np.argsort(loads)
        pick = None
        for s in ranked:
            if not forbid_same_shard or int(s) not in taken:
                pick = int(s)
                break
        if pick is None:
            pick = int(ranked[0])
        shard_of[i] = pick
        taken.add(pick)
        loads[pick] += inst.heat * (latency.task_latency(inst.size)
                                    if latency else inst.size)
    return shard_of


def allocate_naive(instances: List[ClusterInstance], n_shards: int
                   ) -> np.ndarray:
    """The paper's baseline: clusters to shards in ID order (round-robin by
    contiguous blocks) — what Fig. 11 compares against."""
    ids = np.array([i.instance_id for i in instances])
    per = -(-len(ids) // n_shards)
    return (np.arange(len(ids)) // per).astype(np.int64)


def build_layout(sizes: np.ndarray, heat: np.ndarray, n_shards: int, *,
                 split_max: Optional[int] = None,
                 dup_budget_bytes: int = 0, bytes_per_row: int = 32,
                 latency: Optional[TaskLatencyModel] = None,
                 max_replicas: int = 8, naive: bool = False) -> Layout:
    """End-to-end offline layout generation (Fig. 4 'offline' path)."""
    if split_max is None:
        split_max = int(max(2 * sizes.mean(), 1))
    insts = split_clusters(sizes, heat, split_max)
    if dup_budget_bytes > 0:
        insts = duplicate_hot(insts, bytes_per_row=bytes_per_row,
                              dup_budget_bytes=dup_budget_bytes,
                              max_replicas=max_replicas)
    if naive:
        shard_of = allocate_naive(insts, n_shards)
    else:
        shard_of = allocate_greedy(insts, n_shards, latency)
    by_cluster: dict = {}
    for inst in insts:
        by_cluster.setdefault(inst.cluster, []).append(inst.instance_id)
    return Layout(insts, shard_of, n_shards, by_cluster)
