"""End-to-end distributed DRIM-ANN on the PyTorch port, through the
service layer: one ServiceSpec per configuration stands up the sharded
engine (layout optimization: split / duplicate / heat-allocate, plus
runtime scheduling with the batch filter) over 8 simulated 'DPU' shards
on one device; the ablation toggles the naive layout and schedule via
``engine_overrides``.

    PYTHONPATH=src python examples/torch_distributed_anns.py         # the card
    PYTHONPATH=src python examples/torch_distributed_anns.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import cluster_locate, recall_at_k
from repro_torch.data import make_clustered_corpus
from repro_torch.service import AnnService, IndexSpec, ServiceSpec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    ds = make_clustered_corpus(0, n=20_000, d=32, n_queries=128,
                               n_components=32, k_gt=10, zipf_a=1.3,
                               device=device)
    queries = ds.queries.float().cpu().numpy()

    out = {}
    index = None      # built by the first spec, shared by the second
    for name, split_max, dup_bytes, overrides in (
            ("naive (ID-order, no balance)", 10 ** 9, 0,
             dict(naive_layout=True, naive_schedule=True)),
            ("DRIM-ANN (split+dup+alloc+sched)", 256, 1 << 20, None)):
        spec = ServiceSpec(
            engine="sharded", nprobe=16, k=10, strategy="gather",
            index=IndexSpec(nlist=64, m=16, cb=256),
            n_shards=8, tasks_per_shard=512,
            split_max=split_max, dup_budget_bytes=dup_bytes,
            engine_overrides=overrides)
        svc = AnnService.build(spec, points=ds.points.cpu().numpy(),
                               index=index, sample_queries=queries,
                               device=device)
        index = svc.index
        _, ids = svc.search(queries)
        r = recall_at_k(torch.from_numpy(ids), ds.groundtruth.cpu())

        # layout / scheduler internals for the ablation read-out (probe
        # lists at the paper's heat-sample width, as in the original
        # ablation)
        eng = svc.core_engine()                       # DistributedEngine
        stats = eng.layout.stats(eng.latency)
        probes, _ = cluster_locate(ds.queries.float(), eng.index.centroids,
                                   8)
        sched = eng.schedule(probes=probes.cpu().numpy())
        eng.carry = []
        makespan_ms = float(np.max(sched.predicted_load)) * 1e3
        print(f"{name}:")
        print(f"  recall@10={r:.3f}  layout imbalance="
              f"{stats['imbalance']:.2f}  predicted makespan="
              f"{makespan_ms:.2f}ms")
        out[name] = {"recall": r, "imbalance": stats["imbalance"],
                     "makespan_ms": makespan_ms}
        svc.shutdown()
    return out


if __name__ == "__main__":
    main()
