"""RAG serving end to end on the PyTorch port: one ServiceSpec stands up
the retrieval tier (sharded DRIM-ANN engines, LUT caches, micro-batching
runtimes, a cache-aware router over two replicas), a stream of
single-query requests flows through it, and the retrieved vectors become
the cross-attention context of an LM's decode loop, the paper's
motivating application (§I).

Pipeline: ServiceSpec -> AnnService.build -> routed query stream ->
per-replica micro-batches -> sharded top-k (the CUDA kernels on the card)
-> per-request results, checked against a direct batched search ->
retrieved vectors projected to context embeddings -> batched decode of
llama-3.2-vision's smoke config.

    PYTHONPATH=src python examples/torch_rag_serving.py               # the card
    PYTHONPATH=src python examples/torch_rag_serving.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import make_clustered_corpus
from repro_torch.launch.serve import D_EMBED, generate, rag_context
from repro_torch.models import init_params
from repro_torch.service import AnnService, IndexSpec, ServiceSpec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    # --- one spec for the whole retrieval tier ---------------------------
    n_queries = 8
    ds = make_clustered_corpus(seed=0, n=10_000, d=D_EMBED,
                               n_queries=n_queries, n_components=16,
                               device=device)
    points = ds.points.cpu().numpy()
    queries = ds.queries.float().cpu().numpy()
    spec = ServiceSpec(
        engine="sharded", replicas=2, router="cache_aware",
        nprobe=8, k=4, strategy="gather",
        index=IndexSpec(nlist=32, m=8, cb=64),
        n_shards=4, tasks_per_shard=256,
        buckets=(1, 2, 4), max_wait_s=1e-3,
        cache_capacity=1024)
    svc = AnnService.build(spec, points=points, sample_queries=queries,
                           device=device)
    try:
        svc.warmup()

        # --- single-query requests through the router --------------------
        stream = [(i * 4e-4, queries[i % n_queries])
                  for i in range(2 * n_queries)]        # each query repeats
        requests = svc.stream(stream)
        doc_ids = np.stack([r.ids for r in requests[:n_queries]])

        # served results == a direct batched search, per query (as
        # neighbour sets: the sharded merge may permute equal-distance ties)
        _, direct_i = svc.search(queries)
        served_ok = all(set(r.ids.tolist())
                        == set(direct_i[i % n_queries].tolist())
                        for i, r in enumerate(requests))
        if not served_ok:
            raise RuntimeError("serving != direct search")
        st = svc.stats()
    finally:
        svc.shutdown()
    agg, rt = st["aggregate"], st["router"]
    print(f"served {agg['requests']} requests over {spec.replicas} "
          f"replicas in {agg['batches']} micro-batches "
          f"(router={rt['policy']} picks={rt['picks']})")
    print(f"latency p50={agg['p50_ms']:.2f}ms p99={agg['p99_ms']:.2f}ms"
          f" qps={agg['qps']:.0f}"
          f" lut_hit_rate={agg.get('lut_hit_rate', 0.0):.2f}")
    print("retrieved doc ids per query:", doc_ids.tolist())

    # --- generation tier: a cross-attention LM over the retrieved context -
    cfg = registry.get_config("llama32_vision_11b", smoke=True)
    params = init_params(cfg, 0, device=device)
    ctx = torch.from_numpy(rag_context(points, doc_ids, cfg)).to(device)
    g = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (n_queries, 8), generator=g,
                            device=device)
    toks = generate(cfg, params, prompts, gen_len=12, ctx=ctx)
    print("generated token ids (first query):", toks[0].tolist())
    print("RAG pipeline OK: routed streaming retrieval -> generation")
    return {"doc_ids": doc_ids, "tokens": toks.cpu().numpy(),
            "served_ok": served_ok, "stats": agg}


if __name__ == "__main__":
    main()
