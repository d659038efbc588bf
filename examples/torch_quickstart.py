"""Quickstart on the PyTorch port: build an IVF-PQ index and search it
with the five-phase DRIM-ANN pipeline, validating the paper's
recall@10 >= 0.8 regime.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The next two searches set ``use_kernels=True``, with f32 and with uint8
LUTs: on the card LC and DC run through the hand-written CUDA kernels
(``src/repro_torch/kernels``), on the CPU through their plain PyTorch
versions.
"""

import argparse

import torch

from repro_torch.core import (SearchParams, build_ivfpq, pad_clusters,
                              recall_at_k, search_ivfpq)
from repro_torch.data import make_clustered_corpus


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    print("generating a SIFT-like clustered uint8 corpus ...")
    ds = make_clustered_corpus(0, n=20_000, d=32, n_queries=128,
                               n_components=32, k_gt=10, device=device)

    print("building IVF-PQ (nlist=64, M=16, CB=256) ...")
    index = build_ivfpq(torch.Generator().manual_seed(0), ds.points,
                        nlist=64, m=16, cb=256, device=device)
    clusters = pad_clusters(index)

    params = SearchParams(nprobe=16, k=10)
    dists, ids = search_ivfpq(index, clusters, ds.queries, params)
    r = recall_at_k(ids, ds.groundtruth)
    print(f"recall@10 = {r:.3f}  (paper constraint: >= 0.8)")
    assert r >= 0.8

    # the same search through the kernels (their plain versions on the
    # CPU), with f32 and with uint8 LUTs
    where = ("the CUDA kernels" if device == "cuda"
             else "the kernels' plain versions")
    rk = {}
    for lut_dtype in ("f32", "uint8"):
        params_k = SearchParams(nprobe=16, k=10, use_kernels=True,
                                query_chunk=32, lut_dtype=lut_dtype)
        _, ids_k = search_ivfpq(index, clusters, ds.queries, params_k)
        rk[lut_dtype] = recall_at_k(ids_k, ds.groundtruth)
        print(f"recall@10 via {where}, {lut_dtype} LUTs = "
              f"{rk[lut_dtype]:.3f}")

    print(f"query 0 neighbors: {ids[0].tolist()}")
    print(f"          dists^2: {[round(float(d), 1) for d in dists[0]]}")
    return {"recall": r, "recall_kernels": rk}


if __name__ == "__main__":
    main()
