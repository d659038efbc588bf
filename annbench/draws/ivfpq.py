"""The draw ``ivfpq``: an IVF-PQ index and a query pool from ``--seed``.

The harness draws the index instead of building it (no k-means in
set-up) and hands the same arrays to the program and to the reference.
Every draw runs on the given device from one ``torch.Generator`` there,
in a few large calls:

* centroids ``(nlist, D)``: ``centroid_mean + centroid_std * N(0, 1)``;
* the PQ codebook ``(M, CB, D/M)``: ``codebook_std * N(0, 1)``;
* cluster sizes: one fixed multiset for every seed (the quantiles of a
  log-normal of spread ``size_lognormal_sigma`` scaled to N points,
  largest remainders rounded up), dealt to the clusters in a seeded
  order, so every seed scans the same padded layout;
* codes uniform over ``0..CB-1`` and ids a permutation of ``0..N-1``,
  laid out by cluster (CSR: ``offsets``);
* queries: the centroid of a cluster drawn with probability proportional
  to its size, plus ``query_noise_std * N(0, 1)``; ``"query_domain":
  "uint8"`` rounds and clamps them to ``0..255`` (SIFT's integers).  A
  mix's ``"cluster_zipf": s`` draws the cluster instead with probability
  proportional to ``rank ** -s``, the ranks dealt to the clusters in a
  seeded order (skewed traffic, which a cache would see).

The configuration gives ``n_points``, ``dim`` and ``query_domain`` at
its top level, ``nlist``, ``m`` and ``cb`` in ``service.index``, and the
spreads under ``assumed``.

Imports neither the program nor JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

KEYS = {"n_points", "dim", "query_domain"}
TRAFFIC_KEYS = {"cluster_zipf"}


class DrawnIndex(NamedTuple):
    centroids: torch.Tensor   # (nlist, D) f32
    codebooks: torch.Tensor   # (M, CB, dsub) f32
    codes: torch.Tensor       # (N, M) u8, sorted by cluster
    ids: torch.Tensor         # (N,) i32, a permutation of 0..N-1
    offsets: torch.Tensor     # (nlist + 1,) i32

    @property
    def sizes(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]


class Drawn(NamedTuple):
    index: DrawnIndex
    queries: torch.Tensor               # (count, D) f32
    points: Optional[torch.Tensor] = None


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def size_multiset(n: int, nlist: int, sigma: float) -> torch.Tensor:
    """(nlist,) int64 cluster sizes summing to ``n``, ascending: the
    quantiles ``(i + 0.5) / nlist`` of a log-normal of spread ``sigma``,
    scaled to ``n`` points; the largest fractional parts round up."""
    p = (torch.arange(nlist, dtype=torch.float64) + 0.5) / nlist
    w = torch.exp(sigma * torch.special.ndtri(p))
    exact = w / w.sum() * n
    sizes = torch.floor(exact).long()
    short = n - int(sizes.sum())
    if short:
        frac = exact - sizes
        sizes[torch.argsort(frac, descending=True, stable=True)[:short]] += 1
    return sizes.sort().values


def draw_index(cfg: dict, seed: int, device) -> tuple:
    """The cell's index and the generator, positioned to draw queries."""
    shape = cfg["service"]["index"]
    n, d, nlist = cfg["n_points"], cfg["dim"], shape["nlist"]
    m, cb = shape["m"], shape["cb"]
    a = cfg["assumed"]
    g = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    centroids = torch.randn((nlist, d), **f32).mul_(a["centroid_std"]).add_(
        a["centroid_mean"])
    codebooks = torch.randn((m, cb, d // m), **f32).mul_(a["codebook_std"])
    sizes = size_multiset(n, nlist, a["size_lognormal_sigma"]).to(device)
    sizes = sizes[torch.randperm(nlist, generator=g, device=device)]
    offsets = torch.zeros(nlist + 1, dtype=torch.int64, device=device)
    torch.cumsum(sizes, 0, out=offsets[1:])
    codes = torch.randint(0, cb, (n, m), dtype=torch.uint8, device=device,
                          generator=g)
    ids = torch.randperm(n, generator=g, device=device).to(torch.int32)
    return DrawnIndex(centroids, codebooks, codes, ids,
                      offsets.to(torch.int32)), g


def draw_queries(cfg: dict, traffic: dict, index: DrawnIndex,
                 g: torch.Generator, count: int) -> torch.Tensor:
    """(count, D) f32 queries on the index's device."""
    a = cfg["assumed"]
    dev = index.centroids.device
    weight = index.sizes.to(torch.float32)
    if traffic.get("cluster_zipf"):
        rank = torch.randperm(len(weight), generator=g, device=dev)
        weight = (rank + 1).to(torch.float64).pow(
            -float(traffic["cluster_zipf"])).to(torch.float32)
    pick = torch.multinomial(weight, count, replacement=True, generator=g)
    q = torch.randn((count, cfg["dim"]), dtype=torch.float32, device=dev,
                    generator=g).mul_(a["query_noise_std"])
    q += index.centroids[pick]
    if cfg["query_domain"] == "uint8":
        q.round_().clamp_(0, 255)
    return q


def draw(cfg: dict, traffic: dict, seed: int, device, count: int) -> Drawn:
    """The index and ``count`` queries of one run."""
    index, g = draw_index(cfg, seed, device)
    return Drawn(index, draw_queries(cfg, traffic, index, g, count))
