"""The generator ``closed_batch``: one client issues ``batch``-query
batches back to back through ``AnnService.search`` for the window; the
batches cycle through a pool of ``pool_batches`` batches drawn from the
seed.  The last batch may end past the window and counts with its time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from annbench.harness import Window

KEYS = {"batch", "pool_batches"}


def pool_size(traffic: dict, seconds: float) -> int:
    return traffic["batch"] * traffic["pool_batches"]


def warm(svc, traffic: dict, pool: np.ndarray) -> None:
    svc.search(pool[:traffic["batch"]])


def run(svc, traffic: dict, pool: np.ndarray, seconds: float, seed: int,
        sync) -> Window:
    b = traffic["batch"]
    rows = [np.arange(s, s + b) for s in range(0, len(pool) - b + 1, b)]
    out = Window(0.0)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        r = rows[i % len(rows)]
        with torch.profiler.record_function("annbench.batch"):
            d, ids = svc.search(pool[r[0]:r[-1] + 1])
        out.blocks.append((r, d, ids))
        i += 1
    sync()
    out.window_s = time.perf_counter() - t0
    return out
