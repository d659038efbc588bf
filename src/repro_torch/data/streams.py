"""Synthetic arrival traces for the serving runtime (numpy-seeded,
bit-exact with the reference generator for the same arguments)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def make_query_stream(queries, n_requests: int, qps: float,
                      rng: Optional[np.random.Generator] = None, *,
                      skew: Optional[float] = None, seed: int = 0,
                      poisson: bool = True) -> List[Tuple]:
    """Arrival trace: ``(t, query)`` pairs.

    Arrivals come at ``qps`` (Poisson gaps, or fixed ``1/qps`` gaps with
    ``poisson=False``); queries are drawn from the pool uniformly or,
    with ``skew`` set, Zipf(``skew``) over the pool by index rank (hot
    queries repeat).
    """
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    rng = rng if rng is not None else np.random.default_rng(seed)
    if poisson:
        gaps = rng.exponential(1.0 / qps, size=n_requests)
    else:
        gaps = np.full(n_requests, 1.0 / qps)
    times = np.cumsum(gaps)
    if skew is None:
        picks = rng.integers(0, len(queries), size=n_requests)
    else:
        ranks = np.arange(1, len(queries) + 1, dtype=np.float64)
        pmf = ranks ** -skew
        pmf /= pmf.sum()
        picks = rng.choice(len(queries), size=n_requests, p=pmf)
    return [(float(times[i]), queries[picks[i]]) for i in range(n_requests)]
