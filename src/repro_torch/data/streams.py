"""Synthetic arrival traces for the serving runtime (numpy-seeded,
bit-exact with the reference generator for the same arguments): Poisson
arrivals, Zipf-by-rank query popularity, Zipf-by-rank tenant mix."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def make_query_stream(queries, n_requests: int, qps: float,
                      rng: Optional[np.random.Generator] = None, *,
                      skew: Optional[float] = None, seed: int = 0,
                      poisson: bool = True,
                      tenants: Union[int, Sequence[int], None] = None,
                      tenant_skew: Optional[float] = None,
                      tenant_weights: Optional[Sequence[float]] = None
                      ) -> List[Tuple]:
    """Arrival trace: ``(t, query)`` pairs, or ``(t, query, tenant)``
    triples when ``tenants`` is set.

    Arrivals come at ``qps`` (Poisson gaps, or fixed ``1/qps`` gaps with
    ``poisson=False``); queries are drawn from the pool uniformly or,
    with ``skew`` set, Zipf(``skew``) over the pool by index rank (hot
    queries repeat).

    ``tenants`` is a tenant count or an explicit id list; each request's
    tenant is drawn Zipf(``tenant_skew``) by rank over that list (first
    entry hottest; ``None`` is uniform), or with the explicit per-tenant
    ``tenant_weights``.  The query draw stays independent of the tenant
    draw, and comes first, so a trace with tenants has the times and
    queries of the same trace without.
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
    if tenants is None:
        if tenant_skew is not None or tenant_weights is not None:
            raise ValueError("tenant_skew/tenant_weights need tenants=")
        return [(float(times[i]), queries[picks[i]])
                for i in range(n_requests)]
    ids = (np.arange(int(tenants), dtype=np.int64)
           if np.isscalar(tenants) else np.asarray(tenants, np.int64))
    if ids.size < 1:
        raise ValueError(f"tenants must name at least one tenant, "
                         f"got {tenants!r}")
    if tenant_weights is not None:
        if tenant_skew is not None:
            raise ValueError("pass tenant_skew or tenant_weights, not both")
        w = np.asarray(tenant_weights, np.float64)
        if w.shape != ids.shape or (w <= 0).any():
            raise ValueError(f"tenant_weights must be {ids.size} positive "
                             f"weights, got {tenant_weights!r}")
    elif tenant_skew is not None:
        w = np.arange(1, ids.size + 1, dtype=np.float64) ** -tenant_skew
    else:
        w = np.ones(ids.size, np.float64)
    w = w / w.sum()
    tpicks = rng.choice(ids.size, size=n_requests, p=w)
    return [(float(times[i]), queries[picks[i]], int(ids[tpicks[i]]))
            for i in range(n_requests)]
