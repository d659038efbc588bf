"""Multi-replica router: pick which replica serves each incoming query.

A copy of ``repro/service/router.py`` (framework-free), on the port's
:class:`~repro_torch.runtime.cache.OnlineHeatEstimator`.

The service tier runs N replicas — identical engine + serving-runtime
stacks over one index — and every query is routed to exactly one of
them.  Because engines are deterministic and replicas identical, the
*results* are routing-independent (tests pin per-query neighbor sets
across replica counts and policies); what routing changes is queueing
and, with the hot-cluster LUT cache on, each replica's cache contents.

Policies (:class:`RoutingPolicy` implementations):

  * ``round_robin``  — rotate; baseline, perfectly even request counts;
  * ``least_queue``  — pick the shallowest micro-batcher queue (ties
    rotate), the classic load-balancing heuristic;
  * ``cache_aware``  — score each replica by the *expected LUT-bank hit
    rate* for the query's probed clusters: the router keeps one
    :class:`~repro_torch.runtime.cache.OnlineHeatEstimator` per replica, fed
    only with the probe lists of queries actually routed there, so
    ``heat_r(c)`` is expected accesses/query to cluster ``c`` on replica
    ``r`` — the same units the layout optimizer and cache admission use.
    ``min(heat_r(c), 1)`` approximates the probability that replica
    ``r``'s cache holds a LUT for cluster ``c``, and the score is the
    mean over the query's ``nprobe`` clusters.  Hot probe sets therefore
    keep landing on the replica that already cached them (affinity),
    instead of warming every replica's cache with the same entries.
    Cold-start and exact ties fall back to least-queue, then rotation,
    and a bounded-load spill (``overload_factor`` x fair share) stops
    pure affinity from collapsing the fleet onto one replica.

The router only ever sees real submitted queries — serving-batch padding
rows are created downstream in each replica's micro-batcher, so they can
never touch the routing heat estimators (pinned by a test).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.cache import OnlineHeatEstimator


class RoutingPolicy:
    """Pick a replica index for a query.

    ``pick(query, probes, depths)``: ``probes`` is the query's (P,)
    probed cluster ids when ``wants_probes`` else None; ``depths`` is the
    per-replica micro-batcher queue depth.  ``observe(ridx, probes)`` is
    called after the pick with the chosen replica.
    """

    name = "base"
    wants_probes = False

    def pick(self, query: np.ndarray, probes: Optional[np.ndarray],
             depths: Sequence[int]) -> int:
        raise NotImplementedError

    def observe(self, ridx: int, probes: Optional[np.ndarray]) -> None:
        pass

    def resize(self, n_replicas: int) -> None:
        """The autoscaler grew/shrank the live fleet to ``n_replicas``
        (LIFO: growth appends, shrink drops the tail).  Stateless
        policies need nothing — ``pick`` already keys on ``len(depths)``.
        Stateful policies drop the drained tail's state here, so a
        replica that later re-joins at the same index starts cold
        instead of inheriting stale heat."""

    def invalidate_clusters(self, nlist: int) -> None:
        """A new index *generation* was installed (live-index maintenance
        split/merged clusters and possibly retrained codebooks), so
        cluster ids changed meaning and any per-cluster routing state is
        stale.  ``nlist`` is the new generation's cluster count.
        Stateless policies need nothing."""


class RoundRobinPolicy(RoutingPolicy):
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def pick(self, query, probes, depths) -> int:
        r = self._i % len(depths)
        self._i += 1
        return r


class LeastQueuePolicy(RoutingPolicy):
    """Shallowest queue wins; ties rotate so an idle fleet still spreads."""
    name = "least_queue"

    def __init__(self):
        self._i = 0

    def pick(self, query, probes, depths) -> int:
        n = len(depths)
        best = min(depths)
        ties = [r for r in range(n) if depths[r] == best]
        r = ties[self._i % len(ties)]
        self._i += 1
        return r


class CacheAwarePolicy(RoutingPolicy):
    """Route to the replica with the highest expected LUT-bank hit rate
    for this query's probed clusters (see module docstring).

    Affinity alone is a positive-feedback loop: only the routed replica's
    heat grows, so under high probe overlap (nprobe comparable to nlist)
    every query scores one replica strictly highest and the fleet would
    collapse onto a single server.  ``overload_factor`` bounds that: a
    replica already past ``overload_factor`` x fair share of assignments
    spills the query to the least-assigned replica instead (consistent-
    hashing-with-bounded-loads style), trading a little hit rate for
    guaranteed spread.
    """

    name = "cache_aware"
    wants_probes = True

    def __init__(self, nlist: int, n_replicas: int,
                 halflife_batches: float = 64.0,
                 overload_factor: float = 1.5):
        if overload_factor < 1.0:
            # 1.0 is fair-share-exact (every assignment beyond an even
            # split spills); below 1.0 the cap is unsatisfiable
            raise ValueError("overload_factor must be >= 1")
        self.nlist = int(nlist)
        self.halflife_batches = float(halflife_batches)
        self.estimators = [OnlineHeatEstimator(nlist, halflife_batches)
                           for _ in range(n_replicas)]
        self.assigned = [0] * n_replicas
        self.overload_factor = float(overload_factor)
        self._i = 0

    def resize(self, n_replicas: int) -> None:
        """Grow: fresh (cold) estimators for the new tail.  Shrink: the
        drained tail's heat and assignment counts are dropped outright —
        full decay, so hot clusters re-learn their home among the
        survivors and a re-grown replica at that index starts cold."""
        cur = len(self.estimators)
        if n_replicas > cur:
            self.estimators += [
                OnlineHeatEstimator(self.nlist, self.halflife_batches)
                for _ in range(n_replicas - cur)]
            self.assigned += [0] * (n_replicas - cur)
        else:
            del self.estimators[n_replicas:]
            del self.assigned[n_replicas:]

    def invalidate_clusters(self, nlist: int) -> None:
        """Generation swap: every replica's cache was cleared, so learned
        affinity is void — reset each estimator in place at the new
        cluster count (assignment counts survive: bounded-load spill is
        about request spread, which the swap does not rewrite)."""
        self.nlist = int(nlist)
        for est in self.estimators:
            est.reset(nlist=self.nlist)

    def expected_hit_rate(self, ridx: int, probes: np.ndarray) -> float:
        """Mean over probed clusters of min(heat_r(c), 1) — heat is
        expected accesses/query, so clipped at 1 it reads as 'fraction of
        this query's LUT lookups likely resident on replica ridx'."""
        est = self.estimators[ridx]
        return float(np.mean([min(est.heat_of(int(c)), 1.0)
                              for c in np.asarray(probes).reshape(-1)]))

    def pick(self, query, probes, depths) -> int:
        n = len(depths)
        scores = [self.expected_hit_rate(r, probes) for r in range(n)]
        best = max(scores)
        ties = [r for r in range(n) if scores[r] >= best - 1e-12]
        if len(ties) > 1:                      # cold start / exact tie:
            shallow = min(depths[r] for r in ties)   # least queue, then
            ties = [r for r in ties if depths[r] == shallow]   # rotate
            r = ties[self._i % len(ties)]
            self._i += 1
            return r
        r = ties[0]
        # bounded load: past overload_factor x fair share, spill to the
        # least-assigned replica (best score breaks spill ties)
        cap = self.overload_factor * (sum(self.assigned) + 1) / n
        if self.assigned[r] + 1 > cap:
            return min(range(n),
                       key=lambda j: (self.assigned[j], -scores[j]))
        return r

    def observe(self, ridx, probes) -> None:
        self.assigned[ridx] += 1
        self.estimators[ridx].observe(np.asarray(probes).reshape(1, -1))


def make_policy(name: str, *, nlist: int, n_replicas: int,
                halflife_batches: float = 64.0) -> RoutingPolicy:
    if name == "round_robin":
        return RoundRobinPolicy()
    if name == "least_queue":
        return LeastQueuePolicy()
    if name == "cache_aware":
        return CacheAwarePolicy(nlist, n_replicas, halflife_batches)
    raise ValueError(f"unknown router policy {name!r}")


class Router:
    """Stateful dispatcher: policy + per-replica pick accounting.

    ``probe_fn(query) -> (P,) cluster ids`` is only invoked for policies
    with ``wants_probes`` (one tiny CL GEMM per routed query — the same
    computation the engine repeats per batch, at single-query shape)."""

    def __init__(self, policy: RoutingPolicy, n_replicas: int,
                 depth_fn: Callable[[int], int],
                 probe_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None):
        if policy.wants_probes and probe_fn is None:
            raise ValueError(f"policy {policy.name!r} needs a probe_fn")
        self.policy = policy
        self.n_replicas = int(n_replicas)
        self._depth_fn = depth_fn
        self._probe_fn = probe_fn
        self.picks: List[int] = [0] * self.n_replicas
        # per-tenant pick counts (tenant id -> per-replica list): shows
        # whether QoS interleaving upstream still spreads each tenant's
        # dispatches across the fleet (only scoped requests are tracked)
        self.tenant_picks: dict = {}

    def resize(self, n_replicas: int) -> None:
        """Follow an autoscale event: route over the new live fleet.
        Pick counts for drained replicas are kept (they served real
        traffic — stats must still sum to the request count); the
        policy's per-replica state is resized (see ``resize`` on the
        policy)."""
        n = int(n_replicas)
        if n < 1:
            raise ValueError(f"router needs >= 1 live replica, got {n}")
        self.n_replicas = n
        if len(self.picks) < n:
            self.picks += [0] * (n - len(self.picks))
        self.policy.resize(n)

    def invalidate_clusters(self, nlist: int) -> None:
        """Forward a generation swap to the policy (see
        :meth:`RoutingPolicy.invalidate_clusters`)."""
        self.policy.invalidate_clusters(int(nlist))

    def route(self, query: np.ndarray, tenant: int = -1) -> int:
        probes = (self._probe_fn(query) if self.policy.wants_probes
                  else None)
        depths = [self._depth_fn(r) for r in range(self.n_replicas)]
        r = int(self.policy.pick(query, probes, depths))
        if not 0 <= r < self.n_replicas:
            raise ValueError(f"policy {self.policy.name!r} picked replica "
                             f"{r} of {self.n_replicas}")
        self.picks[r] += 1
        if tenant >= 0:
            per = self.tenant_picks.setdefault(int(tenant),
                                               [0] * len(self.picks))
            if len(per) < len(self.picks):
                per += [0] * (len(self.picks) - len(per))
            per[r] += 1
        self.policy.observe(r, probes)
        return r

    def record(self, r: int, tenant: int = -1) -> None:
        """Account a dispatch that reused a prior pick (sticky WFQ
        chunking upstream) without consulting the policy — pick counts
        must still sum to the dispatched request count.  The policy's
        ``observe`` is not called: a sticky repeat is a batching
        decision, not an affinity signal."""
        if not 0 <= r < self.n_replicas:
            raise ValueError(f"record: replica {r} of {self.n_replicas}")
        self.picks[r] += 1
        if tenant >= 0:
            per = self.tenant_picks.setdefault(int(tenant),
                                               [0] * len(self.picks))
            if len(per) < len(self.picks):
                per += [0] * (len(self.picks) - len(per))
            per[r] += 1

    def stats(self) -> dict:
        out = {"policy": self.policy.name, "picks": list(self.picks),
               "live": self.n_replicas}
        if self.tenant_picks:
            out["tenant_picks"] = {t: list(p) for t, p in
                                   sorted(self.tenant_picks.items())}
        return out
