"""Deterministic fault injection for the serving stack.

A framework-free copy of the reference's ``repro/runtime/faults.py``
(numpy only): every rule keeps the reference's generator,
``np.random.default_rng(np.random.SeedSequence([seed, idx]))``, so the
decision sequence at every site equals the reference's bit for bit.

A production service is defined by how it behaves when things break —
UpANNS and Cosmos (PAPERS.md) both stress that real deployments live or
die at the tails.  This module is the chaos side of that argument: a
seeded :class:`FaultPlan` names *where* faults fire (injection sites)
and *how often*, and a :class:`FaultInjector` is consulted by the
serving components at those sites through one cheap hook each.

Design rules:

  * **Zero cost when disabled.** Components hold ``self.faults = None``
    by default and guard every site with ``if self.faults is not None``
    — one attribute load and branch on the hot path, nothing else.
  * **Deterministic when armed.** Each rule owns an independent
    ``np.random.Generator`` seeded from ``(plan.seed, site, rule index)``
    so the decision *sequence* at a site is a pure function of the plan,
    not of thread interleaving at other sites.  (Which request a firing
    lands on still depends on arrival order; the chaos harness asserts
    properties that are interleaving-invariant: availability floors,
    bit-exactness of non-degraded results, quarantine/rebuild counts.)
  * **Sites are named, not ad hoc.** :data:`SITES` is the closed set;
    constructing a rule for an unknown site is a ``ValueError`` so a
    typo'd chaos config fails at build time, not silently never fires.

Injection sites (consulted by → effect):

  ============================ ======================================
  ``engine.batch``             ServingRuntime._serve → raises
                               :class:`InjectedFault`, surfacing as a
                               ``BatchServeError`` (exercises retry v2
                               + circuit breaker)
  ``engine.straggler``         ServingRuntime._serve → sleeps
                               ``rule.delay_s`` before serving
                               (exercises deadline/degraded paths)
  ``tier.cold_read``           TieredStore cold fetch → raises
                               ``IOError`` (exercises resident-only
                               degraded search)
  ``tier.spill_corrupt``       TieredStore gather → flips bytes of one
                               cluster's spill region on disk
                               (exercises checksum quarantine/rebuild)
  ``maintenance.death``        MutationCoordinator maintenance thread →
                               raises (exercises surfaced-error path)
  ============================ ======================================
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

SITES = (
    "engine.batch",
    "engine.straggler",
    "tier.cold_read",
    "tier.spill_corrupt",
    "maintenance.death",
)


class InjectedFault(RuntimeError):
    """Raised (or wrapped) when an armed injection site fires."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One site's firing policy.

    ``rate`` is the per-consultation firing probability; ``count`` caps
    total firings (``None`` = unbounded); ``after`` skips the first N
    consultations so warmup traffic stays clean.  ``replicas`` restricts
    the rule to specific replica indices (empty = all).  ``delay_s`` is
    the straggler sleep; ``cluster`` pins ``tier.spill_corrupt`` to one
    cluster id (``None`` = the store picks a resident cluster).
    """

    site: str
    rate: float = 1.0
    count: Optional[int] = None
    after: int = 0
    replicas: Tuple[int, ...] = ()
    delay_s: float = 0.0
    cluster: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known sites: {', '.join(SITES)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.count is not None and self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")
        if self.after < 0:
            raise ValueError(f"after must be >= 0, got {self.after}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus the rule set — the full, reproducible chaos config."""

    seed: int
    rules: Tuple[FaultRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def describe(self) -> str:
        lines = [f"FaultPlan(seed={self.seed})"]
        for r in self.rules:
            lines.append(f"  {r.site}: rate={r.rate} count={r.count} "
                         f"after={r.after}")
        return "\n".join(lines)


class _RuleState:
    def __init__(self, rule: FaultRule, seed: int, idx: int):
        self.rule = rule
        # independent substream per rule: decisions at one site never
        # depend on how often another site was consulted
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, idx]))
        self.consultations = 0
        self.fires = 0

    def draw(self, replica: Optional[int]) -> bool:
        r = self.rule
        if r.replicas and replica is not None and replica not in r.replicas:
            return False
        self.consultations += 1
        if self.consultations <= r.after:
            return False
        if r.count is not None and self.fires >= r.count:
            return False
        if r.rate < 1.0 and self.rng.random() >= r.rate:
            return False
        self.fires += 1
        return True


class FaultInjector:
    """Consults a :class:`FaultPlan` at named sites.  Thread-safe.

    ``fire(site, replica=...)`` returns the matching :class:`FaultRule`
    when the site fires (caller applies the effect — raise, sleep,
    corrupt) or ``None``.  Sites with no rule return ``None`` after a
    single dict probe, so an armed injector is still near-free at sites
    the plan doesn't cover.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._by_site: dict = {}
        for idx, rule in enumerate(plan.rules):
            self._by_site.setdefault(rule.site, []).append(
                _RuleState(rule, plan.seed, idx))

    def fire(self, site: str, *,
             replica: Optional[int] = None) -> Optional[FaultRule]:
        states = self._by_site.get(site)
        if not states:
            return None
        with self._lock:
            for st in states:
                if st.draw(replica):
                    return st.rule
        return None

    def stats(self) -> dict:
        """Per-site {consultations, fires} — the chaos harness's ledger."""
        with self._lock:
            out = {}
            for site, states in self._by_site.items():
                out[site] = {
                    "consultations": sum(s.consultations for s in states),
                    "fires": sum(s.fires for s in states)}
            return out


def arm(component, injector: Optional[FaultInjector]) -> None:
    """Attach ``injector`` to any component exposing a ``faults`` slot."""
    component.faults = injector
