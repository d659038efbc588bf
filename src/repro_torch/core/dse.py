"""ANN design-space exploration (paper §III-C, Eq. 13).

Find (K, P, C[=N/nlist], M, CB) minimizing the modeled batch time subject to
``accuracy(params) >= constraint``.  Accuracy is "fetched from a table" in
the paper ([23]-style recall tables); here the table is *measured*: a recall
probe on a sampled sub-corpus per candidate (cached), which is exactly how
such tables are produced.

Search procedure (paper): greedy feasible start + Bayesian optimization with
the performance model inside the acquisition evaluation.  We implement a
light GP-BO (RBF kernel over normalized log-params, expected improvement) —
no external deps — and fall back to exhaustive scan when the space is small
(the paper notes the same degenerate case).

A framework-free copy of the reference's ``repro/core/dse.py`` (numpy
only) over the port's own copy of the performance model.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Iterable, Sequence

import numpy as np

from repro_torch.core.perf_model import (HardwareProfile, IndexParams,
                                         UPMEM_PROFILE, total_time)


@dataclasses.dataclass(frozen=True)
class DSESpace:
    k: Sequence[int] = (10,)
    nprobe: Sequence[int] = (8, 16, 32, 64, 96, 128)
    nlist: Sequence[int] = (256, 1024, 4096, 16384, 65536)
    m: Sequence[int] = (8, 16, 32)
    cb: Sequence[int] = (256,)

    def grid(self) -> Iterable[tuple]:
        return itertools.product(self.k, self.nprobe, self.nlist, self.m,
                                 self.cb)

    def size(self) -> int:
        return (len(self.k) * len(self.nprobe) * len(self.nlist) *
                len(self.m) * len(self.cb))


@dataclasses.dataclass
class DSEResult:
    best: Dict
    history: list          # [(params_dict, time_s, acc, feasible)]
    evals: int


def _mk_ix(base: IndexParams, k, p, nlist, m, cb) -> IndexParams:
    return dataclasses.replace(base, k=k, p=p, nlist=nlist, m=m, cb=cb)


# ---------------------------------------------------------------------------
# Minimal GP for expected improvement (RBF kernel, unit noise floor).
# ---------------------------------------------------------------------------

class _GP:
    def __init__(self, ls: float = 1.0, noise: float = 1e-4):
        self.ls, self.noise = ls, noise
        self.x = None
        self.y = None

    def fit(self, x: np.ndarray, y: np.ndarray):
        self.x, self.y = x, y
        k = self._k(x, x) + self.noise * np.eye(len(x))
        self._l = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._l.T, np.linalg.solve(self._l, y - y.mean()))
        self._ymean = y.mean()

    def _k(self, a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def predict(self, xs: np.ndarray):
        ks = self._k(self.x, xs)
        mu = self._ymean + ks.T @ self._alpha
        v = np.linalg.solve(self._l, ks)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu, np.sqrt(var)


def _ei(mu, sd, best):
    """Expected improvement for minimization."""
    z = (best - mu) / sd
    phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    return (best - mu) * cdf + sd * phi


def _normalize(pt, space: DSESpace) -> np.ndarray:
    def nz(v, seq):
        lo, hi = math.log2(min(seq)), math.log2(max(seq))
        return 0.5 if hi == lo else (math.log2(v) - lo) / (hi - lo)
    k, p, nl, m, cb = pt
    return np.array([nz(k, space.k), nz(p, space.nprobe), nz(nl, space.nlist),
                     nz(m, space.m), nz(cb, space.cb)])


def run_dse(base: IndexParams,
            accuracy_fn: Callable[[IndexParams], float],
            accuracy_constraint: float = 0.8,
            hw: HardwareProfile = UPMEM_PROFILE,
            space: DSESpace = DSESpace(),
            budget: int = 24,
            multiplierless: bool = True,
            seed: int = 0,
            exhaustive_threshold: int = 32) -> DSEResult:
    """Bayesian-optimized DSE under the recall constraint (Eq. 13)."""
    rng = np.random.default_rng(seed)
    cands = list(space.grid())
    history = []
    acc_cache: Dict[tuple, float] = {}

    def evaluate(pt) -> tuple[float, float, bool]:
        ix = _mk_ix(base, *pt)
        if pt not in acc_cache:
            acc_cache[pt] = float(accuracy_fn(ix))
        acc = acc_cache[pt]
        t = total_time(ix, hw, multiplierless=multiplierless)
        feasible = acc >= accuracy_constraint
        history.append((dataclasses.asdict(ix), t, acc, feasible))
        return t, acc, feasible

    # Small space -> exhaustive (paper: "similar to exhaustive search")
    if len(cands) <= exhaustive_threshold or budget >= len(cands):
        for pt in cands:
            evaluate(pt)
        return _finish(history)

    # 1) greedy feasible start: cheapest-by-model first until feasible
    order = sorted(cands, key=lambda pt: total_time(
        _mk_ix(base, *pt), hw, multiplierless=multiplierless))
    evaluated = set()
    for pt in order:
        t, acc, feas = evaluate(pt)
        evaluated.add(pt)
        if feas:
            break
        if len(evaluated) >= max(4, budget // 4):
            break

    # 2) BO iterations: model *penalized* objective (time + infeasibility)
    def penalized(h):
        _, t, acc, feas = h
        return t * (1.0 if feas else 1.0 + 10.0 * (accuracy_constraint - acc))

    while len(evaluated) < budget:
        xs = np.stack([_normalize(tuple(_pt_of(h[0])), space)
                       for h in history])
        ys = np.array([penalized(h) for h in history])
        ys_n = (ys - ys.mean()) / (ys.std() + 1e-9)
        gp = _GP(ls=0.35)
        gp.fit(xs, ys_n)
        pool = [pt for pt in cands if pt not in evaluated]
        if not pool:
            break
        pool_x = np.stack([_normalize(pt, space) for pt in pool])
        mu, sd = gp.predict(pool_x)
        ei = _ei(mu, sd, ys_n.min())
        # epsilon-greedy exploration on top of EI
        pick = pool[int(np.argmax(ei))] if rng.random() > 0.15 else \
            pool[int(rng.integers(len(pool)))]
        evaluate(pick)
        evaluated.add(pick)

    return _finish(history)


# ---------------------------------------------------------------------------
# Perf-model dominance pruning (used by core.autotune before any candidate
# touches a real engine): a candidate is dominated when another one is
# modeled no slower AND is no worse on every quality coordinate, with at
# least one strict improvement.  Quality keys are compared componentwise
# (a *partial* order — e.g. (m, nprobe, dtype_rank) under the monotone
# recall surrogate), so incomparable candidates always both survive.
# ---------------------------------------------------------------------------

def dominates(time_a: float, qual_a: Sequence[float],
              time_b: float, qual_b: Sequence[float]) -> bool:
    """True when (time_a, qual_a) dominates (time_b, qual_b): no slower,
    componentwise no worse quality, strictly better somewhere."""
    if len(qual_a) != len(qual_b):
        raise ValueError(f"quality keys must have equal arity, got "
                         f"{len(qual_a)} vs {len(qual_b)}")
    if time_a > time_b:
        return False
    if any(a < b for a, b in zip(qual_a, qual_b)):
        return False
    return time_a < time_b or any(a > b for a, b in zip(qual_a, qual_b))


def prune_dominated(cands: Sequence, time_fn: Callable,
                    quality_fn: Callable) -> tuple[list, list]:
    """Split ``cands`` into (survivors, pruned) under :func:`dominates`.

    ``time_fn(c)`` is the modeled cost (lower better); ``quality_fn(c)``
    a tuple compared componentwise (higher better).  Exact ties (equal
    time and equal quality key) dominate nothing, so duplicates all
    survive — pruning may only remove a candidate some survivor strictly
    beats.  Dominance is transitive, so every pruned candidate is
    dominated by at least one *survivor* (pinned in tests/test_dse.py).
    Input order is preserved in both lists.
    """
    scored = [(time_fn(c), tuple(quality_fn(c)), c) for c in cands]
    survivors, pruned = [], []
    for i, (t_i, q_i, c_i) in enumerate(scored):
        dead = any(dominates(t_j, q_j, t_i, q_i)
                   for j, (t_j, q_j, _) in enumerate(scored) if j != i)
        (pruned if dead else survivors).append(c_i)
    return survivors, pruned


def _pt_of(d: Dict) -> tuple:
    return (d["k"], d["p"], d["nlist"], d["m"], d["cb"])


def _finish(history) -> DSEResult:
    feas = [h for h in history if h[3]]
    pool = feas if feas else history
    best = min(pool, key=lambda h: h[1])
    return DSEResult(best={"params": best[0], "time_s": best[1],
                           "accuracy": best[2], "feasible": best[3]},
                     history=history, evals=len(history))
