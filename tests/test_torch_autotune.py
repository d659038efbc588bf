"""Port parity for the tuning layer: ``core/dse.py`` (the BO design-space
exploration, dominance and pruning) and ``core/autotune.py`` (pricing,
the pruned shortlist, the emitted specs, measured validation and the
tuner end to end).

Pricing, pruning, the DSE history and the emitted spec dicts must equal
the reference's exactly.  The tuner itself is held on one shared index:
both packages tune over the same reference-built index per ``m``
(carried across by ``convert.py``), with a fake host clock in each
serving module so the PIM-paced latencies are the modeled ones and
compare exactly; recall is compared up to k-th-place ties.  The port's
own tuner (its own builds) must meet the SLO on the CLI's smoke corpus.
Everything runs on the CPU.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro.core import autotune as ref_at
from repro.core import dse as ref_dse
from repro.core.perf_model import IndexParams as RefIndexParams
from repro.runtime import serving as ref_serving
from repro.service.spec import IndexSpec as RefIndexSpec

from repro_torch.convert import index_from_numpy
from repro_torch.core import autotune as at
from repro_torch.core import dse
from repro_torch.core import pad_clusters, search_ivfpq, SearchParams
from repro_torch.core.mutable_index import Index
from repro_torch.core.perf_model import IndexParams
from repro_torch.data import make_clustered_corpus
from repro_torch.runtime import serving as serving_mod
from repro_torch.service import (SLO, AutotuneResult, IndexSpec,
                                 ServiceSpec, SLOInfeasible, TuneSpace,
                                 autotune, autotune_service)
from repro_torch.service import __main__ as cli

torch.set_num_threads(1)

# the chip smoke's autotune phase (chip_smoke.py, phase U): its space and
# the pricing arguments the tuner passes at N = 1M, D = 128, nlist 4,096
SMOKE_SPACE = dict(m=(16, 32, 64), nprobe=(8, 32, 96),
                   lut_dtype=("uint8", "f32"),
                   buckets=((1, 2, 4, 8, 16, 32),), tasks_per_shard=(1024,),
                   cache_capacity_bytes=(0, 1 << 24))
SMOKE_PRICING = dict(n_total=1_000_000, nlist=4096, d=128, k=10, ranks=4,
                     qps=2000.0, max_wait_s=2e-3, cb=256)
#: what the smoke checks phase U against: (modeled, survivors, pruned)
SMOKE_SHORTLIST = (36, 18, 18)

# the CLI's smoke (service/__main__.py::autotune_smoke)
CLI_SPACE = dict(m=(4, 8), nprobe=(2, 4, 8), lut_dtype=("uint8", "f32"),
                 buckets=((1, 2, 4, 8),), tasks_per_shard=(1024,),
                 cache_capacity_bytes=(0, 1 << 19))
CLI_PRICING = dict(n_total=3000, nlist=16, d=16, k=10, ranks=4,
                   qps=4000.0, max_wait_s=2e-3, cb=256)

CASES = {
    "default": ({}, CLI_PRICING, {}),
    "cli": (CLI_SPACE, CLI_PRICING, {}),
    "smoke": (SMOKE_SPACE, SMOKE_PRICING, {}),
    "tiered": ({}, dict(CLI_PRICING, n_total=2_000_000, nlist=8192),
               dict(cold_fraction=0.75)),
}


def _spaces(kw):
    return ref_at.TuneSpace(**kw), TuneSpace(**kw)


def _fields(c):
    return dataclasses.astuple(c)


@pytest.mark.parametrize("case", list(CASES))
def test_predicted_latency_equals_reference(case):
    space_kw, pricing, extra = CASES[case]
    ref_space, space = _spaces(space_kw)
    ref_c, port_c = list(ref_space.grid()), list(space.grid())
    assert [_fields(c) for c in port_c] == [_fields(c) for c in ref_c]
    for rc, pc in zip(ref_c, port_c):
        assert at._model_hit_rate(pc, pricing["nlist"]) == \
            ref_at._model_hit_rate(rc, pricing["nlist"])
        assert at.predicted_latency_ms(pc, **pricing, **extra) == \
            ref_at.predicted_latency_ms(rc, **pricing, **extra)


@pytest.mark.parametrize("case", list(CASES))
def test_shortlist_equals_reference(case):
    space_kw, pricing, extra = CASES[case]
    ref_space, space = _spaces(space_kw)
    rs, rn, rms = ref_at._shortlist(
        ref_space, lambda c: ref_at.predicted_latency_ms(c, **pricing,
                                                         **extra))
    ps, pn, pms = at._shortlist(
        space, lambda c: at.predicted_latency_ms(c, **pricing, **extra))
    assert [_fields(c) for c in ps] == [_fields(c) for c in rs]
    assert (pn, pms) == (rn, rms)
    assert pms == sorted(pms) and len(ps) + pn == space.size()
    if case == "smoke":
        assert (space.size(), len(ps), pn) == SMOKE_SHORTLIST


@pytest.mark.parametrize("engine", ["local", "sharded"])
def test_candidate_spec_equals_reference(engine):
    ref_space, space = _spaces(dict(CLI_SPACE, buckets=((1, 2, 4, 8),
                                                        (1, 2, 4, 8, 16,
                                                         32))))
    kw = dict(nlist=64, cb=256, kmeans_iters=6, pq_iters=5, engine=engine,
              n_shards=4, replicas=2, router="least_queue", ranks=8,
              max_wait_s=1e-3, k=10, seed=3)
    for rc, pc in zip(ref_space.grid(), space.grid()):
        got = at.candidate_spec(pc, **kw)
        assert isinstance(got, ServiceSpec)
        assert got.to_dict() == ref_at.candidate_spec(rc, **kw).to_dict()


def test_candidate_labels_and_quality_keys_equal_reference():
    ref_space, space = _spaces(SMOKE_SPACE)
    for rc, pc in zip(ref_space.grid(), space.grid()):
        assert pc.label() == rc.label()
        assert pc.quality_key() == rc.quality_key()


# ---------------------------------------------------------------------------
# DSE
# ---------------------------------------------------------------------------

def _accuracy(ix) -> float:
    """Monotone surrogate recall surface (the reference's
    tests/test_dse.py::synthetic_accuracy)."""
    coverage = 1.0 - math.exp(-3.0 * ix.p * ix.c / ix.n_total * 50)
    resolution = 1.0 - math.exp(-0.12 * ix.m * math.log2(ix.cb))
    return coverage * resolution


DSE_CASES = {
    "bo": (dict(k=(10,), nprobe=(8, 16, 32, 64, 96, 128),
                nlist=(1024, 4096, 16384), m=(8, 16, 32), cb=(256,)),
           dict(accuracy_constraint=0.8, budget=20, seed=0)),
    "bo_seed": (dict(k=(10,), nprobe=(8, 16, 32, 64, 96, 128),
                     nlist=(1024, 4096, 16384), m=(8, 16, 32), cb=(256,)),
                dict(accuracy_constraint=0.9, budget=16, seed=5,
                     multiplierless=False)),
    "exhaustive": (dict(k=(10,), nprobe=(8, 32), nlist=(1024, 4096),
                        m=(8, 16), cb=(256,)),
                   dict(accuracy_constraint=0.0, budget=4, seed=0)),
    "infeasible": (dict(k=(10,), nprobe=(8, 16), nlist=(4096,), m=(8,),
                        cb=(16, 256)),
                   dict(accuracy_constraint=1.5, budget=8, seed=1)),
}


@pytest.mark.parametrize("case", list(DSE_CASES))
def test_run_dse_equals_reference(case):
    space_kw, kw = DSE_CASES[case]
    base = dict(n_total=10_000_000, nlist=4096, q=4096, d=128, k=10, p=32,
                m=16, cb=256)
    ref = ref_dse.run_dse(RefIndexParams(**base), _accuracy,
                          space=ref_dse.DSESpace(**space_kw), **kw)
    port = dse.run_dse(IndexParams(**base), _accuracy,
                       space=dse.DSESpace(**space_kw), **kw)
    assert port.best == ref.best
    assert port.history == ref.history
    assert port.evals == ref.evals


def test_dominates_and_prune_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ta, tb = (float(x) for x in rng.integers(0, 4, 2))
        qa = tuple(int(x) for x in rng.integers(0, 3, 3))
        qb = tuple(int(x) for x in rng.integers(0, 3, 3))
        assert dse.dominates(ta, qa, tb, qb) == \
            ref_dse.dominates(ta, qa, tb, qb)
    with pytest.raises(ValueError) as e1:
        ref_dse.dominates(1.0, (1,), 1.0, (1, 2))
    with pytest.raises(ValueError) as e2:
        dse.dominates(1.0, (1,), 1.0, (1, 2))
    assert str(e2.value) == str(e1.value)
    cands = [(float(t), tuple(int(x) for x in q)) for t, q in
             zip(rng.integers(0, 6, 60), rng.integers(0, 4, (60, 2)))]
    got = dse.prune_dominated(cands, lambda c: c[0], lambda c: c[1])
    want = ref_dse.prune_dominated(cands, lambda c: c[0], lambda c: c[1])
    assert got == want and got[1]


VALIDATION = [
    (lambda m: m.SLO(recall_at_k=0.0).validate()),
    (lambda m: m.SLO(recall_at_k=1.5).validate()),
    (lambda m: m.SLO(p99_ms=0.0).validate()),
    (lambda m: m.SLO(k=0).validate()),
    (lambda m: m.TuneSpace(m=()).validate()),
    (lambda m: m.TuneSpace(lut_dtype=("f16", "f32")).validate()),
]


@pytest.mark.parametrize("i", range(len(VALIDATION)))
def test_validation_errors_equal_reference(i):
    with pytest.raises(ValueError) as e1:
        VALIDATION[i](ref_at)
    with pytest.raises(ValueError) as e2:
        VALIDATION[i](at)
    assert str(e2.value) == str(e1.value)


def test_slo_semantics_equal_reference():
    for kw in ({}, dict(recall_at_k=0.9, p99_ms=20.0, k=5)):
        a, b = ref_at.SLO(**kw), SLO(**kw)
        assert str(b) == str(a)
        for r, p in ((0.85, 10.0), (0.95, 30.0), (0.5, 1.0)):
            assert b.met_by(r, p) == a.met_by(r, p)


# ---------------------------------------------------------------------------
# The tuner on one shared index
# ---------------------------------------------------------------------------

SEED = 0
NLIST = 16
N_CALIB = 32


@functools.lru_cache(maxsize=1)
def _corpus():
    ds = make_clustered_corpus(SEED, 3000, 16, n_queries=48,
                               n_components=12, k_gt=10, device="cpu")
    return (ds.points.numpy(), ds.queries.float().numpy(),
            ds.groundtruth.numpy())


@functools.lru_cache(maxsize=1)
def _ref_handles():
    """One reference-built index per m, and its port twin."""
    points, _, _ = _corpus()
    out = {}
    for m in (4, 8):
        h = RefIndexSpec(nlist=NLIST, m=m, cb=256, kmeans_iters=8,
                         pq_iters=8, seed=SEED).build(points)
        ivf = h.ivf
        port = Index(index_from_numpy(ivf.centroids, ivf.codebook.codebooks,
                                      ivf.codebook.sqnorms, ivf.codes,
                                      ivf.ids, ivf.offsets, device="cpu"))
        out[m] = (h, port)
    return out


class _FakeTime:
    """A host clock that moves only when slept: the PIM-paced engine then
    charges exactly its modeled time."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    monotonic = perf_counter

    def sleep(self, s):
        self.t += max(float(s), 0.0)


@pytest.fixture
def shared_index(monkeypatch):
    handles = _ref_handles()
    monkeypatch.setattr(RefIndexSpec, "build",
                        lambda self, points, **kw: handles[self.m][0])
    monkeypatch.setattr(IndexSpec, "build",
                        lambda self, points, **kw: handles[self.m][1])
    monkeypatch.setattr(ref_serving, "time", _FakeTime())
    monkeypatch.setattr(serving_mod, "time", _FakeTime())
    return handles


def _both(slo, validate_budget=6, space_kw=CLI_SPACE):
    points, queries, gt = _corpus()
    kw = dict(queries=queries[:N_CALIB], groundtruth=gt[:N_CALIB],
              nlist=NLIST, calibration_requests=48,
              validate_budget=validate_budget, seed=SEED)
    out = []
    for mod, space in ((ref_at, ref_at.TuneSpace(**space_kw)),
                       (at, TuneSpace(**space_kw))):
        extra = {} if mod is ref_at else dict(device="cpu")
        try:
            out.append(mod.autotune(points, slo, space=space, **kw,
                                    **extra))
        except (ref_at.SLOInfeasible, SLOInfeasible) as e:
            out.append(e)
    return out


def _assert_shortlist_is_reference(port):
    """``modeled``, ``pruned`` and ``survivors`` on a result or an
    SLOInfeasible are the reference's shortlist for the CLI's space."""
    space = ref_at.TuneSpace(**CLI_SPACE)
    rs, rn, _ = ref_at._shortlist(
        space, lambda c: ref_at.predicted_latency_ms(c, **CLI_PRICING))
    assert (port.modeled, port.pruned) == (space.size(), rn)
    assert [_fields(c) for c in port.survivors] == [_fields(c) for c in rs]
    assert set(port.indexes) == set(port.build_s)


def _assert_frontiers_equal(port, ref):
    assert len(port) == len(ref)
    tie = 1.0 / (N_CALIB * 10)          # one k-th-place tie
    for p, r in zip(port, ref):
        assert {k: v for k, v in p.items() if k != "recall"} == \
            {k: v for k, v in r.items() if k != "recall"}
        assert abs(p["recall"] - r["recall"]) <= tie + 1e-12


def test_autotune_on_a_shared_index_equals_reference(shared_index):
    ref, port = _both(SLO(recall_at_k=0.8, p99_ms=50.0))
    assert isinstance(ref, ref_at.AutotuneResult)
    assert isinstance(port, AutotuneResult)
    _assert_frontiers_equal(port.frontier, ref.frontier)
    assert port.spec.to_dict() == ref.spec.to_dict()
    assert {k: v for k, v in port.measured.items() if k != "recall"} == \
        {k: v for k, v in ref.measured.items() if k != "recall"}
    assert (port.modeled, port.pruned, port.validated, port.seed) == \
        (ref.modeled, ref.pruned, ref.validated, ref.seed)
    assert port.report().splitlines()[:3] == ref.report().splitlines()[:3]
    assert port.index is shared_index[port.spec.index.m][1]
    _assert_shortlist_is_reference(port)
    assert port.indexes[port.spec.index.m] is port.index


def test_infeasible_on_a_shared_index_equals_reference(shared_index):
    ref, port = _both(SLO(recall_at_k=0.999, p99_ms=0.5),
                      validate_budget=4)
    assert isinstance(ref, ref_at.SLOInfeasible)
    assert isinstance(port, SLOInfeasible)
    assert len(port.frontier) == 4
    assert not any(e["meets_slo"] for e in port.frontier)
    _assert_frontiers_equal(port.frontier, ref.frontier)
    assert str(port).split("; closest")[0] == str(ref).split("; closest")[0]
    _assert_shortlist_is_reference(port)
    assert [(e["m"], e["nprobe"], e["lut_dtype"]) for e in port.frontier] \
        == [(c.m, c.nprobe, c.lut_dtype) for c in port.survivors[:4]]


def test_measure_spec_equals_reference_on_a_shared_index(shared_index):
    _, queries, gt = _corpus()
    rh, ph = shared_index[8]
    for lut in ("uint8", "f32"):
        cand_kw = dict(m=8, nprobe=4, lut_dtype=lut, buckets=(1, 2, 4, 8),
                       tasks_per_shard=1024, cache_capacity_bytes=1 << 19)
        kw = dict(k=10, n_requests=40, qps=4000.0, skew=1.2, seed=1)
        r = ref_at.measure_spec(
            ref_at.candidate_spec(ref_at.Candidate(**cand_kw), nlist=NLIST),
            rh, queries, gt, **kw)
        p = at.measure_spec(
            at.candidate_spec(at.Candidate(**cand_kw), nlist=NLIST),
            ph, queries, gt, **kw)
        assert {k: v for k, v in p.items() if k != "recall"} == \
            {k: v for k, v in r.items() if k != "recall"}
        assert abs(p["recall"] - r["recall"]) <= 1.0 / (len(queries) * 10)


# ---------------------------------------------------------------------------
# The port's own tuner
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _tuned():
    points, queries, gt = _corpus()
    return autotune(points, SLO(recall_at_k=0.8, p99_ms=50.0),
                    queries=queries, groundtruth=gt,
                    space=TuneSpace(**CLI_SPACE), nlist=NLIST,
                    calibration_requests=48, validate_budget=6, seed=SEED,
                    device="cpu")


def test_port_autotune_meets_the_slo(tmp_path):
    res = _tuned()
    assert res.measured["recall"] >= 0.8 and res.measured["p99_ms"] <= 50.0
    assert res.frontier[-1]["meets_slo"]
    assert not any(e["meets_slo"] for e in res.frontier[:-1])
    pms = [e["predicted_ms"] for e in res.frontier]
    assert pms == sorted(pms)
    assert res.spec.validate() is res.spec
    assert ServiceSpec.load(res.spec.save(tmp_path / "d.json")) == res.spec
    assert set(res.build_s) <= {4, 8} and res.spec.index.m in res.build_s
    assert res.modeled == TuneSpace(**CLI_SPACE).size()


def test_autotune_service_serves_the_tuned_index():
    points, queries, gt = _corpus()
    svc, res = autotune_service(points, SLO(recall_at_k=0.8, p99_ms=50.0),
                                queries=queries, groundtruth=gt,
                                space=TuneSpace(**CLI_SPACE), nlist=NLIST,
                                calibration_requests=48, validate_budget=6,
                                seed=SEED, device="cpu")
    d, i = svc.search(queries)
    ivf = res.index.ivf
    wd, wi = search_ivfpq(ivf, pad_clusters(ivf), torch.from_numpy(queries),
                          SearchParams(nprobe=res.spec.nprobe, k=10,
                                       lut_dtype=res.spec.lut_dtype))
    np.testing.assert_array_equal(d, wd.numpy())
    np.testing.assert_array_equal(i, wi.numpy())
    svc.shutdown()


def test_port_autotune_infeasible_carries_the_frontier():
    points, queries, gt = _corpus()
    with pytest.raises(SLOInfeasible) as ei:
        autotune(points, SLO(recall_at_k=0.999, p99_ms=0.5),
                 queries=queries[:16], groundtruth=gt[:16],
                 space=TuneSpace(**CLI_SPACE), nlist=NLIST,
                 calibration_requests=24, validate_budget=3, seed=SEED,
                 device="cpu")
    e = ei.value
    assert len(e.frontier) == 3 and not any(x["meets_slo"]
                                            for x in e.frontier)
    assert "closest: recall@10=" in str(e) and e.build_s
    assert set(e.indexes) == set(e.build_s) and e.survivors
    assert e.slo.recall_at_k == 0.999


def test_autotune_self_queries_and_validation():
    """Without queries the tuner samples the corpus and builds its own
    oracle on the device; argument errors match the reference's."""
    points, _, gt = _corpus()
    res = autotune(torch.from_numpy(points), SLO(recall_at_k=0.5),
                   space=TuneSpace(**dict(CLI_SPACE, m=(8,), nprobe=(8,))),
                   nlist=NLIST, calibration_requests=16, validate_budget=2,
                   seed=SEED, device="cpu")
    assert res.measured["recall"] >= 0.5
    for kw in (dict(validate_budget=0),
               dict(queries=np.zeros((4, 16), np.float32),
                    groundtruth=gt[:4, :5])):
        with pytest.raises(ValueError) as e1:
            ref_at.autotune(points, ref_at.SLO(), **kw)
        with pytest.raises(ValueError) as e2:
            autotune(points, SLO(), device="cpu", **kw)
        assert str(e2.value) == str(e1.value)


def test_cli_autotune_saves_a_spec(tmp_path, capsys):
    path = tmp_path / "deploy.json"
    assert cli.main(["--autotune", "--device", "cpu", "--save-spec",
                     str(path)]) == 0
    out = capsys.readouterr().out
    assert "[autotune] winner:" in out and "spec saved" in out
    spec = ServiceSpec.load(path)
    assert spec.pim_paced_ranks == 4 and spec.index.nlist == NLIST
    assert cli.main(["--autotune", "--device", "cpu", "--slo-recall",
                     "0.999", "--slo-p99-ms", "0.01"]) == 1
    assert "INFEASIBLE" in capsys.readouterr().out
