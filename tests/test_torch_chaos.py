"""Port parity for the fail-operational layer: ``runtime/faults.py`` (rule
validation, seeded decision sequences, stats), the chaos sites of the
tier (``tier.spill_corrupt``, ``tier.cold_read``), of ``ServingRuntime``
(``engine.straggler``, ``engine.batch``) and of the mutation
coordinator (``maintenance.death``), ``AnnService(fault_injector=)`` and
the chaos harness (``service/chaos.py``).

Both packages run the same plan over the same inputs: one reference-built
index carried across by ``convert.py``, the same probe streams and
arrival traces.  Faults, counters and schedules must be exactly equal;
the harness is held to the reference's floors.  Everything runs on the
CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster_locate as ref_locate
from repro.runtime import ServingConfig as RefConfig
from repro.runtime import ServingRuntime as RefRuntime
from repro.runtime.faults import FaultInjector as RefInjector
from repro.runtime.faults import FaultPlan as RefPlan
from repro.runtime.faults import FaultRule as RefRule
from repro.runtime.serving import BatchServeError as RefBatchServeError
from repro.service import chaos as ref_chaos
from repro.storage import TieredStore as RefTier

from repro_torch.convert import index_from_numpy
from repro_torch.core import pad_clusters
from repro_torch.runtime import (SITES, BatchServeError, FaultInjector,
                                 FaultPlan, FaultRule, InjectedFault,
                                 ServingConfig, ServingRuntime)
from repro_torch.runtime.faults import arm
from repro_torch.service import (AnnService, ServiceOverloaded,
                                 ServiceSpec, chaos)
from repro_torch.storage import InjectedIOError, TieredStore

torch.set_num_threads(1)
K, NPROBE = 10, 8

pytestmark = pytest.mark.filterwarnings(
    r"ignore:Direct \w+\(\.\.\.\) construction:DeprecationWarning")


@pytest.fixture(scope="module")
def port_index(small_index):
    return index_from_numpy(small_index.centroids,
                            small_index.codebook.codebooks,
                            small_index.codebook.sqnorms, small_index.codes,
                            small_index.ids, small_index.offsets,
                            device="cpu")


@pytest.fixture(scope="module")
def queries(small_corpus):
    return np.array(small_corpus.queries, np.float32)


@pytest.fixture(scope="module")
def bpc(small_clusters):
    _, cap, m = small_clusters.codes.shape
    return cap * (m + 4)


def _plans(rules):
    """The same plan in both packages."""
    return (RefPlan(seed=rules[0], rules=tuple(RefRule(**r)
                                               for r in rules[1])),
            FaultPlan(seed=rules[0], rules=tuple(FaultRule(**r)
                                                 for r in rules[1])))


def _host(out):
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in out]


# ---------------------------------------------------------------------------
# FaultRule, FaultPlan, FaultInjector
# ---------------------------------------------------------------------------

BAD_RULES = [
    dict(site="engine.btach"),
    dict(site="engine.batch", rate=1.5),
    dict(site="engine.batch", rate=-0.1),
    dict(site="engine.batch", count=-1),
    dict(site="engine.batch", after=-2),
    dict(site="engine.straggler", delay_s=-0.1),
]


@pytest.mark.parametrize("kw", BAD_RULES, ids=[str(i) for i in
                                                range(len(BAD_RULES))])
def test_fault_rule_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        RefRule(**kw)
    with pytest.raises(ValueError) as port_err:
        FaultRule(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_sites_and_describe_match_reference():
    from repro.runtime.faults import SITES as REF_SITES
    assert SITES == REF_SITES
    for site in SITES:                   # every named site constructs
        FaultRule(site)
    ref_plan, plan = _plans((3, [dict(site="engine.batch", rate=0.5,
                                      count=4, after=1),
                                 dict(site="tier.cold_read")]))
    assert plan.describe() == ref_plan.describe()
    assert isinstance(plan.rules, tuple)
    err = InjectedFault("engine.batch", "replica 1")
    assert str(err) == "injected fault at engine.batch: replica 1"
    assert err.site == "engine.batch" and isinstance(err, RuntimeError)


PLANS = {
    "rate": (7, [dict(site="engine.batch", rate=0.3)]),
    "after_count": (0, [dict(site="engine.batch", rate=1.0, count=2,
                             after=3, replicas=(1,))]),
    "two_rules_one_site": (11, [dict(site="engine.straggler", rate=0.2,
                                     delay_s=1e-3),
                                dict(site="engine.straggler", rate=0.5,
                                     count=5, replicas=(0, 2))]),
    "default_plan": (5, [dict(site="engine.batch", rate=0.02),
                         dict(site="tier.cold_read", rate=0.05),
                         dict(site="engine.straggler", rate=0.05,
                              delay_s=5e-3),
                         dict(site="tier.spill_corrupt", count=1,
                              after=4)]),
    "rate_zero_and_one": (1, [dict(site="tier.cold_read", rate=0.0),
                              dict(site="maintenance.death", rate=1.0,
                                   count=3)]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_injector_decisions_match_reference(name):
    """One consultation sequence over every site (and the replica filter)
    gives the same firings, the same rules and the same ledger."""
    ref_plan, plan = _plans(PLANS[name])
    ref, port = RefInjector(ref_plan), FaultInjector(plan)
    rng = np.random.default_rng(42)
    for _ in range(600):
        site = SITES[int(rng.integers(len(SITES)))]
        replica = [None, 0, 1, 2][int(rng.integers(4))]
        a = ref.fire(site, replica=replica)
        b = port.fire(site, replica=replica)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclass_tuple(b) == dataclass_tuple(a)
    assert port.stats() == ref.stats()
    assert port.stats()                          # the plan was consulted


def dataclass_tuple(rule):
    return (rule.site, rule.rate, rule.count, rule.after, rule.replicas,
            rule.delay_s, rule.cluster)


def test_default_plan_and_zipf_stream_match_reference():
    for seed in (0, 3):
        assert (chaos.default_plan(seed).describe()
                == ref_chaos.default_plan(seed).describe())
        np.testing.assert_array_equal(chaos.zipf_stream(500, 64, seed),
                                      ref_chaos.zipf_stream(500, 64, seed))
    assert [dataclass_tuple(r) for r in chaos.default_plan(1).rules] == \
        [dataclass_tuple(r) for r in ref_chaos.default_plan(1).rules]


def test_arm_and_injected():
    class Slot:
        faults = None
    s = Slot()
    inj = FaultInjector(FaultPlan(seed=0))
    arm(s, inj)
    assert s.faults is inj
    assert inj.fire("engine.batch") is None and inj.stats() == {}
    err = InjectedFault("engine.batch")
    assert chaos.injected(err)
    wrapped = RuntimeError("outer")
    wrapped.__cause__ = InjectedIOError("tier.cold_read")
    assert chaos.injected(wrapped)
    assert isinstance(wrapped.__cause__, IOError)
    assert str(wrapped.__cause__) == "injected fault at tier.cold_read"
    # the type decides, not the message
    assert not chaos.injected(IOError("injected fault at tier.cold_read"))
    assert not chaos.injected(IOError("disk full"))
    assert not chaos.injected(RuntimeError("CUDA error: launch failure"))


# ---------------------------------------------------------------------------
# The tier's sites, against the reference
# ---------------------------------------------------------------------------

def _probes(small_index, queries, nprobe):
    p, _ = ref_locate(jnp.asarray(queries), small_index.centroids, nprobe)
    return np.asarray(p)


@pytest.mark.parametrize("seed", [0, 4])
def test_tier_faults_match_reference(small_index, port_index, queries, bpc,
                                     tmp_path, seed):
    """Same plan, same probe stream (observe between batches so residency
    churns): the same cluster rotted, the same dropped masks and bytes,
    the same TierStats batch for batch, the same verify report, and the
    same spill bytes after the repair."""
    ref_plan, plan = _plans((seed, [
        dict(site="tier.cold_read", rate=0.3),
        dict(site="tier.spill_corrupt", count=1, after=2)]))
    ref = RefTier.from_index(small_index, tmp_path / "r",
                             budget_bytes=bpc * 13)
    port = TieredStore.from_index(port_index, tmp_path / "p",
                                  budget_bytes=bpc * 13, device="cpu")
    ref.faults, port.faults = RefInjector(ref_plan), FaultInjector(plan)
    probes = _probes(small_index, queries, 4)
    ranks = np.random.default_rng(seed).zipf(1.3, size=512)
    n_dropped = 0
    for batch in np.array_split(ranks.clip(1, len(queries)) - 1, 16):
        p = probes[batch]
        ref.observe(p)
        port.observe(p)
        rc = ref.gather_degraded(p.reshape(-1))
        pc = _host(port.gather_degraded(p.reshape(-1)))
        for a, b in zip(pc, rc):
            np.testing.assert_array_equal(a, np.asarray(b))
        n_dropped += int(pc[3].sum())
        assert port.stats.as_dict() == ref.stats.as_dict()
        np.testing.assert_array_equal(port.resident_mask, ref.resident_mask)
    assert n_dropped > 0 and port.stats.degraded_gathers > 0
    assert port.faults.stats() == ref.faults.stats()
    assert port.faults.stats()["tier.spill_corrupt"]["fires"] == 1
    (c,) = port.fault_corrupted
    for name in ("codes.u8", "ids.i32"):
        assert ((tmp_path / "r" / name).read_bytes()
                == (tmp_path / "p" / name).read_bytes()), name
    assert port.verify(repair=True) == ref.verify(repair=True)
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.rebuilds > 0                 # the rotten one healed
    assert sorted(port.quarantined) == sorted(ref.quarantined) == []
    for name in ("codes.u8", "ids.i32"):
        assert ((tmp_path / "r" / name).read_bytes()
                == (tmp_path / "p" / name).read_bytes()), name
    assert 0 <= c < port.nlist


def test_pinned_spill_corrupt_cluster_and_strict_cold_read(
        small_index, port_index, bpc, tmp_path):
    """A rule with ``cluster`` rots that cluster; a strict gather under a
    cold-read firing raises IOError in both packages, and the dropped
    rows of a degraded one are zero codes, ids -1 and size 0."""
    ref_plan, plan = _plans((0, [
        dict(site="tier.spill_corrupt", count=1, cluster=5),
        dict(site="tier.cold_read", rate=1.0, count=2)]))
    ref = RefTier.from_index(small_index, tmp_path / "r", budget_bytes=bpc)
    port = TieredStore.from_index(port_index, tmp_path / "p",
                                  budget_bytes=bpc, device="cpu")
    ref.faults, port.faults = RefInjector(ref_plan), FaultInjector(plan)
    cold = int(np.nonzero(~port.resident_mask)[0][0])
    with pytest.raises(IOError, match="tier.cold_read"):
        ref.gather([cold])
    with pytest.raises(InjectedIOError, match="tier.cold_read"):
        port.gather([cold])
    assert port.fault_corrupted == [5]
    codes, ids, sizes, dropped = port.gather_degraded([cold, cold])
    assert dropped.all() and int(sizes.sum()) == 0
    assert int(codes.abs().sum()) == 0 and bool((ids == -1).all())
    rc = ref.gather_degraded([cold, cold])
    for a, b in zip(_host((codes, ids, sizes, dropped)), rc):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the cold-read rule is spent: the next gather serves the bytes
    got = _host(port.gather([cold]))
    want = pad_clusters(port_index)
    np.testing.assert_array_equal(got[0][0], want.codes[cold].numpy())
    np.testing.assert_array_equal(got[0], np.asarray(ref.gather([cold])[0]))
    assert port.stats.as_dict() == ref.stats.as_dict()
    rep_p, rep_r = port.verify(repair=True), ref.verify(repair=True)
    assert rep_p == rep_r and 5 in rep_p["corrupt"]


# ---------------------------------------------------------------------------
# ServingRuntime's sites on the virtual clock, against the reference
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in engine: records each batch's budget and answers zeros."""

    def __init__(self):
        self.seen = []

    def search_batch(self, queries, n_valid=None, **kw):
        self.seen.append(kw.get("budget_s"))
        b = queries.shape[0]
        return (np.zeros((b, 1), np.float32), np.zeros((b, 1), np.int64))


def _drive(rt, err_type, trace):
    """Submit + step every arrival on the virtual clock; returns the
    request ids of each failed batch and the served request ids."""
    failed, served = [], []
    for t, q in trace:
        rt.submit(q, now=t)
        try:
            served += [r.req_id for r in rt.step(now=t + 2e-3)]
        except err_type as e:
            failed.append([r.req_id for r in e.batch.requests])
    while rt.batcher.depth:
        try:
            served += [r.req_id for r in rt.step(now=1e9, drain=True)]
        except err_type as e:
            failed.append([r.req_id for r in e.batch.requests])
    return failed, served


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runtime_sites_match_reference(seed):
    """One trace, one plan: the same batches fail with engine.batch, and
    every budget is charged the straggler's sleep, as the reference's
    tests/test_chaos.py::test_straggler_sleep_charged_to_deadline_budget
    holds."""
    ref_plan, plan = _plans((seed, [
        dict(site="engine.batch", rate=0.25),
        dict(site="engine.straggler", rate=0.3, delay_s=2e-3)]))
    trace = [(i * 1e-3, np.zeros(4, np.float32)) for i in range(40)]
    out = {}
    for name, rt_cls, cfg_cls, inj, err in (
            ("ref", RefRuntime, RefConfig, RefInjector(ref_plan),
             RefBatchServeError),
            ("port", ServingRuntime, ServingConfig, FaultInjector(plan),
             BatchServeError)):
        eng = _Recorder()
        rt = rt_cls(eng, cfg_cls(buckets=(1, 2, 4), max_wait_s=1e-3,
                                 deadline_s=0.05))
        rt.replica_idx = 0
        rt.faults = inj
        failed, served = _drive(rt, err, trace)
        out[name] = (failed, served, eng.seen, inj.stats())
    assert out["port"][0] == out["ref"][0] and out["port"][0]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]        # budgets, float for float
    assert out["port"][3] == out["ref"][3]
    fires = out["port"][3]["engine.straggler"]["fires"]
    assert fires > 0


def test_straggler_sleep_charged_to_deadline_budget():
    eng = _Recorder()
    delay = 0.05
    rt = ServingRuntime(eng, ServingConfig(buckets=(1,), max_wait_s=1e-3,
                                           deadline_s=0.2))
    rt.faults = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("engine.straggler", delay_s=delay),)))
    rt.submit(np.zeros(4, np.float32), now=0.0)
    rt.step(now=0.0, drain=True)
    assert eng.seen == [pytest.approx(0.2 - delay)]


def test_engine_batch_raises_before_the_engine_runs(port_index, queries):
    """A firing raises BatchServeError wrapping the InjectedFault, and the
    engine never saw the batch (nothing of it was launched)."""
    eng = _Recorder()
    rt = ServingRuntime(eng, ServingConfig(buckets=(2,), max_wait_s=1e-3))
    rt.replica_idx = 3
    rt.faults = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("engine.batch", count=1),)))
    rt.submit(queries[0], now=0.0)
    with pytest.raises(BatchServeError) as ei:
        rt.step(now=1.0, drain=True)
    assert isinstance(ei.value.cause, InjectedFault)
    assert "replica 3" in str(ei.value.cause) and eng.seen == []
    rt.submit(queries[0], now=2.0)
    assert len(rt.step(now=3.0, drain=True)) == 1 and len(eng.seen) == 1


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

def _spec(**kw):
    base = dict(engine="local", nprobe=NPROBE, k=K, buckets=(1, 2, 4),
                max_wait_s=1e-3)
    base.update(kw)
    return ServiceSpec(**base)


def test_disarmed_service_reports_no_faults(port_index, queries):
    svc = AnnService.build(_spec(replicas=1), index=port_index)
    svc.warmup()
    svc.search(queries[:4])
    st = svc.stats()
    assert "faults" not in st and svc.faults is None
    assert st["aggregate"]["degraded"] == 0
    assert all(r.runtime.faults is None for r in svc.replicas)
    svc.shutdown()


def test_armed_service_and_scale_to_arm_every_site(port_index, queries,
                                                   tmp_path):
    inj = FaultInjector(FaultPlan(seed=0, rules=tuple(
        FaultRule(s, rate=0.0) for s in SITES)))
    svc = AnnService.build(
        _spec(replicas=1, replicas_max=3, storage="tiered",
              storage_dir=str(tmp_path), storage_budget_bytes=1 << 16),
        index=port_index, fault_injector=inj)
    assert svc.faults is inj and svc.index.tiered_store.faults is inj
    svc.scale_to(3)
    assert len(svc.replicas) == 3
    assert all(r.runtime.faults is inj for r in svc.replicas)
    svc.warmup()
    futs = [svc.submit_async(queries[i]) for i in range(12)]
    for f in futs:
        f.result(timeout=60.0)
    st = svc.stats()
    assert st["faults"] == inj.stats()
    assert st["faults"]["engine.batch"]["consultations"] > 0
    assert st["faults"]["tier.spill_corrupt"]["fires"] == 0
    svc.shutdown()


def test_injected_batch_failure_fails_over(port_index, queries):
    """engine.batch on replica 0 only: every request is answered by
    replica 1, bit for bit the unarmed service's answer."""
    plain = AnnService.build(_spec(replicas=2), index=port_index)
    want_d, want_i = plain.search(queries[:16])
    plain.shutdown()
    inj = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("engine.batch", replicas=(0,)),
        FaultRule("engine.straggler", rate=0.5, delay_s=1e-3))))
    svc = AnnService.build(_spec(replicas=2, max_retries=2,
                                 backoff_base_ms=0.0, breaker_threshold=100),
                           index=port_index, fault_injector=inj)
    svc.warmup()
    futs = [svc.submit_async(queries[i]) for i in range(16)]
    for i, f in enumerate(futs):
        d, ids = f.result(timeout=60.0)
        np.testing.assert_array_equal(d, want_d[i])
        np.testing.assert_array_equal(ids, want_i[i])
        assert f.timing()["replica"] == 1
    st = svc.stats()
    assert st["faults"]["engine.batch"]["fires"] > 0
    assert st["aggregate"]["retries"] >= st["faults"]["engine.batch"][
        "fires"]
    svc.shutdown()


def test_deadline_degrades_and_flags(port_index, queries, tmp_path):
    """An (effectively) zero deadline over a mostly-cold tier forces
    resident-only scans: requests complete, flagged degraded in
    timing(), and the service counters agree."""
    svc = AnnService.build(_spec(replicas=1, storage="tiered",
                                 storage_dir=str(tmp_path),
                                 storage_budget_bytes=1 << 16,
                                 deadline_ms=1e-3), index=port_index)
    svc.warmup()
    futs = [svc.submit_async(queries[i]) for i in range(8)]
    degraded = 0
    for fut in futs:
        fut.result(timeout=30.0)
        t = fut.timing()
        assert {"degraded", "deadline_missed"} <= set(t)
        degraded += bool(t["degraded"])
    assert degraded > 0
    assert svc.stats()["aggregate"]["degraded"] == degraded
    svc.shutdown()


def test_bounded_queue_sheds_behind_straggler(port_index, queries):
    inj = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("engine.straggler", rate=1.0, delay_s=0.05),)))
    svc = AnnService.build(_spec(replicas=1, queue_bound=2),
                           index=port_index, fault_injector=inj)
    svc.warmup()
    futs, shed = [], 0
    for i in range(24):
        try:
            futs.append(svc.submit_async(queries[i % len(queries)]))
        except ServiceOverloaded:
            shed += 1
    assert shed > 0 and futs
    for fut in futs:
        fut.result(timeout=60.0)
    st = svc.stats()
    assert st["aggregate"]["shed"] == shed
    assert st["faults"]["engine.straggler"]["fires"] > 0
    svc.shutdown()


def test_maintenance_death_surfaces_on_next_call(small_corpus):
    inj = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("maintenance.death", count=1),)))
    svc = AnnService.build(_spec(mutable=True),
                           points=np.asarray(small_corpus.points,
                                             np.float32),
                           device="cpu", fault_injector=inj)
    assert svc.mutator.faults is inj
    svc.warmup()
    pts = np.asarray(small_corpus.points[:4], np.float32)
    with pytest.raises(RuntimeError, match="maintenance failed") as ei:
        svc.run_maintenance(force=True, wait=True)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert ei.value.__cause__.site == "maintenance.death"
    # the fault is spent (count=1): the next cycle succeeds and the
    # mutation API works again
    svc.upsert(np.arange(4) + 10_000, pts)
    assert svc.run_maintenance(force=True, wait=True)["ran"]
    assert svc.stats()["faults"]["maintenance.death"] == {
        "consultations": 2, "fires": 1}
    svc.shutdown()


def test_maintenance_death_surfaces_on_an_async_cycle(small_corpus):
    """A background cycle killed by the site is raised by the next
    mutation call, never swallowed."""
    inj = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("maintenance.death", count=1),)))
    svc = AnnService.build(_spec(mutable=True),
                           points=np.asarray(small_corpus.points,
                                             np.float32),
                           device="cpu", fault_injector=inj)
    out = svc.run_maintenance(force=True, wait=False)
    assert out.get("async")
    svc.mutator._maint_thread.join()
    with pytest.raises(RuntimeError, match="maintenance failed"):
        svc.delete([0])
    assert svc.delete([0]) == 1
    svc.shutdown()


# ---------------------------------------------------------------------------
# The chaos harness
# ---------------------------------------------------------------------------

def test_run_chaos_meets_reference_floors():
    """A reduced run of the canonical experiment on the CPU, as the
    reference's tests/test_chaos.py::test_chaos_e2e_floors runs it."""
    rep = chaos.run_chaos(seed=0, n_queries=120, device="cpu")
    assert rep["availability"] >= 0.95
    assert rep["corrupt_results"] == 0 and rep["errors"] == []
    assert rep["answered"] + rep["failed"] == rep["submitted"] - rep["shed"]
    fs = rep["fault_stats"]
    assert fs["engine.batch"]["fires"] >= 1
    assert fs["tier.spill_corrupt"]["fires"] == 1
    assert rep["rebuilds"] > 0 or rep["verify"]["rebuilt"]
    assert rep["healed_by"] in ("demote", "verify")
    assert len(rep["corrupted"]) == 1
    json.dumps({k: v for k, v in rep.items() if k != "verify"})


def test_selftest_chaos_on_the_cpu(capsys):
    # seed 0's engine.batch rule fires at its 4th and 12th consultation,
    # so the floor holds however the host's load batches the stream
    assert chaos.selftest_chaos(seed=0, n_queries=400, device="cpu") == 0
    out = capsys.readouterr().out
    assert "corrupt_results=0: OK (device=cpu)" in out


def test_chaos_experiment_on_a_shared_index(port_index, queries,
                                            small_corpus, tmp_path):
    """The harness over the conftest index at uint8 with the tier sized
    by the caller: the floors hold and the spills under the given root
    are removed."""
    rep = chaos.chaos_experiment(
        port_index, queries, np.asarray(small_corpus.groundtruth), seed=0,
        n_queries=200, lut_dtype="uint8", budget_bytes=1 << 16,
        spill_root=tmp_path)
    chaos.check_floors(rep)
    assert list(tmp_path.iterdir()) == []
    assert rep["answered"] == rep["submitted"] - rep["failed"] - rep["shed"]
    assert 0.0 < rep["recall_non_degraded"] <= 1.0


def test_chaos_experiment_past_the_budget(port_index, queries,
                                         small_corpus, bpc, tmp_path):
    """Uniform draws over a two-cluster tier at the smoke's promote
    margin: the hot set exceeds the budget, so cold reads fire, the tier
    drops their probes and answers come back degraded; the non-degraded
    ones stay bit-exact."""
    rep = chaos.chaos_experiment(
        port_index, queries, np.asarray(small_corpus.groundtruth), seed=0,
        n_queries=200, budget_bytes=2 * bpc, skew=0.0, promote_margin=1e6,
        spill_root=tmp_path)
    chaos.check_floors(rep, degraded=True)
    assert rep["degraded_gathers"] > 0 and rep["corrupt_results"] == 0


def _good_report():
    return {"availability": 1.0, "corrupt_results": 0, "errors": [],
            "batch_failures": 2, "rebuilds": 1, "quarantined": [],
            "verify": {"corrupt": [], "rebuilt": []},
            "fault_stats": {"engine.batch": {"fires": 2},
                            "tier.spill_corrupt": {"fires": 1}}}


@pytest.mark.parametrize("bad", [
    dict(availability=0.9), dict(corrupt_results=1),
    dict(errors=["RuntimeError('CUDA error')"]), dict(batch_failures=3),
    dict(fault_stats={"engine.batch": {"fires": 2},
                      "tier.spill_corrupt": {"fires": 2}}),
    dict(fault_stats={"engine.batch": {"fires": 0},
                      "tier.spill_corrupt": {"fires": 1}}),
    dict(rebuilds=0), dict(quarantined=[4])])
def test_check_floors_refuses_each_missed_floor(bad):
    chaos.check_floors(_good_report())
    rep = dict(_good_report(), **bad)
    if "fault_stats" in bad and "engine.batch" in bad["fault_stats"]:
        rep["batch_failures"] = 0
    with pytest.raises(RuntimeError, match="chaos floor missed"):
        chaos.check_floors(rep)


def _degraded_report():
    rep = dict(_good_report(), degraded=5, dropped_probes=12)
    rep["fault_stats"] = dict(rep["fault_stats"],
                              **{"tier.cold_read": {"fires": 3}})
    return rep


@pytest.mark.parametrize("bad", [
    dict(degraded=0), dict(dropped_probes=0),
    dict(fault_stats={"engine.batch": {"fires": 2},
                      "tier.spill_corrupt": {"fires": 1},
                      "tier.cold_read": {"fires": 0}})])
def test_check_floors_past_the_budget_refuses(bad):
    chaos.check_floors(_degraded_report(), degraded=True)
    rep = dict(_degraded_report(), **bad)
    chaos.check_floors(rep)              # the reference's floors still hold
    with pytest.raises(RuntimeError, match="chaos floor missed"):
        chaos.check_floors(rep, degraded=True)
