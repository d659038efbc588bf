"""Port parity for the service tier: ``ServiceSpec`` (cross-loading with
the reference, validation), the router policies, the autoscaler and
``ReplicaHealth`` (the same inputs give the same decisions), the cached
``LocalEngine`` and ``PimPacedEngine``, and ``AnnService`` over the local
and sharded engines, held to the reference's ``AnnService`` on one
reference-built index carried across by ``convert.py``.

Everything here runs on the CPU, where ``kernels.ops`` runs the kernels'
plain versions.  Tolerances as ROADMAP.md states them: f32 distances
rtol 1e-4 / atol 1e-3, ids as sets up to k-th-place ties; uint8 by a
recall drop of at most 0.01.
"""

import json
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SearchParams as RefParams
from repro.core import search_ivfpq as ref_search
from repro.core.sharded_search import EngineConfig as RefEngineConfig
from repro.runtime.fault_tolerance import ReplicaHealth as RefHealth
from repro.service import AnnService as RefService
from repro.service import Autoscaler as RefAutoscaler
from repro.service import ScaleSignals as RefSignals
from repro.service import ServiceSpec as RefSpec
from repro.service import make_policy as ref_make_policy
from repro.service.router import Router as RefRouter

from repro_torch.convert import index_from_numpy
from repro_torch.core import (SearchParams, pad_clusters, recall_at_k,
                              search_ivfpq)
from repro_torch.core.mutable_index import Index
from repro_torch.core.sharded_search import DistributedEngine, EngineConfig
from repro_torch.runtime import LocalEngine, ServingConfig, ServingRuntime
from repro_torch.runtime import serving as serving_mod
from repro_torch.runtime.fault_tolerance import ReplicaHealth
from repro_torch.service import (AnnService, Autoscaler, IndexSpec,
                                 ScaleSignals, ServiceSpec, make_policy)
from repro_torch.service import __main__ as cli
from repro_torch.service.router import Router
from repro_torch.service.spec import (DATAFLOW_ONLY_FIELDS,
                                      ENGINE_CONFIG_FIELDS)

from test_torch_search import assert_same_neighbours

torch.set_num_threads(1)
K, NPROBE = 10, 8
RTOL, ATOL = 1e-4, 1e-3


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


def _spec_kw(**kw):
    base = dict(engine="local", nprobe=NPROBE, k=K, buckets=(1, 2, 4),
                max_wait_s=1e-3)
    base.update(kw)
    return base


def _port(port_index, **kw):
    return AnnService.build(ServiceSpec(**_spec_kw(**kw)), index=port_index)


def _ref(small_index, **kw):
    return RefService.build(RefSpec(**_spec_kw(**kw)), index=small_index)


def _ref_direct(small_index, small_clusters, queries, k=K + 1, **kw):
    d, i = ref_search(small_index, small_clusters, jnp.asarray(queries),
                      RefParams(nprobe=NPROBE, k=k, **kw))
    return np.asarray(d), np.asarray(i)


# ---------------------------------------------------------------------------
# ServiceSpec: cross-loading, validation, the use_kernels override
# ---------------------------------------------------------------------------

SPECS = {
    "default": {},
    "nondefault": dict(engine="sharded", replicas=2, replicas_max=4,
                       router="cache_aware", nprobe=4, k=5,
                       lut_dtype="uint8", n_shards=4, tasks_per_shard=256,
                       relayout_every=8, heat_aware_admission=True,
                       tune_tasks_per_shard=True,
                       engine_overrides={"naive_layout": True},
                       cache_capacity_bytes=1 << 20, buckets=(2, 8),
                       max_wait_s=5e-3, autoscale_p99_budget_ms=12.5,
                       deadline_ms=4.0, pim_paced_ranks=64),
    "use_kernels": dict(engine="sharded", n_shards=4,
                        engine_overrides={"use_kernels": True}),
}


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("name", list(SPECS))
def test_spec_dict_cross_loads(name, direction):
    ref, port = RefSpec(**SPECS[name]), ServiceSpec(**SPECS[name])
    assert ref.to_dict() == port.to_dict()
    src, dst = ((ref, ServiceSpec) if direction == "ref_to_port"
                else (port, RefSpec))
    d = src.to_dict()
    back = dst.from_dict(d)
    assert back.to_dict() == d
    assert type(src).from_dict(back.to_dict()) == src


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_spec_json_file_cross_loads(tmp_path, writer):
    kw = SPECS["nondefault"]
    spec = (RefSpec if writer == "ref" else ServiceSpec)(**kw)
    path = spec.save(tmp_path / "deploy.json")
    other = (ServiceSpec if writer == "ref" else RefSpec).load(path)
    assert other.to_dict() == spec.to_dict()
    assert json.loads(path.read_text())["version"] == 5


def _overrides(extra):
    return lambda S: S(engine="sharded", engine_overrides=extra).validate()


VALIDATION_CASES = {
    "engine": lambda S: S(engine="weird").validate(),
    "router": lambda S: S(router="nope").validate(),
    "replicas": lambda S: S(replicas=0).validate(),
    "buckets": lambda S: S(buckets=()).validate(),
    "max_wait_s": lambda S: S(max_wait_s=0.0).validate(),
    "heat_no_cache": lambda S: S(engine="sharded", heat_aware_admission=True,
                                 cache_capacity=0).validate(),
    "relayout_local": lambda S: S(engine="local",
                                  relayout_every=3).validate(),
    "heat_local": lambda S: S(engine="local", heat_aware_admission=True,
                              cache_capacity=64).validate(),
    "overrides_unknown": _overrides({"bogus": 1}),
    "overrides_shadow": _overrides({"relayout_every": 8}),
    "overrides_local": lambda S: S(engine_overrides={"naive_layout": True}
                                   ).validate(),
    "replicas_max": lambda S: S(replicas=3, replicas_max=2).validate(),
    "autoscale_low": lambda S: S(autoscale_queue_low=5.0,
                                 autoscale_queue_high=1.0).validate(),
    "cooldown": lambda S: S(autoscale_cooldown=0).validate(),
    "unknown_key": lambda S: S.from_dict({**S().to_dict(),
                                          "qs_per_node": 3}),
    "version": lambda S: S.from_dict({**S().to_dict(), "version": 99}),
    "extension": lambda S: S().save("deploy.toml"),
}


@pytest.mark.parametrize("case", list(VALIDATION_CASES))
def test_spec_validation_errors_match_reference(case):
    with pytest.raises(ValueError) as ref_err:
        VALIDATION_CASES[case](RefSpec)
    with pytest.raises(ValueError) as port_err:
        VALIDATION_CASES[case](ServiceSpec)
    assert str(port_err.value) == str(ref_err.value)


def test_spec_knows_the_reference_engine_fields():
    """The port's spec validates overrides against the reference's
    EngineConfig field set and drops the dataflow-only keys on build."""
    assert ENGINE_CONFIG_FIELDS == set(RefEngineConfig.__dataclass_fields__)
    assert (set(EngineConfig.__dataclass_fields__)
            == ENGINE_CONFIG_FIELDS - DATAFLOW_ONLY_FIELDS)
    kw = ServiceSpec(**SPECS["use_kernels"]).engine_config_kwargs()
    assert "use_kernels" not in kw
    EngineConfig(**kw)


def test_use_kernels_override_boots_the_sharded_fleet(port_index, queries):
    """A reference spec that sets ``use_kernels`` boots the port's fleet,
    with the same results as the spec without it."""
    outs = []
    for extra in ({"use_kernels": True}, None):
        kw = _spec_kw(engine="sharded", n_shards=4, tasks_per_shard=512,
                      engine_overrides=extra)
        spec = ServiceSpec.from_dict(RefSpec(**kw).to_dict())
        svc = AnnService.build(spec, index=port_index,
                               sample_queries=queries)
        assert isinstance(svc.core_engine(), DistributedEngine)
        outs.append(svc.search(queries[:16]))
        svc.shutdown()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_index_spec_builds_on_the_requested_device(small_corpus):
    points = np.asarray(small_corpus.points)[:2000]
    spec = IndexSpec(nlist=16, m=8, cb=32, kmeans_iters=2, pq_iters=2)
    handle = spec.build(points, device="cpu")
    assert isinstance(handle, Index) and handle.device.type == "cpu"
    assert len(handle) == 2000 and handle.nlist == 16
    assert handle.clusters is handle.clusters          # padded once
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spec.build(points)                         # default: the card


# ---------------------------------------------------------------------------
# Router, autoscaler, ReplicaHealth: the same inputs, the same decisions
# ---------------------------------------------------------------------------

def _route_trace(router_cls, policy, n_steps, rng_seed, nlist):
    rng = np.random.default_rng(rng_seed)
    probes = [rng.choice(nlist, size=4, replace=False) for _ in range(n_steps)]
    depths = [rng.integers(0, 5, size=4).tolist() for _ in range(n_steps)]
    step = {"i": 0}
    router = router_cls(policy, 3,
                        depth_fn=lambda r: depths[step["i"]][r],
                        probe_fn=lambda q: probes[step["i"]])
    out = []
    for i in range(n_steps):
        step["i"] = i
        if i == 20:
            router.resize(2)
        elif i == 30:
            router.resize(4)
        elif i == 40:
            router.invalidate_clusters(nlist)
        out.append(router.route(np.zeros(4, np.float32)))
    return out, router.stats()


@pytest.mark.parametrize("policy", ["round_robin", "least_queue",
                                    "cache_aware"])
def test_router_picks_match_reference(policy):
    nlist = 12      # probe overlap high enough for the bounded-load spill
    ref = _route_trace(RefRouter, ref_make_policy(
        policy, nlist=nlist, n_replicas=3, halflife_batches=8.0), 60, 3,
        nlist)
    mine = _route_trace(Router, make_policy(
        policy, nlist=nlist, n_replicas=3, halflife_batches=8.0), 60, 3,
        nlist)
    assert mine == ref


def _signals(module_signals, rng):
    n = int(rng.integers(1, 5))
    opened = rng.random(n) < 0.2
    return module_signals(
        queue_depths=rng.integers(0, 9, size=n).tolist(),
        p99_s=None if rng.random() < 0.3 else float(rng.random() * 0.02),
        open_breakers=int(opened.sum()),
        open_mask=opened.tolist() if rng.random() < 0.5 else None)


@pytest.mark.parametrize("p99_budget", [None, 0.01])
def test_autoscaler_decisions_match_reference(p99_budget):
    ref = RefAutoscaler(1, 4, queue_high=3.0, queue_low=0.5,
                        p99_budget_s=p99_budget, cooldown=2)
    mine = Autoscaler(1, 4, queue_high=3.0, queue_low=0.5,
                      p99_budget_s=p99_budget, cooldown=2)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(80):
        assert (mine.decide(_signals(ScaleSignals, rng_a))
                == ref.decide(_signals(RefSignals, rng_b)))
    assert mine.stats() == ref.stats() and ref.stats()["events"]


@pytest.mark.parametrize("half_open_s", [0.0, 2.0])
def test_replica_health_matches_reference(half_open_s):
    """One random sequence of outcomes, probes, resizes and clock steps on
    a fake clock: the same states, admissions and stats at every step."""
    now = {"t": 0.0}
    clock = lambda: now["t"]                       # noqa: E731
    ref = RefHealth(3, max_consecutive=2, half_open_after_s=half_open_s,
                    clock=clock)
    mine = ReplicaHealth(3, max_consecutive=2, half_open_after_s=half_open_s,
                         clock=clock)
    rng = np.random.default_rng(11)
    for _ in range(200):
        op = rng.integers(0, 5)
        r = int(rng.integers(0, ref.n_replicas))
        if op == 0:
            ref.record_failure(r), mine.record_failure(r)
        elif op == 1:
            ref.record_success(r), mine.record_success(r)
        elif op == 2:
            assert mine.allow(r) == ref.allow(r)
        elif op == 3:
            now["t"] += float(rng.random() * 1.5)
        else:
            n = int(rng.integers(1, 5))
            ref.resize(n), mine.resize(n)
        assert mine.stats() == ref.stats()
        assert mine.healthy() == ref.healthy()
        assert mine.open_count() == ref.open_count()
        assert [mine.state(i) for i in range(mine.n_replicas)] == \
            [ref.state(i) for i in range(ref.n_replicas)]


# ---------------------------------------------------------------------------
# AnnService over the local engine
# ---------------------------------------------------------------------------

def test_one_replica_local_equals_search_ivfpq(port_index, small_index,
                                               small_clusters, queries):
    svc = _port(port_index, replicas=1)
    d_s, i_s = svc.search(queries)
    d_d, i_d = search_ivfpq(port_index, pad_clusters(port_index),
                            torch.from_numpy(queries),
                            SearchParams(nprobe=NPROBE, k=K,
                                         use_kernels=True))
    np.testing.assert_array_equal(i_s, i_d.numpy())
    np.testing.assert_array_equal(d_s, d_d.numpy())
    # the reference service (1 replica == its search_ivfpq) on one index
    ref = _ref(small_index, replicas=1, k=K + 1)
    rd, ri = ref.search(queries)
    np.testing.assert_array_equal(ri, _ref_direct(small_index,
                                                  small_clusters,
                                                  queries)[1])
    np.testing.assert_allclose(d_s, rd[:, :K], rtol=RTOL, atol=ATOL)
    assert_same_neighbours(d_s, i_s, rd, ri)
    # streamed single requests equal the same direct call
    reqs = svc.stream([(i * 3e-4, queries[i]) for i in range(8)])
    np.testing.assert_array_equal(np.stack([r.ids for r in reqs]),
                                  i_d.numpy()[:8])
    svc.shutdown()
    ref.shutdown()


@pytest.fixture(scope="module")
def direct_sets(port_index, queries):
    """Neighbour sets of a 1-replica direct search of queries[:8]."""
    base = _port(port_index, replicas=1)
    sets = [frozenset(r.tolist()) for r in base.search(queries[:8])[1]]
    base.shutdown()
    return sets


@pytest.mark.parametrize("nrep,policy,clock", [
    (1, "round_robin", "virtual"), (3, "round_robin", "virtual"),
    (3, "least_queue", "virtual"), (3, "cache_aware", "virtual"),
    (3, "cache_aware", "wall"), (2, "least_queue", "wall")])
def test_neighbour_sets_invariant_across_replicas_policies_clocks(
        port_index, queries, direct_sets, nrep, policy, clock):
    """One stream, several fleets: per-query neighbour sets equal those of
    a direct search (routing and clocks never change results)."""
    q8 = queries[:8]
    stream = [(i * 3e-4, q8[i % 8]) for i in range(24)]
    svc = _port(port_index, replicas=nrep, router=policy,
                cache_capacity=512)
    svc.warmup()
    reqs = svc.stream(stream, clock=clock)
    got = [frozenset(r.ids.tolist()) for r in reqs]
    assert got == [direct_sets[i % 8] for i in range(24)]
    st = svc.stats()
    assert sum(st["router"]["picks"]) == len(stream)
    assert st["aggregate"]["requests"] == len(stream)
    svc.shutdown()


def test_padding_never_touches_routing_heat(port_index, queries):
    svc = _port(port_index, replicas=2, router="cache_aware",
                cache_capacity=512, buckets=(4,), max_wait_s=1e-4)
    svc.warmup()
    ests = svc.router.policy.estimators
    assert all(e.batches_observed == 0 for e in ests)   # warmup invisible
    # spaced arrivals: every batch is 1 valid row + 3 padding rows
    svc.stream([(i * 1e-3, queries[i]) for i in range(6)])
    assert sum(svc.router.picks) == 6
    for picks, est in zip(svc.router.picks, ests):
        assert est.batches_observed == picks            # one per request
    svc.shutdown()


def _batch_sequence(queries, n_batches=14, seed=0):
    """Skewed serving batches over an 8-query pool: (bucket, D) arrays
    with n_valid real rows and zero padding, as the micro-batcher makes."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, 9) ** 1.2
    out = []
    for _ in range(n_batches):
        bucket = int(rng.choice([1, 2, 4]))
        nv = int(rng.integers(1, bucket + 1))
        q = np.zeros((bucket, queries.shape[1]), np.float32)
        q[:nv] = queries[rng.choice(8, size=nv, p=weights / weights.sum())]
        out.append((q, nv))
    return out


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_cache_on_equals_cache_off_and_counts_match_reference(
        port_index, small_index, queries, lut_dtype):
    """The cached LocalEngine gives the cache-off engine's results bit for
    bit, and its hit/miss/insert counts equal the reference's cached
    LocalEngine on the same batch sequence; pad rows never reach it."""
    on = _port(port_index, lut_dtype=lut_dtype, cache_capacity=16)
    off = _port(port_index, lut_dtype=lut_dtype)
    ref = _ref(small_index, lut_dtype=lut_dtype, cache_capacity=16)
    for svc in (on, off, ref):
        svc.warmup()
    assert on.replicas[0].cache.stats.lookups == 0      # warmup invisible
    for q, nv in _batch_sequence(queries):
        d1, i1 = on.core_engine().search_batch(q, n_valid=nv)
        d0, i0 = off.core_engine().search_batch(q, n_valid=nv)
        ref.core_engine().search_batch(q, n_valid=nv)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(i1, i0)
    mine = on.replicas[0].cache.stats.as_dict()
    want = ref.replicas[0].cache.stats.as_dict()
    assert mine == want and mine["hits"] > 0 and mine["evictions"] > 0
    for svc in (on, off, ref):
        svc.shutdown()


def test_uint8_service_recall_drop(port_index, small_index, small_corpus,
                                   queries):
    """The uint8 spec (byte-budgeted cache on): recall@10 within 0.01 of
    the f32 service's and of the reference's uint8 service."""
    gt = torch.from_numpy(np.asarray(small_corpus.groundtruth))
    rec = {}
    for dt in ("f32", "uint8"):
        svc = _port(port_index, lut_dtype=dt, cache_capacity_bytes=1 << 20)
        svc.warmup()
        svc.stream([(i * 3e-4, queries[i % 16]) for i in range(32)])
        rec[dt] = recall_at_k(torch.from_numpy(svc.search(queries)[1]), gt)
        svc.shutdown()
    ref = _ref(small_index, lut_dtype="uint8")
    rec_ref = recall_at_k(torch.from_numpy(np.asarray(ref.search(queries)[1])),
                          gt)
    ref.shutdown()
    assert rec["f32"] - rec["uint8"] <= 0.01
    assert abs(rec["uint8"] - rec_ref) <= 0.01


def test_online_submit_step_and_shutdown(port_index, queries):
    q4 = queries[:4]
    svc = _port(port_index, replicas=2, router="least_queue", buckets=(2,),
                max_wait_s=1e-2)
    svc.warmup()
    reqs = [svc.submit(q4[i], now=0.0) for i in range(4)]
    assert all(r.future is not None and not r.future.done() for r in reqs)
    done = svc.step(now=0.0)          # both replicas' buckets are full
    assert len(done) == 4 and all(r.future.done() for r in reqs)
    assert svc.router.picks == [2, 2]                   # ties rotate
    _, direct_i = svc.search(q4)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.ids, direct_i[i])
    st = svc.shutdown()
    assert st["aggregate"]["requests"] == 4
    with pytest.raises(RuntimeError, match="shut down"):
        svc.search(q4)
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(q4[0], now=1.0)


def test_wall_stream_equals_sync_search(port_index, queries):
    q16 = queries[:16]
    svc = _port(port_index, replicas=3, router="cache_aware",
                cache_capacity=512)
    svc.warmup()
    direct_d, direct_i = svc.search(q16)
    reqs = svc.stream([(i * 1e-3, q16[i % 16]) for i in range(32)],
                      clock="wall")
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.ids, direct_i[i % 16])
        np.testing.assert_array_equal(r.dists, direct_d[i % 16])
        t = r.future.timing()
        assert t["total_s"] == pytest.approx(
            t["queue_s"] + t["batch_s"] + t["engine_s"], abs=1e-9)
        assert t["replica"] in (0, 1, 2) and not t["retried"]
    with pytest.raises(RuntimeError, match="virtual clock"):
        svc.stream([(0.0, q16[0])])           # executors are live now
    svc.shutdown()


def test_future_timeout_fires(port_index, queries):
    svc = _port(port_index, replicas=1)
    req = svc.submit(queries[0], now=0.0)     # virtual: nobody steps
    with pytest.raises(TimeoutError, match="not served"):
        req.future.result(timeout=0.05)
    svc.step(now=1.0, drain=True)
    assert req.future.done()
    svc.shutdown()


def test_autoscale_and_scale_to_keep_results(port_index, queries):
    """Grow and shrink the live fleet between batches: picks keep their
    history, the router follows, results stay the direct search's."""
    q8 = queries[:8]
    svc = _port(port_index, replicas=1, replicas_max=3,
                router="cache_aware", autoscale_queue_high=0.5,
                autoscale_queue_low=0.1, autoscale_cooldown=1,
                autoscale_interval=2, max_wait_s=5e-3)
    svc.warmup()
    _, direct_i = svc.search(q8)
    reqs = svc.stream([(i * 1e-4, q8[i % 8]) for i in range(32)],
                      clock="wall")
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.ids, direct_i[i % 8])
    svc.scale_to(3)
    assert svc.n_replicas == 3 and svc.router.stats()["live"] == 3
    assert len(svc.router.policy.estimators) == 3
    futs = [svc.submit_async(q8[i]) for i in range(8)]
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=30.0)[1], direct_i[i])
    svc.scale_to(1)
    st = svc.stats()
    assert sum(st["router"]["picks"]) == 40 and st["router"]["live"] == 1
    assert st["aggregate"]["requests"] == 40
    svc.shutdown()


class _FlakyEngine:
    """Fails the first ``n_failures`` live batches, then recovers."""

    def __init__(self, inner, n_failures=1):
        self.inner = inner
        self.k = inner.k
        self.n_failures = n_failures
        self.calls = 0
        self.lock = threading.Lock()

    def search_batch(self, queries, n_valid=None):
        if n_valid is None or n_valid > 0:      # never fail warmup padding
            with self.lock:
                if self.calls < self.n_failures:
                    self.calls += 1
                    raise RuntimeError("injected engine failure")
        return self.inner.search_batch(queries, n_valid)


def test_replica_failure_retries_on_another(port_index, queries):
    q8 = queries[:8]
    svc = _port(port_index, replicas=2, router="round_robin",
                buckets=(1, 2))
    svc.warmup()
    _, direct_i = svc.search(q8)
    rep0 = svc.replicas[0]
    rep0.engine = rep0.runtime.engine = _FlakyEngine(rep0.engine)
    futs = [svc.submit_async(q8[i]) for i in range(8)]
    for i, fut in enumerate(futs):
        np.testing.assert_array_equal(fut.result(timeout=30.0)[1],
                                      direct_i[i])
    st = svc.stats()
    assert st["aggregate"]["retries"] >= 1
    assert st["health"]["failures"][0] >= 1
    assert st["health"]["failures"][1] == 0
    assert st["health"]["unhealthy"] == []
    retried = [f for f in futs if f.timing()["retried"]]
    assert retried and all(f.timing()["replica"] == 1 for f in retried)
    svc.shutdown()


def test_failure_with_no_retry_target_raises(port_index, queries):
    svc = _port(port_index, replicas=1, buckets=(1,), max_wait_s=1e-4)
    svc.warmup()
    rep = svc.replicas[0]
    rep.engine = rep.runtime.engine = _FlakyEngine(rep.engine, 100)
    fut = svc.submit_async(queries[0])
    with pytest.raises(RuntimeError, match="injected"):
        fut.result(timeout=30.0)
    assert svc.stats()["health"]["failures"][0] >= 1
    svc.shutdown()


def test_pim_paced_changes_timing_not_results(port_index, small_index,
                                              queries):
    q8 = queries[:8]
    plain = _port(port_index)
    paced = _port(port_index, pim_paced_ranks=4)
    ref = _ref(small_index, pim_paced_ranks=4)
    d0, i0 = plain.search(q8)
    d1, i1 = paced.search(q8)                 # bulk path: unpaced
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    engine = paced.replicas[0].runtime.engine
    ref_engine = ref.replicas[0].runtime.engine
    for n in (1, 2, 3, 4, 7, 32):
        assert engine.batch_latency_s(n) == ref_engine.batch_latency_s(n)
    paced.warmup()
    floor = engine.batch_latency_s(1)
    assert floor > 0
    reqs = paced.stream([(i * 1e-3, q8[i]) for i in range(8)], clock="wall")
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.ids, i0[i])
        assert r.timing()["engine_s"] >= 0.9 * floor
    assert engine.paced_batches >= 1
    for svc in (plain, paced, ref):
        svc.shutdown()


def test_deadline_missed_is_stamped(port_index, queries):
    svc = _port(port_index, deadline_ms=1e-6)
    reqs = svc.stream([(i * 1e-3, queries[i]) for i in range(4)])
    assert all(r.deadline_missed for r in reqs)
    assert svc.stats()["aggregate"]["deadline_missed"] == 4
    svc.shutdown()


# ---------------------------------------------------------------------------
# AnnService over the sharded engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_sharded_service_stream_equals_direct(port_index, small_index,
                                              queries, lut_dtype):
    kw = dict(engine="sharded", replicas=2, router="cache_aware",
              n_shards=4, tasks_per_shard=512, cache_capacity=1024,
              heat_aware_admission=True, tune_tasks_per_shard=True,
              buckets=(1, 2), max_wait_s=1e-4, lut_dtype=lut_dtype)
    svc = AnnService.build(ServiceSpec(**_spec_kw(**kw)), index=port_index,
                           sample_queries=queries)
    svc.warmup()
    q4 = queries[:4]
    direct_d, direct_i = svc.search(q4)
    reqs = svc.stream([(i * 1e-3, q4[i % 4]) for i in range(8)])
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.dists, direct_d[i % 4])
        assert set(r.ids.tolist()) == set(direct_i[i % 4].tolist())
    assert isinstance(svc.core_engine(), DistributedEngine)
    if lut_dtype == "f32":
        ref = RefService.build(RefSpec(**_spec_kw(**kw)), index=small_index,
                               sample_queries=queries)
        rd, ri = ref.search(q4)
        np.testing.assert_allclose(direct_d, rd, rtol=RTOL, atol=ATOL)
        assert [set(r) for r in direct_i.tolist()] == \
            [set(r) for r in np.asarray(ri).tolist()]
        ref.shutdown()
    svc.shutdown()


# ---------------------------------------------------------------------------
# Fault injection on every build configuration; refusals the reference
# shares; direct construction warns; the selftest
# ---------------------------------------------------------------------------

ARMED = {
    # the build configurations that raised NotImplementedError before
    # fault injection was ported (ROADMAP item 9): each now takes a real
    # FaultInjector on every chaos site it has
    "mutable": (dict(mutable=True), dict(tenants=np.zeros(8000, np.int32))),
    "tiered": (dict(storage="tiered", storage_budget_bytes=1,
                    tenants=(("a", 0, 1.0, 0.0, 1),)), {}),
    "coarse": (dict(coarse_groups=4), {}),
    "tenants": (dict(tenants=(("a", 0, 1.0, 0.0, 1),), qos_wfq=True), {}),
    "tenant_rows": ({}, dict(tenants=np.zeros(8000, np.int32))),
    "faults": ({}, {}),
}


@pytest.mark.parametrize("case", list(ARMED))
def test_reference_only_features_raise(port_index, small_corpus, queries,
                                       case):
    """Formerly the refusal of ``fault_injector=`` (item 9); now each of
    the same build configurations is armed with a real injector: every
    runtime, the tier and the mutator hold it, the executor path consults
    the engine sites, and ``stats()['faults']`` is its ledger."""
    from repro_torch.runtime import FaultInjector, FaultPlan, FaultRule
    from repro_torch.runtime.faults import SITES
    spec_kw, build_kw = ARMED[case]
    inj = FaultInjector(FaultPlan(seed=0, rules=tuple(
        FaultRule(site, rate=0.0) for site in SITES)))
    if spec_kw.get("mutable"):
        build_kw = dict(build_kw, points=np.asarray(small_corpus.points,
                                                    np.float32),
                        device="cpu")
        src = {}
    else:
        src = dict(index=port_index)
    svc = AnnService.build(ServiceSpec(**_spec_kw(replicas=2, **spec_kw)),
                           fault_injector=inj, **src, **build_kw)
    assert svc.faults is inj
    assert all(rep.runtime.faults is inj for rep in svc.replicas)
    tier = svc.index.tiered_store
    assert (tier is not None) == (case == "tiered")
    assert tier is None or tier.faults is inj
    assert (svc.mutator is not None) == (case == "mutable")
    assert svc.mutator is None or svc.mutator.faults is inj
    svc.warmup()
    direct_d, direct_i = svc.search(queries[:6])
    futs = [svc.submit_async(q) for q in queries[:6]]
    for i, f in enumerate(futs):
        d, ids = f.result(timeout=60.0)
        np.testing.assert_array_equal(d, direct_d[i])
        np.testing.assert_array_equal(ids, direct_i[i])
    st = svc.stats()
    assert st["faults"] == inj.stats()
    assert st["faults"]["engine.batch"]["consultations"] > 0
    assert all(v["fires"] == 0 for v in st["faults"].values())
    svc.shutdown()


def test_reference_only_calls_raise(port_index, queries):
    # tenancy is ported (ROADMAP item 8): scoped calls on a service, an
    # index or an engine without per-vector metadata are refused as the
    # reference refuses them
    svc = _port(port_index)
    with pytest.raises(ValueError, match="meta=None"):
        svc.search(queries[:2], tenant=0)
    with pytest.raises(KeyError, match="tenants section"):
        svc.stream([(0.0, queries[0], "anna")])
    live = IndexSpec(nlist=4, m=8, cb=16, kmeans_iters=2, pq_iters=2).build(
        np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32),
        device="cpu", mutable=True)
    with pytest.raises(ValueError, match="meta"):
        live.upsert([64], np.zeros((1, 32), np.float32), tenant=0)
    eng = LocalEngine(port_index, pad_clusters(port_index),
                      SearchParams(nprobe=NPROBE, k=K))
    with pytest.raises(ValueError, match="meta=None"):
        eng.search_batch(queries[:2], terms=np.zeros((2, 4), np.uint32))
    svc.shutdown()


def test_direct_construction_warns_once_service_does_not(port_index):
    serving_mod._DEPRECATION_WARNED.clear()
    params = SearchParams(nprobe=NPROBE, k=K)
    with pytest.warns(DeprecationWarning, match="LocalEngine"):
        eng = LocalEngine(port_index, pad_clusters(port_index), params)
    with pytest.warns(DeprecationWarning, match="ServingRuntime"):
        ServingRuntime(eng, ServingConfig())
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        LocalEngine(port_index, pad_clusters(port_index), params)
        _port(port_index, replicas=2, cache_capacity=64).shutdown()


@pytest.mark.parametrize("clock", ["virtual", "wall"])
def test_selftest_passes_on_the_cpu(clock, capsys):
    assert cli.selftest(clock=clock, device="cpu") == 0
    out = capsys.readouterr().out
    # all five of the reference's phases run, the tiered one included
    assert "NOT RUN" not in out and "OK (clock=" in out
    assert out.count(": OK") == 5 and "[selftest] tiered:" in out


@pytest.mark.parametrize("flag", ["--selftest-chaos", "--selftest-tenants",
                                  "--autotune"])
def test_cli_refuses_what_is_not_ported(flag, capsys):
    """Formerly each of these exited 2 naming its ROADMAP item; all three
    are ported now and the CLI refuses nothing."""
    assert not hasattr(cli, "NOT_PORTED")
    if flag == "--selftest-tenants":
        # runs in test_torch_tenancy.py::test_selftest_tenants_on_the_cpu
        with pytest.raises(SystemExit) as ex:
            cli.main(["--help"])
        assert ex.value.code == 0
        assert "multi-tenant serving smoke" in capsys.readouterr().out
        return
    args = [flag, "--device", "cpu"]
    if flag == "--selftest-chaos":
        args += ["--chaos-queries", "300"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    if flag == "--selftest-chaos":
        assert "corrupt_results=0: OK (device=cpu)" in out
    else:
        assert "[autotune] winner:" in out and "slo: recall@10" in out


def test_cli_boots_a_spec_file(tmp_path, capsys):
    path = RefSpec(engine="local", replicas=2, router="least_queue",
                   nprobe=4, k=5, buckets=(1, 2, 4),
                   max_wait_s=1e-3).save(tmp_path / "deploy.json")
    assert cli.main(["--spec", str(path), "--device", "cpu"]) == 0
    assert "booted 2 replica(s)" in capsys.readouterr().out



# ---------------------------------------------------------------------------
# Shared state under thread contention
# ---------------------------------------------------------------------------

def _contended(fn, n_threads=8):
    """Run ``fn`` on ``n_threads`` threads at once with a short switch
    interval; every thread must finish within 60 s."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fn) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_launch_counters_lose_no_update_across_threads():
    """Replica workers count kernel launches from several threads."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    _contended(lambda: [ops._launched("lut_build") for _ in range(2000)])
    assert ops.launches["lut_build"] == 8 * 2000
    ops.reset_launches()


def test_more_workers_than_cores_all_resolve(port_index, queries):
    """Ten executor-backed replicas (more worker threads than the host's
    cores), a short switch interval, one replica failing its first batch:
    every future resolves to the direct search's result, and the pick,
    request and retry counts add up."""
    import sys
    q16 = queries[:16]
    svc = _port(port_index, replicas=10, router="round_robin",
                buckets=(1, 2), max_wait_s=1e-4)
    svc.warmup()
    _, direct_i = svc.search(q16)
    rep = svc.replicas[3]
    rep.engine = rep.runtime.engine = _FlakyEngine(rep.engine)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        futs = [(j % 16, svc.submit_async(q16[j % 16])) for j in range(160)]
        for j, f in futs:
            np.testing.assert_array_equal(f.result(timeout=60.0)[1],
                                          direct_i[j])
    finally:
        sys.setswitchinterval(old)
    st = svc.shutdown()
    assert sum(st["router"]["picks"]) == 160
    assert st["aggregate"]["requests"] == 160
    assert st["aggregate"]["retries"] >= 1
    assert not any(ex.running for ex in svc._executors)
