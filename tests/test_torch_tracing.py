"""The port's spans and counters (``repro_torch.obs``): a span is a
profiler range only while a profiler records; ``AnnService.search`` on
the plain and the cached path shows each phase's span once a chunk, in
the paper's order, inside one ``drim.service.search``, with CL's and TS's
top-k inside their own spans and no copy of the padded codes in
``drim.gather`` (DC reads the probed clusters in place; the plain
version's copy lies inside ``drim.dc``); tracing changes no answer; DC
counts the rows it scans, padding included."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.data.vectors import make_clustered_corpus
from repro_torch.kernels import ops
from repro_torch.service import AnnService, ServiceSpec

N_QUERIES = 600                   # three chunks of 256, the last partial
NPROBE = 4
PHASES = ("drim.cl", "drim.rc", "drim.lc", "drim.dc", "drim.ts")
PATHS = {"plain": {}, "cached": {"cache_capacity": 4096}}


@pytest.fixture(scope="module")
def corpus():
    c = make_clustered_corpus(0, 4000, 16, n_queries=N_QUERIES,
                              device="cpu")
    return np.asarray(c.points, np.float32), np.asarray(c.queries,
                                                        np.float32)


def _spec(**kw):
    return ServiceSpec.from_dict({"index": {"nlist": 32, "m": 4, "cb": 16},
                                  "nprobe": NPROBE, "k": 5,
                                  "engine": "local", **kw})


@pytest.fixture(scope="module")
def index(corpus):
    svc = AnnService.build(_spec(), points=torch.from_numpy(corpus[0]),
                           device="cpu")
    idx = svc.replicas[0].engine.index
    svc.shutdown()
    return idx


@pytest.fixture(params=list(PATHS))
def path(request):
    return request.param


@pytest.fixture
def svc(index, path):
    s = AnnService.build(_spec(**PATHS[path]), index=index, device="cpu")
    yield s
    s.shutdown()


def _profiled(fn, record_shapes=False):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=record_shapes) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def _inside(inner, outer):
    return (inner.start_ns() >= outer.start_ns()
            and inner.end_ns() <= outer.end_ns()
            and inner.start_thread_id() == outer.start_thread_id())


def test_span_is_a_profiler_range_only_under_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = obs.span("drim.cl")
    assert isinstance(off, contextlib.nullcontext)
    assert off is obs.span("drim.ts")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = obs.span("drim.cl")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            torch.ones(3).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("drim.cl") == 1


def test_phases_once_a_chunk_in_order_inside_the_service_span(svc, path,
                                                              corpus):
    _, events = _profiled(lambda: svc.search(corpus[1]), record_shapes=True)
    drim = sorted((e for e in events if e.name().startswith("drim.")),
                  key=lambda e: e.start_ns())
    outer = [e for e in drim if e.name() == "drim.service.search"]
    assert len(outer) == 1
    assert all(_inside(e, outer[0]) for e in drim)
    phases = [e.name() for e in drim
              if e.name() in PHASES + ("drim.gather",)]
    chunks = -(-N_QUERIES // 256)
    if path == "plain":
        assert phases == list(PHASES) * chunks
    else:           # the cached path locates every chunk's probes first
        assert phases == ["drim.cl"] * chunks + list(PHASES[1:]) * chunks
    names = [e.name() for e in drim]
    assert "drim.engine.h2d" in names and "drim.engine.d2h" in names
    spans = {n: [e for e in drim if e.name() == n]
             for n in PHASES + ("drim.gather",)}
    topks = [e for e in events if e.name() == "aten::topk"]
    assert topks
    for e in topks:
        assert any(_inside(e, s) for s in spans["drim.cl"] + spans["drim.ts"])
    codes = svc.replicas[0].engine.clusters.codes
    gathers = [e for e in events if e.name() == "aten::index_select"
               and list(e.shapes()[0]) == list(codes.shape)]
    assert len(gathers) == chunks
    for e in gathers:
        assert not any(_inside(e, s) for s in spans["drim.gather"])
        assert any(_inside(e, s) for s in spans["drim.dc"])


def test_answers_equal_with_the_profiler_on_and_off(svc, corpus):
    off = svc.search(corpus[1])
    on, _ = _profiled(lambda: svc.search(corpus[1]))
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_dc_counts_the_rows_it_scans(svc, corpus):
    cmax = svc.replicas[0].engine.clusters.codes.shape[1]
    tasks = N_QUERIES * NPROBE
    obs.reset()
    svc.search(corpus[1])
    assert obs.counts["dc.rows_scanned"] == tasks * cmax
    assert obs.counts.traced["dc.rows_scanned"] == 0
    _profiled(lambda: svc.search(corpus[1]))
    assert obs.counts["dc.rows_scanned"] == 2 * tasks * cmax
    assert obs.counts.traced["dc.rows_scanned"] == tasks * cmax
    obs.reset()
    assert obs.counts == {"dc.rows_scanned": 0}
    assert obs.counts.traced == {"dc.rows_scanned": 0}


def test_launch_counter_is_an_obs_counter():
    """``ops.launches`` keeps its names through a reset; CPU runs, which
    launch no kernel, leave it at zero."""
    assert isinstance(ops.launches, obs.Counters)
    ops.reset_launches()
    ops._launched("lut_build")
    ops._launched("pq_scan_dc")
    assert ops.launches["lut_build"] == ops.launches["pq_scan_dc"] == 1
    ops.reset_launches()
    assert set(ops.launches) >= {"lut_build", "pq_scan_dc", "pq_scan_topk"}
    assert all(v == 0 for v in ops.launches.values())
    assert all(v == 0 for v in ops.launches.traced.values())
