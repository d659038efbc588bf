"""The shard mesh: ``launch/mesh.py::make_shard_mesh``, the mesh steps
(``make_sharded_step``, ``make_sharded_step_lut``) and
``DistributedEngine(mesh=...)``.

The port's mesh is one process over a tuple of devices, and a device
may repeat, so eight CPU entries stand in here for the reference's eight
forced host devices.  The reference's ``shard_map`` engine runs in a
subprocess with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_sharded_search.py`` runs it) on the ``small_index``
fixture, passed through numpy.  Against it: f32 distances at rtol 1e-4
/ atol 1e-3 with ids equal per query up to k-th-place ties, uint8
recall@10 within 0.01, the LUT cache off and on, with flush rounds.
Against the port's own flat path (one program over every shard), the
mesh engine is held bit for bit: flush rounds, the cache, a re-layout,
index generations, the tiered engine and OPQ.  A mesh whose entries lie
on other devices than the engine's is held in tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster_locate as ref_locate

from repro_torch.convert import index_from_numpy
from repro_torch.core import build_ivfpq, pad_clusters, recall_at_k
from repro_torch.core import sharded_search as ss
from repro_torch.launch import make_shard_mesh
from repro_torch.runtime import HotClusterLUTCache, OnlineHeatEstimator
from repro_torch.storage import TieredStore

from test_torch_search import assert_same_neighbours

torch.set_num_threads(1)
K, NPROBE, S = 10, 8, 8
RTOL, ATOL = 1e-4, 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * S


@pytest.fixture(scope="module")
def port(small_index):
    return index_from_numpy(small_index.centroids,
                            small_index.codebook.codebooks,
                            small_index.codebook.sqnorms, small_index.codes,
                            small_index.ids, small_index.offsets,
                            device="cpu")


@pytest.fixture(scope="module")
def queries(small_corpus):
    return np.array(small_corpus.queries, np.float32)


@pytest.fixture(scope="module")
def sample_probes(small_index, queries):
    return np.asarray(ref_locate(jnp.asarray(queries), small_index.centroids,
                                 NPROBE)[0])


@pytest.fixture(scope="module")
def mesh():
    return make_shard_mesh(S, devices=CPU8)


def _cfg(module=ss, **kw):
    kw.setdefault("n_shards", S)
    kw.setdefault("nprobe", NPROBE)
    kw.setdefault("k", K)
    kw.setdefault("tasks_per_shard", 512)
    kw.setdefault("split_max", 64)
    kw.setdefault("dup_budget_bytes", 1 << 17)
    kw.setdefault("strategy", "gather")
    return module.EngineConfig(**kw)


def _pair(idx, probes, mesh, cache=False, lut_dtype="f32", extra=None,
          **kw):
    """(flat engine, mesh engine) on one config, each with its own
    collaborators from ``extra()`` and, with ``cache``, its own cache."""
    def build(m):
        more = dict(extra() if extra else {})
        if cache:
            more["lut_cache"] = HotClusterLUTCache(capacity=4096,
                                                   lut_dtype=lut_dtype)
        return ss.DistributedEngine(idx, _cfg(lut_dtype=lut_dtype, **kw),
                                    probes, mesh=m, **more)
    return build(None), build(mesh)


def _same(a, b, q, **kw):
    """Both engines' search of ``q``: bit for bit, rounds included."""
    da, ia, ra = a.search(q, **kw)
    db, ib, rb = b.search(q, **kw)
    np.testing.assert_array_equal(db, da)
    np.testing.assert_array_equal(ib, ia)
    assert rb == ra
    return ra["rounds"]


# ---------------------------------------------------------------------------
# make_shard_mesh
# ---------------------------------------------------------------------------

def test_make_shard_mesh_contract():
    mesh = make_shard_mesh(S, devices=CPU8)
    assert mesh.axis_names == ("shards",)
    assert mesh.shape == {"shards": S} and mesh.size == S
    assert mesh.devices.shape == (S,)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.streams == (None,) * S          # CPU entries own no stream
    # names or devices alike, one per entry
    two = make_shard_mesh(2, devices=["cpu"] * 2)
    assert two.size == 2 and two.devices[1] == torch.device("cpu")
    assert not two.closed
    two.close()
    assert two.closed


def test_make_shard_mesh_raises():
    # by default the visible CUDA devices, never the CPU
    with pytest.raises(ValueError, match="CUDA devices"):
        make_shard_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="got 3 devices"):
        make_shard_mesh(4, devices=CPU8[:3])
    with pytest.raises(ValueError, match="got 8 devices"):
        make_shard_mesh(4, devices=CPU8)
    with pytest.raises(ValueError, match=">= 1"):
        make_shard_mesh(0, devices=CPU8)


def test_mesh_size_and_axis_must_fit_the_engine(port, sample_probes):
    """A mesh of another size than n_shards is refused when the engine is
    built (the reference accepts 4 devices for 8 shards, then reads one
    shard of each device's two and fails in the host merge)."""
    with pytest.raises(ValueError, match="4 entries for 8 shards"):
        ss.DistributedEngine(port, _cfg(), sample_probes,
                             mesh=make_shard_mesh(4, devices=CPU8[:4]))
    wrong = make_shard_mesh(S, devices=CPU8)
    wrong.axis_names = ("data",)
    with pytest.raises(ValueError, match="axis 'shards'"):
        ss.DistributedEngine(port, _cfg(), sample_probes, mesh=wrong)
    eng = ss.DistributedEngine(port, _cfg(), sample_probes)
    for build in (ss.make_sharded_step, ss.make_sharded_step_lut):
        with pytest.raises(ValueError, match="mesh size must equal"):
            build(make_shard_mesh(2, devices=CPU8[:2]), eng.sindex, k=K)


def test_scoped_search_on_a_mesh_raises(port, queries, sample_probes, mesh):
    from repro_torch.core.filter import VectorMeta
    n = int(port.sizes.sum())
    meta = VectorMeta(capacity=n)
    meta.set(np.arange(n), tenant=np.zeros(n, np.int32))
    eng = ss.DistributedEngine(port, _cfg(), sample_probes, mesh=mesh,
                               meta=meta)
    with pytest.raises(ValueError, match="mesh \\(shard_map\\) path"):
        eng.search(queries[:2], tenants=np.zeros(2, np.int32))
    d, i, _ = eng.search(queries[:2])              # unscoped traffic runs
    assert np.isfinite(d).all() and (i >= 0).all()


# ---------------------------------------------------------------------------
# The mesh steps against the flat steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
def test_mesh_steps_equal_flat_steps(port, queries, sample_probes, mesh,
                                     quantize):
    """The two mesh steps on one scheduled batch == the flat steps bit for
    bit, whether the shard tensors come as (S, ...) tensors or placed;
    the cached step leaves ``lidx == -1`` tasks (+inf, -1)."""
    eng = ss.DistributedEngine(port, _cfg(tasks_per_shard=96),
                               sample_probes)
    sx = eng.sindex
    sched = eng.schedule(eng.locate(torch.from_numpy(queries)))
    qidx = torch.from_numpy(sched.query_idx)
    sidx = torch.from_numpy(sched.slot_idx)
    q = torch.from_numpy(queries)
    step = ss.make_sharded_step(mesh, sx, k=K, strategy="gather",
                                quantize=quantize)
    want = ss.run_shards_vmap(sx, qidx, sidx, q, k=K, strategy="gather",
                              quantize=quantize)
    placed = tuple(ss.shard_to_mesh(mesh, x) for x in (
        sx.codes, sx.ids, sx.sizes, sx.cluster_of))
    assert placed[0][3].data_ptr() == sx.codes[3].data_ptr()    # views
    for shards in ((sx.codes, sx.ids, sx.sizes, sx.cluster_of), placed):
        got = step(*shards, qidx, sidx, q, sx.centroids)
        for g, w in zip(got, want):
            assert g.shape == (S, qidx.shape[1], K)
            assert torch.equal(g, w)
    # the cached step on a bank of the tasks' own tables, a third of the
    # tasks without a bank row
    lc = ss._task_lut(sx.cluster_of.reshape(-1), qidx.reshape(-1),
                      ss._flat_slots(sidx, sx.slots).clamp_min(0),
                      q, sx.centroids, sx.codebook, sx.rotation, quantize)
    lidx = torch.arange(qidx.numel(), dtype=torch.int32).reshape(qidx.shape)
    lidx[:, ::3] = -1
    step_lut = ss.make_sharded_step_lut(mesh, sx, k=K, strategy="gather")
    got = step_lut(*placed[:3], qidx, sidx, lidx, lc)
    want = ss.run_shards_vmap_lut(sx, qidx, sidx, lidx, lc, k=K,
                                  strategy="gather")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(torch.isinf(got[0][:, ::3]).all())
    assert bool((got[1][:, ::3] == -1).all())
    # a closed mesh runs no step
    closed = make_shard_mesh(S, devices=CPU8)
    step = ss.make_sharded_step(closed, sx, k=K, quantize=quantize)
    closed.close()
    with pytest.raises(RuntimeError, match="mesh is closed"):
        step(*placed, qidx, sidx, q, sx.centroids)


# ---------------------------------------------------------------------------
# DistributedEngine(mesh=...) against the port's flat engine, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [False, True], ids=["cache-off",
                                                      "cache-on"])
@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_mesh_engine_equals_flat_bit_for_bit(port, queries, sample_probes,
                                             mesh, lut_dtype, cache):
    """Three batches: all tasks in one round, then a narrow task table
    (flush rounds), then the first batch again (all cache hits)."""
    flat, on_mesh = _pair(port, sample_probes, mesh, cache=cache,
                          lut_dtype=lut_dtype)
    assert on_mesh.mesh is mesh and flat._step is None
    assert len(on_mesh._shards[0]) == S
    assert _same(flat, on_mesh, queries) == 1
    for eng in (flat, on_mesh):
        eng.cfg.tasks_per_shard = 24
    assert _same(flat, on_mesh, queries) > 1
    _same(flat, on_mesh, queries[:16])
    if cache:
        assert on_mesh.lut_cache.stats.hits == flat.lut_cache.stats.hits > 0


def test_mesh_engine_equals_flat_through_a_relayout(port, queries,
                                                    sample_probes, mesh):
    """prepare_layout builds the next placement's steps over its own
    placed shards; swap_layout installs them; a periodic re-layout in the
    background does the same."""
    flat, on_mesh = _pair(port, sample_probes, mesh, relayout_every=2,
                          extra=lambda: {"heat_estimator":
                                         OnlineHeatEstimator(port.nlist)})
    _same(flat, on_mesh, queries[:8])
    step, shards = on_mesh._step, on_mesh._shards
    heat = np.linspace(0.1, 3.0, port.nlist)
    for eng in (flat, on_mesh):
        eng.prepare_layout(heat)
        eng.swap_layout()
    assert on_mesh._step is not step and on_mesh._shards is not shards
    assert on_mesh._shards[0][0].data_ptr() == on_mesh.sindex.codes.data_ptr()
    _same(flat, on_mesh, queries)
    for lo in range(0, 48, 8):                # periodic re-layouts
        _same(flat, on_mesh, queries[lo:lo + 8])
    assert on_mesh.relayouts == flat.relayouts >= 2


def test_mesh_engine_equals_flat_through_generations(port, small_corpus,
                                                     queries, sample_probes,
                                                     mesh):
    """install_index and stage_index on new index generations (built
    from a subset of the points, and with another cluster count)."""
    points = torch.from_numpy(np.array(small_corpus.points))
    gens = [build_ivfpq(torch.Generator().manual_seed(s), points[:n],
                        nlist=nl, m=16, cb=256, kmeans_iters=3, pq_iters=3,
                        device="cpu")
            for s, n, nl in ((1, 6000, 64), (2, 7000, 48))]
    flat, on_mesh = _pair(port, sample_probes, mesh, cache=True)
    _same(flat, on_mesh, queries)
    for eng in (flat, on_mesh):
        eng.install_index(gens[0])
    _same(flat, on_mesh, queries)
    for eng in (flat, on_mesh):
        eng.stage_index(gens[1])
    _same(flat, on_mesh, queries)
    assert on_mesh.index is gens[1] and on_mesh.generations == 2


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_mesh_engine_equals_flat_tiered(port, queries, sample_probes, mesh,
                                        tmp_path, lut_dtype):
    """A tiered engine: the shards hold the resident clusters, the cold
    scan stays on the engine's device and joins the host merge."""
    _, cap, m = pad_clusters(port).codes.shape
    tiers = iter(TieredStore.from_index(port, tmp_path / name,
                                        budget_bytes=cap * (m + 4) * 16,
                                        device="cpu")
                 for name in ("flat", "mesh"))
    flat, on_mesh = _pair(port, sample_probes, mesh, lut_dtype=lut_dtype,
                          extra=lambda: {"tiered_store": next(tiers)})
    assert on_mesh._cold_mask.any() and on_mesh._cold_mask.sum() < port.nlist
    for _ in range(2):
        _same(flat, on_mesh, queries)


def test_mesh_engine_equals_flat_with_opq(small_corpus, queries, mesh):
    """OPQ: the rotation GEMM runs on fixed row blocks, so a task's
    rotated residual does not depend on how many tasks ride with it."""
    idx = build_ivfpq(torch.Generator().manual_seed(0),
                      torch.from_numpy(np.array(small_corpus.points)),
                      nlist=64, m=16, cb=256, kmeans_iters=3, pq_iters=3,
                      opq=True, device="cpu")
    assert idx.rotation is not None
    probes = ss.locate_probes(queries, idx.centroids, NPROBE)
    for dt in ("f32", "uint8"):
        flat, on_mesh = _pair(idx, probes, mesh, lut_dtype=dt)
        _same(flat, on_mesh, queries)


# ---------------------------------------------------------------------------
# The port's mesh engine against the reference's shard_map engine
# ---------------------------------------------------------------------------

REF_MESH_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np, jax.numpy as jnp
    from repro.core.ivf import IVFPQIndex
    from repro.core.pq import PQCodebook
    from repro.core.sharded_search import DistributedEngine, EngineConfig
    from repro.runtime import HotClusterLUTCache

    assert len(jax.devices()) == 8
    src = np.load(sys.argv[1])
    idx = IVFPQIndex(jnp.asarray(src["centroids"]),
                     PQCodebook(jnp.asarray(src["codebooks"]),
                                jnp.asarray(src["sqnorms"])),
                     jnp.asarray(src["codes"]), jnp.asarray(src["ids"]),
                     jnp.asarray(src["offsets"]))
    mesh = jax.make_mesh((8,), ("shards",))
    out = {}
    for dt in ("f32", "uint8"):
        for cache in ("off", "on"):
            for tps in (512, 24):
                cfg = EngineConfig(n_shards=8, nprobe=8, k=11,
                                   tasks_per_shard=tps, split_max=64,
                                   dup_budget_bytes=1 << 17,
                                   strategy="gather", lut_dtype=dt)
                lc = (HotClusterLUTCache(capacity=4096, lut_dtype=dt)
                      if cache == "on" else None)
                eng = DistributedEngine(idx, cfg, src["probes"], mesh=mesh,
                                        lut_cache=lc)
                for rep in range(2 if cache == "on" else 1):
                    d, i, info = eng.search(jnp.asarray(src["queries"]))
                    key = f"{dt}_{cache}_{tps}_{rep}"
                    out[key + "_d"] = np.asarray(d)
                    out[key + "_i"] = np.asarray(i)
                    out[key + "_rounds"] = np.asarray(info["rounds"])
    np.savez(sys.argv[2], **out)
    print("REF_MESH_OK")
""")


@pytest.fixture(scope="module")
def ref_mesh(small_index, queries, sample_probes, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_mesh")
    np.savez(d / "in.npz", centroids=np.asarray(small_index.centroids),
             codebooks=np.asarray(small_index.codebook.codebooks),
             sqnorms=np.asarray(small_index.codebook.sqnorms),
             codes=np.asarray(small_index.codes),
             ids=np.asarray(small_index.ids),
             offsets=np.asarray(small_index.offsets), queries=queries,
             probes=sample_probes)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_MESH_SCRIPT,
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert "REF_MESH_OK" in out.stdout, out.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("cache", ["off", "on"])
@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_mesh_engine_matches_reference_mesh(port, queries, sample_probes,
                                            mesh, small_corpus, ref_mesh,
                                            lut_dtype, cache):
    """Both engines at k = 11 (k prices the layout's latency model, so
    both place and schedule alike, flush rounds included); the first 10
    columns are held to the reference's 11."""
    gt = torch.from_numpy(np.array(small_corpus.groundtruth))
    for tps in (512, 24):
        lc = (HotClusterLUTCache(capacity=4096, lut_dtype=lut_dtype)
              if cache == "on" else None)
        eng = ss.DistributedEngine(port, _cfg(k=K + 1, tasks_per_shard=tps,
                                              lut_dtype=lut_dtype),
                                   sample_probes, mesh=mesh, lut_cache=lc)
        for rep in range(2 if cache == "on" else 1):
            key = f"{lut_dtype}_{cache}_{tps}_{rep}"
            rd, ri = ref_mesh[key + "_d"], ref_mesh[key + "_i"]
            pd, pi, info = eng.search(queries)
            pd, pi = pd[:, :K], pi[:, :K]
            assert info["rounds"] == int(ref_mesh[key + "_rounds"])
            assert (info["rounds"] > 1) == (tps == 24)
            if lut_dtype == "f32":
                np.testing.assert_allclose(pd, rd[:, :K], rtol=RTOL,
                                           atol=ATOL)
                assert_same_neighbours(pd, pi, rd, ri)
            else:
                mine = recall_at_k(torch.from_numpy(pi), gt)
                want = recall_at_k(torch.from_numpy(ri[:, :K]), gt)
                assert abs(mine - want) <= 0.01, (mine, want)
        if cache == "on":
            assert lc.stats.hits == len(queries) * NPROBE
