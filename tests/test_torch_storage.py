"""Port parity for tiered storage: the spill format, residency, the fetch
path, integrity, and the tiered local and sharded engines and service.

Both packages spill the same reference-built index (carried across by
``convert.py``).  Everything here runs on the CPU (the store's slab then
lives on the CPU; ``kernels.ops`` runs its plain versions).  The contract
held: the spill files are byte-equal and each package opens the other's;
the same probe stream leaves the same resident set and the same
``TierStats`` batch for batch; a tiered engine equals the port's
all-resident search bit for bit at every residency; against the
reference's tiered engines f32 distances are allclose at rtol 1e-4 / atol
1e-3 with id sets equal up to k-th-place ties, and uint8 is held by a
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
from repro.core import cluster_locate as ref_locate
from repro.core import sharded_search as ref_ss
from repro.runtime import LocalEngine as RefEngine
from repro.service import AnnService as RefService
from repro.service import ServiceSpec as RefSpec
from repro.storage import CorruptClusterError as RefCorruptClusterError
from repro.storage import TieredStore as RefTier
from repro.util import atomic_write_bytes as ref_atomic_write_bytes

from repro_torch.convert import index_from_numpy
from repro_torch.core import SearchParams, pad_clusters, search_ivfpq
from repro_torch.core import sharded_search as ss
from repro_torch.core.mutable_index import Index
from repro_torch.runtime import LocalEngine
from repro_torch.service import AnnService, ServiceSpec
from repro_torch.storage import (CorruptClusterError, TieredStore,
                                 TieredStoreError)
from repro_torch.util import atomic_write_bytes, atomic_write_text

from test_torch_search import assert_same_neighbours

torch.set_num_threads(1)
K, NPROBE = 10, 8
RTOL, ATOL = 1e-4, 1e-3

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


def _tier(port_index, d, budget, **kw):
    return TieredStore.from_index(port_index, d, budget_bytes=budget,
                                  device="cpu", **kw)


def _probes(small_index, queries, nprobe):
    p, _ = ref_locate(jnp.asarray(queries), small_index.centroids, nprobe)
    return np.asarray(p)


def _zipf_batches(n_queries, seed=0, n=512, batches=16):
    ranks = np.random.default_rng(seed).zipf(1.3, size=n)
    return np.array_split(ranks.clip(1, n_queries) - 1, batches)


def _host(out):
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in out]


# ---------------------------------------------------------------------------
# The spill format: byte-equal, and each package opens the other's
# ---------------------------------------------------------------------------

def test_spill_files_equal_the_reference(small_index, port_index, bpc,
                                         tmp_path):
    ref = RefTier.from_index(small_index, tmp_path / "ref",
                             budget_bytes=bpc * 5)
    port = _tier(port_index, tmp_path / "port", bpc * 5)
    for name in ("codes.u8", "ids.i32"):
        assert ((tmp_path / "ref" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    rm = json.loads((tmp_path / "ref" / "meta.json").read_text())
    pm = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert rm == pm
    assert (rm["codes_shape"], rm["sizes"]) == (
        [port.nlist, port.cap, port.m], port.sizes.tolist())
    np.testing.assert_array_equal(port.resident_mask, ref.resident_mask)
    assert (port.n_slots, port.bytes_per_cluster, port.total_bytes) == (
        ref.n_slots, ref.bytes_per_cluster, ref.total_bytes)


@pytest.mark.parametrize("budget_slots", [0, 7, 64])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_each_package_opens_the_others_spill(small_index, port_index,
                                             small_clusters, bpc, tmp_path,
                                             direction, budget_slots):
    budget = max(bpc * budget_slots, 1)
    if direction == "ref_to_port":
        RefTier.from_index(small_index, tmp_path, budget_bytes=1)
        store = TieredStore.open(tmp_path, budget_bytes=budget,
                                 device="cpu")
    else:
        _tier(port_index, tmp_path, 1)
        store = RefTier.open(tmp_path, budget_bytes=budget)
    out = _host(store.gather(np.arange(small_index.nlist)))
    for got, want in zip(out, small_clusters):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("budget", ["cold", "hot"])
def test_gather_equals_pad_clusters(port_index, tmp_path, budget):
    """Fully cold and fully hot tiers both gather pad_clusters' bytes, as
    device tensors, in any probe order with repeats."""
    cl = pad_clusters(port_index)
    tier = _tier(port_index, tmp_path, 1 if budget == "cold" else 1 << 30)
    cids = np.random.default_rng(1).integers(0, port_index.nlist, 300)
    codes, ids, sizes = tier.gather(cids)
    assert isinstance(codes, torch.Tensor) and codes.dtype == torch.uint8
    sel = torch.from_numpy(cids)
    assert torch.equal(codes, cl.codes[sel])
    assert torch.equal(ids, cl.ids[sel])
    assert torch.equal(sizes, cl.sizes[sel])


def test_open_rereads_spill_and_keeps_payload(port_index, tmp_path):
    t1 = _tier(port_index, tmp_path, 1)
    before = {n: (tmp_path / n).read_bytes()
              for n in ("codes.u8", "ids.i32", "meta.json")}
    c1 = _host(t1.gather(np.arange(port_index.nlist)))
    t2 = TieredStore.open(tmp_path, budget_bytes=1 << 30, device="cpu")
    c2 = _host(t2.gather(np.arange(port_index.nlist)))
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)
    for n, raw in before.items():
        assert (tmp_path / n).read_bytes() == raw, n


def test_atomic_write_helpers_match_the_reference(tmp_path):
    atomic_write_bytes(tmp_path / "p.bin", b"\x00\x01tier")
    ref_atomic_write_bytes(tmp_path / "r.bin", b"\x00\x01tier")
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "r.bin"
                                                 ).read_bytes()
    atomic_write_text(tmp_path / "t.json", "{}")
    assert (tmp_path / "t.json").read_text() == "{}"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "p.bin", "r.bin", "t.json"]                 # no tmp orphans


# ---------------------------------------------------------------------------
# Residency and counters, batch for batch against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_residency_and_stats_match_reference(small_index, port_index,
                                             queries, bpc, tmp_path, nprobe):
    ref = RefTier.from_index(small_index, tmp_path / "r",
                             budget_bytes=bpc * 13)
    port = _tier(port_index, tmp_path / "p", bpc * 13)
    probes = _probes(small_index, queries, nprobe)
    for batch in _zipf_batches(len(queries)):
        p = probes[batch]
        ref.observe(p)
        port.observe(p)
        np.testing.assert_array_equal(port.resident_mask, ref.resident_mask)
        rc = ref.gather(p.reshape(-1))
        pc = _host(port.gather(p.reshape(-1)))
        for a, b in zip(pc, rc):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert port.stats.as_dict() == ref.stats.as_dict()
        assert port.resident_bytes <= port.budget_bytes
    assert port.stats.promotions > 0 and port.stats.cold_fetches > 0
    assert port.serving_info() == {**ref.serving_info(),
                                   "hot_rate": port.serving_info()[
                                       "hot_rate"]}


@pytest.mark.parametrize("case", ["resident_only", "quarantined"])
def test_gather_degraded_matches_reference(small_index, port_index, queries,
                                           bpc, tmp_path, case):
    stores = [RefTier.from_index(small_index, tmp_path / "r",
                                 budget_bytes=bpc * 9),
              _tier(port_index, tmp_path / "p", bpc * 9)]
    probes = _probes(small_index, queries, NPROBE)[:16].reshape(-1)
    cold = int(np.nonzero(~stores[0].resident_mask[probes])[0][0])
    outs = []
    for st in stores:
        if case == "quarantined":
            st.corrupt_spill(int(probes[cold]))
            rep = st.verify(repair=True)
            assert rep["quarantined"] == [int(probes[cold])]
        codes, ids, sizes, dropped = st.gather_degraded(
            probes, resident_only=case == "resident_only")
        outs.append((_host((codes, ids, sizes)), dropped,
                     st.stats.as_dict()))
    (pc, pdrop, pst), (rc, rdrop, rst) = outs[1], outs[0]
    np.testing.assert_array_equal(pdrop, rdrop)
    assert pdrop[cold] and pst == rst and pst["dropped_probes"] > 0
    for a, b in zip(pc, rc):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (pc[2][pdrop] == 0).all() and (pc[1][pdrop] == -1).all()


def test_explicit_promote_demote_roundtrip(port_index, bpc, tmp_path):
    tier = _tier(port_index, tmp_path, bpc * 4)
    c = int(np.nonzero(~tier.resident_mask)[0][0])
    before = _host(tier.gather(np.array([c])))
    assert tier.promote(c) is False          # every slot is taken
    tier.demote(int(np.nonzero(tier.resident_mask)[0][0]))
    assert tier.promote(c) and bool(tier.resident_mask[c])
    mid = _host(tier.gather(np.array([c])))
    assert tier.demote(c) and not bool(tier.resident_mask[c])
    after = _host(tier.gather(np.array([c])))
    for a, b, d in zip(before, mid, after):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, d)


def test_budget_never_exceeded_under_zipf(port_index, queries, tmp_path):
    total = _tier(port_index, tmp_path / "probe", 1).total_bytes
    tier = _tier(port_index, tmp_path / "z", total // 5)
    assert tier.total_bytes >= 4 * tier.budget_bytes
    eng = LocalEngine(port_index, None, SearchParams(nprobe=8, k=K),
                      tiered_store=tier)
    for batch in _zipf_batches(len(queries)):
        eng.search_batch(queries[batch])
        assert tier.resident_bytes <= tier.budget_bytes
    st = tier.stats
    assert st.promotions >= 1 and st.hot_hits > 0 and st.cold_fetches > 0
    assert 0.0 < st.hot_rate < 1.0


def test_heat_estimator_drives_promotion(port_index, bpc, tmp_path):
    tier = _tier(port_index, tmp_path, bpc * 2)
    for _ in range(6):
        tier.observe(np.array([[3, 5]] * 8))
    assert bool(tier.resident_mask[3]) and bool(tier.resident_mask[5])
    tier.observe(np.array([[7, 9]]))   # one lukewarm batch: no displace
    assert bool(tier.resident_mask[3]) and bool(tier.resident_mask[5])


# ---------------------------------------------------------------------------
# Damage: open fails loudly by name, never serves silently-wrong bytes
# ---------------------------------------------------------------------------

@pytest.fixture
def spilled(port_index, tmp_path):
    _tier(port_index, tmp_path, 1)
    return tmp_path


def _open(d, **kw):
    return TieredStore.open(d, budget_bytes=1, device="cpu", **kw)


@pytest.mark.parametrize("name,cut", [("codes.u8", 7), ("ids.i32", 4)])
def test_open_rejects_truncated_payload(spilled, name, cut):
    f = spilled / name
    f.write_bytes(f.read_bytes()[:-cut])
    with pytest.raises(TieredStoreError, match="truncated"):
        _open(spilled)


def test_open_rejects_missing_meta(spilled):
    (spilled / "meta.json").unlink()
    with pytest.raises(TieredStoreError, match="missing"):
        _open(spilled)


def test_open_rejects_meta_shape_mismatch(spilled):
    meta = json.loads((spilled / "meta.json").read_text())
    meta["codes_shape"][0] += 1                 # one phantom cluster
    (spilled / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(TieredStoreError, match="clusters"):
        _open(spilled)


def test_open_rejects_flipped_payload_byte(spilled):
    meta = json.loads((spilled / "meta.json").read_text())
    _, cap, m = meta["codes_shape"]
    raw = bytearray((spilled / "codes.u8").read_bytes())
    raw[2 * cap * m + 3] ^= 0xFF
    (spilled / "codes.u8").write_bytes(bytes(raw))
    with pytest.raises(CorruptClusterError) as ei:
        _open(spilled)
    assert ei.value.cluster == 2
    with pytest.raises(RefCorruptClusterError) as ei:   # the reference too
        RefTier.open(spilled, budget_bytes=1)
    assert ei.value.cluster == 2
    # with checksums off the same dir opens: the verification is the
    # checksum pass, not a side effect of mapping
    _open(spilled, checksum=False)


def test_corrupt_spill_quarantine_and_rebuild(port_index, bpc, tmp_path):
    tier = _tier(port_index, tmp_path, bpc * 4)
    c = int(np.nonzero(tier.resident_mask)[0][0])
    want = _host(tier.gather(np.array([c])))
    tier.corrupt_spill(c)
    rep = tier.verify(repair=True)
    assert c in rep["corrupt"] and c in rep["rebuilt"]
    assert not rep["quarantined"]
    tier.demote(c)                      # now served from the spill again
    got = _host(tier.gather(np.array([c])))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert tier.stats.rebuilds == 1


def test_demotion_rebuilds_rotted_spill(port_index, bpc, tmp_path):
    tier = _tier(port_index, tmp_path, bpc * 4)
    c = int(np.nonzero(tier.resident_mask)[0][0])
    tier.corrupt_spill(c)
    assert tier.demote(c)
    assert tier.stats.rebuilds == 1 and tier.stats.crc_failures == 1
    assert tier.verify()["corrupt"] == []


def test_corrupt_cold_cluster_quarantined(port_index, tmp_path):
    tier = _tier(port_index, tmp_path, 1)
    tier.corrupt_spill(3)
    rep = tier.verify(repair=True)
    assert 3 in rep["quarantined"] and not rep["rebuilt"]
    with pytest.raises(CorruptClusterError) as ei:
        tier.gather(np.array([3]))
    assert ei.value.cluster == 3


def test_cold_fetch_names_the_rotten_cluster(port_index, tmp_path):
    """Without a scrub, the strict gather's CRC check catches the rot on
    the fetch itself and names the cluster; the degraded gather drops
    it."""
    tier = _tier(port_index, tmp_path, 1)
    tier.corrupt_spill(5)
    with pytest.raises(CorruptClusterError) as ei:
        tier.gather(np.array([1, 5, 5]))
    assert ei.value.cluster == 5 and 5 in tier.quarantined
    _, ids, sizes, dropped = tier.gather_degraded(np.array([1, 5, 5]))
    assert dropped.tolist() == [False, True, True]
    assert sizes[1:].tolist() == [0, 0] and bool((ids[1:] == -1).all())


def test_promote_refuses_corrupt_cold_cluster(port_index, bpc, tmp_path):
    tier = _tier(port_index, tmp_path, bpc * 4)
    c = int(np.nonzero(~tier.resident_mask)[0][0])
    tier.corrupt_spill(c)
    tier.demote(int(np.nonzero(tier.resident_mask)[0][0]))   # free a slot
    fails0 = tier.stats.crc_failures
    assert not tier.promote(c)
    assert tier.stats.crc_failures == fails0 + 1
    assert c in tier.quarantined and not tier.resident_mask[c]
    _, _, sizes, dropped = tier.gather_degraded(np.array([c]))
    assert dropped[0] and int(sizes[0]) == 0
    assert not tier.promote(c)


def test_rewrite_refuses_corrupt_slab_copy(port_index, bpc, tmp_path):
    tier = _tier(port_index, tmp_path, bpc * 4)
    for heal in ("verify", "demote"):
        c = int(np.nonzero(tier.resident_mask)[0][0])
        tier.corrupt_spill(c)                   # spill rotten...
        tier._hot_codes[int(tier._slot_of[c])][0, 0] ^= 0xFF   # ...slab too
        rebuilds0 = tier.stats.rebuilds
        if heal == "verify":
            rep = tier.verify(repair=True)
            assert c in rep["corrupt"] and c not in rep["rebuilt"]
            assert c in rep["quarantined"]
        else:
            assert tier.demote(c)
        assert tier.stats.rebuilds == rebuilds0        # no fake heal
        assert c in tier.quarantined and not tier.resident_mask[c]
        _, _, sizes, dropped = tier.gather_degraded(np.array([c]))
        assert dropped[0] and int(sizes[0]) == 0


def test_chaos_hooks_wait_for_item_9(port_index, bpc, tmp_path):
    """Formerly the refusal of ``faults`` (item 9, now ported): the tier
    takes an injector; a cold-read firing raises IOError from a strict
    gather and drops the cold rows of a degraded one, and resident rows
    are served all the same."""
    from repro_torch.runtime import (FaultInjector, FaultPlan, FaultRule,
                                     InjectedFault)
    cl = pad_clusters(port_index)
    tier = _tier(port_index, tmp_path, bpc * 4)
    assert tier.faults is None
    tier.faults = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("tier.cold_read", rate=1.0, count=2),)))
    hot = int(np.nonzero(tier.resident_mask)[0][0])
    cold = int(np.nonzero(~tier.resident_mask)[0][0])
    with pytest.raises(IOError, match="injected fault at tier.cold_read") \
            as err:
        tier.gather([hot, cold])
    assert isinstance(err.value, InjectedFault)
    codes, ids, sizes, dropped = tier.gather_degraded([hot, cold])
    assert dropped.tolist() == [False, True]
    assert torch.equal(codes[0], cl.codes[hot])
    assert torch.equal(ids[0], cl.ids[hot])
    assert int(sizes[1]) == 0 and int(codes[1].abs().sum()) == 0
    assert bool((ids[1] == -1).all())
    assert tier.stats.dropped_probes == 1
    assert tier.faults.stats() == {"tier.cold_read": {"consultations": 2,
                                                      "fires": 2}}
    assert torch.equal(tier.gather([cold])[0][0], cl.codes[cold])
    tier.faults = None
    assert torch.equal(tier.gather([cold])[1][0], cl.ids[cold])


def test_tiered_handle_contract(port_index, tmp_path):
    h = Index(port_index, storage="tiered", storage_dir=tmp_path,
              storage_budget_bytes=1 << 14)
    assert h.tiered_store is not None and len(h) == 8000
    assert h.ivf.codes.shape[0] == 0 and h.sizes.sum() == 8000
    assert int(port_index.ids[0]) in h and -5 not in h
    with pytest.raises(RuntimeError, match="tiered"):
        h.clusters
    for kw, match in ((dict(mutable=True, points=np.zeros((1, 1))),
                       "static"),
                      (dict(storage_dir=None), "storage_dir"),
                      (dict(storage_budget_bytes=0), "storage_budget_bytes"),
                      (dict(storage="cloud"), "storage")):
        args = dict(storage="tiered", storage_dir=tmp_path / "x",
                    storage_budget_bytes=1 << 14)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            Index(port_index, **args)
    wide = port_index._replace(codes=port_index.codes.int())
    with pytest.raises(ValueError, match="uint8"):
        Index(wide, storage="tiered", storage_dir=tmp_path / "w",
              storage_budget_bytes=1 << 14)


# ---------------------------------------------------------------------------
# The tiered engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
@pytest.mark.parametrize("slots", [0, 1, 13, 40, 64])
def test_tiered_engine_equals_resident_search(port_index, queries, bpc,
                                              tmp_path, lut_dtype, slots):
    p = SearchParams(nprobe=NPROBE, k=K, use_kernels=True,
                     lut_dtype=lut_dtype, query_chunk=24)
    cl = pad_clusters(port_index)
    sd, si = (x.numpy() for x in search_ivfpq(
        port_index, cl, torch.from_numpy(queries), p))
    tier = _tier(port_index, tmp_path, max(bpc * slots, 1))
    eng = LocalEngine(port_index, None, p, tiered_store=tier)
    # every query, then three Zipf draws, each under its own permutation:
    # each moves the hot set, so each is checked at a residency of its own
    streams = [np.arange(len(queries))] + [
        np.random.default_rng(seed).permutation(len(queries))[b]
        for seed, b in enumerate(_zipf_batches(len(queries), batches=3), 1)]
    for r, rows in enumerate(streams):
        td, ti = eng.search_batch(queries[rows])
        np.testing.assert_array_equal(ti, si[rows])
        np.testing.assert_array_equal(td, sd[rows])
        if r == 0:
            moved = tier.stats.promotions, tier.stats.demotions
    if slots in (13, 40):     # the draws moved residency (with one slot,
        # the hottest cluster stays the hottest under every draw here)
        assert tier.stats.promotions > moved[0]
        assert tier.stats.demotions > moved[1]
    assert eng.serving_info()["tier"]["n_slots"] == min(slots, 64)


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_tiered_engine_matches_reference(small_index, port_index, queries,
                                         small_corpus, bpc, tmp_path,
                                         lut_dtype):
    ref_tier = RefTier.from_index(small_index, tmp_path / "r",
                                  budget_bytes=bpc * 13)
    tier = _tier(port_index, tmp_path / "p", bpc * 13)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = RefEngine(small_index, None, RefParams(
            nprobe=NPROBE, k=K + 1, lut_dtype=lut_dtype),
            tiered_store=ref_tier)
    eng = LocalEngine(port_index, None, SearchParams(
        nprobe=NPROBE, k=K, use_kernels=True, lut_dtype=lut_dtype),
        tiered_store=tier)
    for _ in range(3):
        rd, ri = ref.search_batch(queries)
        pd, pi = eng.search_batch(queries)
        np.testing.assert_array_equal(tier.resident_mask,
                                      ref_tier.resident_mask)
    if lut_dtype == "f32":
        np.testing.assert_allclose(pd, rd[:, :K], rtol=RTOL, atol=ATOL)
        assert_same_neighbours(pd, pi, rd, ri)
    else:
        gt = np.asarray(small_corpus.groundtruth)[:, :K]
        rec = [np.mean([len(set(a[:K]) & set(g)) / K
                        for a, g in zip(ids, gt)]) for ids in (pi, ri)]
        assert abs(rec[0] - rec[1]) <= 0.01, rec


def test_budget_pressure_degrades_exactly(port_index, queries, bpc,
                                          tmp_path):
    """``budget_s=0`` sheds every cold probe: the batch is reported
    degraded, and its results equal the resident search over the
    clusters with the cold ones emptied (size 0, ids -1: what the tier
    hands the scan for a dropped probe)."""
    p = SearchParams(nprobe=NPROBE, k=K, use_kernels=True)
    tier = _tier(port_index, tmp_path, bpc * 13)
    eng = LocalEngine(port_index, None, p, tiered_store=tier)
    d, i = eng.search_batch(queries, budget_s=0.0)
    info = eng.last_batch_info
    assert info["degraded"] and info["dropped_probes"] > 0
    cl = pad_clusters(port_index)
    cold = torch.from_numpy(~tier.resident_mask)
    masked = cl._replace(sizes=cl.sizes.masked_fill(cold, 0),
                         ids=cl.ids.masked_fill(cold[:, None], -1))
    md, mi = search_ivfpq(port_index, masked, torch.from_numpy(queries), p)
    np.testing.assert_array_equal(d, md.numpy())
    np.testing.assert_array_equal(i, mi.numpy())
    eng.search_batch(queries, budget_s=10.0)      # ample: not degraded
    assert eng.last_batch_info == {"degraded": False, "dropped_probes": 0}


@pytest.mark.parametrize("lut_dtype", ["f32", "uint8"])
def test_tiered_sharded_engine_matches_reference(small_index, port_index,
                                                 queries, bpc, tmp_path,
                                                 lut_dtype):
    probes = _probes(small_index, queries, NPROBE)
    ref_tier = RefTier.from_index(small_index, tmp_path / "r",
                                  budget_bytes=bpc * 16)
    tier = _tier(port_index, tmp_path / "p", bpc * 16)
    kw = dict(n_shards=4, nprobe=NPROBE, tasks_per_shard=512,
              strategy="gather", lut_dtype=lut_dtype)
    ref = ref_ss.DistributedEngine(small_index, ref_ss.EngineConfig(
        k=K + 1, **kw), probes, tiered_store=ref_tier)
    eng = ss.DistributedEngine(port_index, ss.EngineConfig(k=K, **kw),
                               probes, tiered_store=tier)
    np.testing.assert_array_equal(eng._cold_mask, ref._cold_mask)
    rd, ri, _ = ref.search(jnp.asarray(queries))
    pd, pi, _ = eng.search(queries)
    rd, ri = np.asarray(rd), np.asarray(ri)
    assert eng.serving_info()["tier"] == ref.serving_info()["tier"]
    if lut_dtype == "f32":
        np.testing.assert_allclose(pd, rd[:, :K], rtol=RTOL, atol=ATOL)
        assert_same_neighbours(pd, pi, rd, ri)
    # the tiered sharded engine equals the port's tiered local engine
    local = LocalEngine(port_index, None, SearchParams(
        nprobe=NPROBE, k=K, use_kernels=True, lut_dtype=lut_dtype),
        tiered_store=_tier(port_index, tmp_path / "l", bpc * 16))
    ld, li = local.search_batch(queries)
    np.testing.assert_allclose(pd, ld, rtol=RTOL, atol=ATOL)
    assert_same_neighbours(pd, pi, np.pad(ld, ((0, 0), (0, 1)),
                                          constant_values=np.inf),
                           np.pad(li, ((0, 0), (0, 1))))


def test_tiered_sharded_degrades_and_caches(port_index, queries, bpc,
                                            tmp_path):
    from repro_torch.runtime import HotClusterLUTCache
    probes = ss.locate_probes(queries, port_index.centroids, NPROBE)
    cfg = ss.EngineConfig(n_shards=4, nprobe=NPROBE, k=K,
                          tasks_per_shard=512)
    plain = ss.DistributedEngine(port_index, cfg, probes,
                                 tiered_store=_tier(port_index,
                                                    tmp_path / "a", bpc * 9))
    cached = ss.DistributedEngine(
        port_index, cfg, probes, lut_cache=HotClusterLUTCache(capacity=4096),
        tiered_store=_tier(port_index, tmp_path / "b", bpc * 9))
    pd, pi, _ = plain.search(queries)
    cd, ci, _ = cached.search(queries)
    np.testing.assert_array_equal(pi, ci)
    np.testing.assert_allclose(pd, cd, rtol=RTOL, atol=ATOL)
    plain.search(queries, budget_s=0.0)
    assert plain.last_batch_info["degraded"]
    plain.search(queries)
    assert not plain.last_batch_info["degraded"]
    # padding rows get no cold scan: they neither shed nor degrade; the
    # shed probes are the valid rows' snapshot-cold ones that the tier
    # does not hold after the batch's own observe
    nv = len(queries) // 2
    plain.search(queries, n_valid=nv, budget_s=0.0)
    shed = (plain._cold_mask[probes[:nv]]
            & ~plain.tiered_store.resident_mask[probes[:nv]])
    assert plain.last_batch_info == {
        "degraded": True, "dropped_probes": int(shed.sum())}
    plain.search(queries, n_valid=0, budget_s=0.0)
    assert plain.last_batch_info == {"degraded": False, "dropped_probes": 0}


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

def _spec_kw(**kw):
    base = dict(nprobe=NPROBE, k=K, buckets=(1, 2, 4), max_wait_s=1e-3)
    base.update(kw)
    return base


@pytest.mark.parametrize("engine", ["local", "sharded"])
def test_tiered_service_equals_resident(port_index, queries, tmp_path,
                                        engine):
    extra = dict(n_shards=4) if engine == "sharded" else {}
    resident = AnnService.build(ServiceSpec(**_spec_kw(engine=engine,
                                                       **extra)),
                                index=port_index, sample_queries=queries)
    rd, ri = resident.search(queries)
    resident.shutdown()
    budget = _tier(port_index, tmp_path / "probe", 1).total_bytes // 4
    svc = AnnService.build(ServiceSpec(**_spec_kw(
        engine=engine, storage="tiered", storage_budget_bytes=budget,
        storage_dir=str(tmp_path / "spill"), **extra)),
        index=port_index, sample_queries=queries)
    for _ in range(3):
        td, ti = svc.search(queries)
        if engine == "local":          # the same search, bit for bit
            np.testing.assert_array_equal(ti, ri)
            np.testing.assert_array_equal(td, rd)
        else:
            np.testing.assert_allclose(td, rd, rtol=RTOL, atol=ATOL)
            assert_same_neighbours(td, ti, np.pad(rd, ((0, 0), (0, 1)),
                                                  constant_values=np.inf),
                                   np.pad(ri, ((0, 0), (0, 1))))
    st = svc.stats()["tier"]
    assert st["resident_bytes"] <= budget and st["cold_fetches"] > 0
    assert (tmp_path / "spill" / "meta.json").exists()
    # a prebuilt handle must match the spec's storage
    with pytest.raises(ValueError, match="storage"):
        AnnService.build(ServiceSpec(**_spec_kw(engine=engine, **extra)),
                         index=svc.index, sample_queries=queries)
    svc.shutdown()


def test_tiered_service_stream_and_deadline(port_index, queries, tmp_path):
    """Streamed requests on the tiered service equal a direct batch; with
    a deadline too tight for any cold read the batches are degraded and
    counted as such."""
    budget = _tier(port_index, tmp_path / "probe", 1).total_bytes // 4
    spec = ServiceSpec(**_spec_kw(engine="local", storage="tiered",
                                  storage_budget_bytes=budget))
    svc = AnnService.build(spec, index=port_index)
    _, direct = svc.search(queries)
    reqs = svc.stream([(j * 5e-4, queries[j % 16]) for j in range(32)])
    for j, r in enumerate(reqs):
        np.testing.assert_array_equal(r.ids, direct[j % 16])
    assert svc.stats()["aggregate"]["requests"] == 32
    spill = svc.index.tiered_store.dir
    assert (spill / "meta.json").exists()
    svc.shutdown()              # the service made the spill: it removes it
    assert not spill.exists()
    tight = AnnService.build(ServiceSpec(**_spec_kw(
        engine="local", storage="tiered", storage_budget_bytes=budget,
        deadline_ms=1e-6)), index=port_index)
    reqs = tight.stream([(j * 5e-4, queries[j]) for j in range(16)],
                        clock="wall")
    rep = tight.stats()["replicas"][0]
    # a batch is degraded when it had cold probes to shed
    assert 0 < rep["degraded_requests"] == sum(r.degraded for r in reqs)
    assert rep["deadline_missed"] == len(reqs)
    assert [r.future.timing()["degraded"] for r in reqs] == [
        r.degraded for r in reqs]
    tight.shutdown()


@pytest.mark.parametrize("spec_kw", [
    dict(storage="tiered"),
    dict(storage="tiered", pim_paced_ranks=64),
])
def test_tiered_spec_matches_reference_build(small_index, port_index,
                                             queries, tmp_path, spec_kw):
    """The same tiered spec stands up in both packages with the same tier
    (shape, budget, residency) and, when PIM-paced, the same modeled
    per-task latency (the cold-probe prior included)."""
    kw = _spec_kw(engine="local", storage_budget_bytes=1 << 15, **spec_kw)
    ref = RefService.build(RefSpec(storage_dir=str(tmp_path / "r"), **kw),
                           index=small_index)
    port = AnnService.build(ServiceSpec(storage_dir=str(tmp_path / "p"),
                                        **kw), index=port_index)
    rt, pt = ref.index.tiered_store, port.index.tiered_store
    assert (pt.n_slots, pt.total_bytes) == (rt.n_slots, rt.total_bytes)
    np.testing.assert_array_equal(pt.resident_mask, rt.resident_mask)
    if "pim_paced_ranks" in spec_kw:
        assert port.replicas[0].runtime.engine.task_latency_s == \
            pytest.approx(ref.replicas[0].runtime.engine.task_latency_s,
                          rel=1e-12)
    ref.shutdown()
    port.shutdown()


# ---------------------------------------------------------------------------
# Threads: a slab gather never sees a slot another thread is rewriting
# ---------------------------------------------------------------------------

def test_two_threads_share_one_slab(port_index, bpc, tmp_path):
    """One thread gathers a fixed probe list over and over while another
    churns residency (promotions and demotions rewrite slab slots); every
    gather must still equal pad_clusters' rows (on the card the lock plus
    the stream synchronisation before it is released make this hold)."""
    cl = pad_clusters(port_index)
    tier = _tier(port_index, tmp_path, bpc * 6)
    cids = np.arange(port_index.nlist)[::3]
    want = [x[torch.from_numpy(cids)] for x in cl]
    stop, errors = threading.Event(), []

    def churn():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            tier.observe(rng.integers(0, port_index.nlist, (4, 8)))

    t = threading.Thread(target=churn)
    t.start()
    try:
        for _ in range(60):
            got = tier.gather(cids)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                errors.append("torn gather")
    finally:
        stop.set()
        t.join()
    assert not errors
    assert tier.stats.promotions > 0 and tier.stats.demotions > 0
