"""The bf16-table search step against the reference, on the CPU.

The reference's ``_shard_tasks_fn(..., lut_dtype=jnp.bfloat16)`` casts
the f32 LUT to bf16 and sums each row's bf16 gather with ``jnp.sum``,
which gives ``bf16_rne(sum of the f32-widened entries)``.  The port's
``_shard_tasks_fn(..., lut_dtype="bf16")`` builds the bf16 table with
``ops.lut_build_bf16`` and scans it with ``ops.pq_scan_topk``; on CPU
tensors both run their plain versions (``build_lut_batch`` cast to bf16,
``adc.scan_codes``'s bf16 branch).  The f32 sums may be taken in another
order and the f32 tables may differ in the last bit, so a distance may
round to a neighbouring bf16 value.  The rule: every distance within
2^-8 of the reference's (``|a - b| <= 2^-8 |b|``, about one bf16 ulp),
at least 99% of them bit-equal, and each task's ids below its k-th
distance equal as sets.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as ref_adc
from repro.core import sharded_search as ref_ss
from repro.core.pq import PQCodebook as RefPQCodebook
from repro.core.search import cluster_locate as ref_locate
from repro.core.ivf import pad_clusters as ref_pad_clusters

from repro_torch.core import adc
from repro_torch.core import sharded_search as ss
from repro_torch.core.pq import PQCodebook
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, roofline

torch.set_num_threads(1)
ULP = 2.0 ** -8                 # one bf16 ulp, relative
K = 10


def _small_step_inputs(seed=0, slots=16, c=256, m=8, cb=64, d=32, t=128,
                       nq=24, nlist=12):
    """numpy inputs of one step: ``slots`` code slots of C rows (ragged
    sizes, one empty), T tasks (-1 padding among them)."""
    rng = np.random.default_rng(seed)
    books = rng.normal(size=(m, cb, d // m)).astype(np.float32)
    sizes = rng.integers(1, c + 1, size=slots).astype(np.int32)
    sizes[3] = 0
    sizes[5] = 7                                   # fewer rows than k
    qidx = rng.integers(0, nq, size=t).astype(np.int32)
    qidx[-5:] = -1
    return {
        "codes": rng.integers(0, cb, size=(slots, c, m)).astype(np.uint8),
        "ids": rng.permutation(slots * c).astype(np.int32).reshape(slots, c),
        "sizes": sizes,
        "cluster_of": rng.integers(0, nlist, size=slots).astype(np.int32),
        "qidx": qidx,
        "sidx": rng.integers(0, slots, size=t).astype(np.int32),
        "queries": (rng.normal(size=(nq, d)) * 3).astype(np.float32),
        "centroids": (rng.normal(size=(nlist, d)) * 3).astype(np.float32),
        "books": books,
        "sqnorms": (books * books).sum(-1),
    }


_ORDER = ("codes", "ids", "sizes", "cluster_of", "qidx", "sidx", "queries",
          "centroids")


def _ref_step(inp, k, fused, lut_dtype):
    args = [jnp.asarray(inp[n]) for n in _ORDER]
    cbk = RefPQCodebook(jnp.asarray(inp["books"]), jnp.asarray(inp["sqnorms"]))
    bd, bi = ref_ss._shard_tasks_fn(*args, cbk, None, k=k, strategy="gather",
                                    use_kernels=False, fused_scan=fused,
                                    lut_dtype=lut_dtype)
    return np.asarray(bd, np.float32), np.asarray(bi)


def _port_step(inp, k, lut_dtype):
    args = [torch.from_numpy(inp[n]) for n in _ORDER]
    cbk = PQCodebook(torch.from_numpy(inp["books"]),
                     torch.from_numpy(inp["sqnorms"]))
    bd, bi = ss._shard_tasks_fn(*args, cbk, None, k=k, strategy="gather",
                                lut_dtype=lut_dtype)
    return bd.numpy(), bi.numpy()


def assert_bf16_rule(got, want, min_equal=0.99):
    """Distances within one bf16 ulp with equal +inf masks, and at least
    ``min_equal`` of the finite ones bit-equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    g, w = got[~inf], want[~inf]
    assert (np.abs(g - w) <= ULP * np.abs(w)).all(), \
        float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
    assert np.mean(g == w) >= min_equal, np.mean(g == w)


def assert_same_ids_below_kth(gd, gi, wd, wi):
    """Per task: the ids whose distance lies below both sides' k-th
    distance less one bf16 ulp are the same set; -1 exactly at +inf."""
    assert (gi[np.isinf(gd)] == -1).all() and (gi[~np.isinf(gd)] >= 0).all()
    for t in range(gd.shape[0]):
        thr = min(gd[t, -1], wd[t, -1])
        thr = thr * (1 - ULP) if np.isfinite(thr) else np.inf
        got = set(gi[t][gd[t] < thr].tolist())
        want = set(wi[t][wd[t] < thr].tolist())
        assert got == want, t


# (a) the step, both of the reference's dataflows ---------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_step_matches_reference(fused, seed):
    inp = _small_step_inputs(seed)
    wd, wi = _ref_step(inp, K, fused, jnp.bfloat16)
    ops.reset_launches()
    gd, gi = _port_step(inp, K, "bf16")
    assert all(v == 0 for v in ops.launches.values())    # CPU: plain runs
    assert gd.shape == (128, K) and gi.dtype == np.int32
    assert_bf16_rule(gd, wd)
    assert_same_ids_below_kth(gd, gi, wd, wi)
    assert np.isinf(gd[inp["qidx"] < 0]).all()           # padding tasks


@pytest.mark.parametrize("lut_dtype", ["bf16", torch.bfloat16])
def test_bf16_step_spellings_agree(lut_dtype):
    """``lut_dtype="bf16"`` and ``torch.bfloat16`` name the same step;
    the bf16 distances are bf16 values and differ from the f32 step's."""
    inp = _small_step_inputs(2)
    gd, gi = _port_step(inp, K, lut_dtype)
    bd, bi = _port_step(inp, K, "bf16")
    assert np.array_equal(gd, bd) and np.array_equal(gi, bi)
    fin = np.isfinite(gd)
    assert np.array_equal(
        torch.from_numpy(gd[fin]).to(torch.bfloat16).float().numpy(),
        gd[fin])
    fd, _ = _port_step(inp, K, None)
    assert not np.array_equal(fd, gd)


def test_step_lut_dtype_f32_and_uint8_unchanged():
    """``lut_dtype`` None / "f32" is the f32 step and "uint8" the
    quantized one, bit for bit."""
    inp = _small_step_inputs(3)
    f32, named = _port_step(inp, K, None), _port_step(inp, K, "f32")
    assert all(np.array_equal(a, b) for a, b in zip(f32, named))
    args = [torch.from_numpy(inp[n]) for n in _ORDER]
    cbk = PQCodebook(torch.from_numpy(inp["books"]),
                     torch.from_numpy(inp["sqnorms"]))
    q1 = ss._shard_tasks_fn(*args, cbk, None, k=K, strategy="gather",
                            quantize=True)
    q2 = ss._shard_tasks_fn(*args, cbk, None, k=K, strategy="gather",
                            lut_dtype="uint8")
    assert all(torch.equal(a, b) for a, b in zip(q1, q2))
    with pytest.raises(ValueError, match="lut_dtype"):
        _port_step(inp, K, "f16")


# (b) the plain DC on the reference's own bf16 table -------------------------

@pytest.mark.parametrize("with_sizes", [True, False])
def test_bf16_dc_on_the_reference_table(with_sizes):
    inp = _small_step_inputs(4)
    rng = np.random.default_rng(5)
    t, c = 64, 256
    res = rng.normal(size=(t, 32)).astype(np.float32) * 3
    codes = rng.integers(0, 64, size=(t, c, 8)).astype(np.uint8)
    sizes = rng.integers(0, c + 1, size=t).astype(np.int32)
    cbk = RefPQCodebook(jnp.asarray(inp["books"]),
                        jnp.asarray(inp["sqnorms"]))
    ref_lut = ref_adc.build_lut_batch(cbk, jnp.asarray(res)).astype(
        jnp.bfloat16)
    sz = jnp.asarray(sizes) if with_sizes else None
    want = np.asarray(ref_adc.adc_distances(ref_lut, jnp.asarray(codes), sz,
                                            "gather"), np.float32)
    # the reference's table through numpy as f32 values, exact in bf16
    lut = torch.from_numpy(np.asarray(ref_lut, np.float32)).to(torch.bfloat16)
    assert torch.equal(lut.float(),
                       torch.from_numpy(np.asarray(ref_lut, np.float32)))
    got = ops.pq_scan_dc(lut, torch.from_numpy(codes),
                         torch.from_numpy(sizes) if with_sizes else None)
    assert got.dtype == torch.float32
    assert_bf16_rule(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          adc.adc_distances(lut, torch.from_numpy(codes),
                                            torch.from_numpy(sizes)
                                            if with_sizes else None).numpy())


def test_bf16_scan_rounds_the_f32_sum_once():
    """The plain bf16 DC is bf16_rne of the f32 sum in order m = 0..M-1,
    not a sum of bf16 partial sums."""
    rng = np.random.default_rng(6)
    lut = torch.from_numpy(rng.uniform(0, 50, size=(8, 16, 32))
                           .astype(np.float32)).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, 32, size=(8, 100, 16))
                             .astype(np.uint8))
    got = adc.scan_codes(lut, codes)
    g = torch.gather(lut.float(), 2, codes.transpose(1, 2).long())
    acc = torch.zeros(8, 100)
    for m in range(16):
        acc = acc + g[:, m]
    assert torch.equal(got, acc.to(torch.bfloat16).float())
    partial = g[:, 0].to(torch.bfloat16)
    for m in range(1, 16):
        partial = partial + g[:, m].to(torch.bfloat16)
    assert not torch.equal(got, partial.float())


# (c) the bf16 LC entries ---------------------------------------------------

def test_bf16_lut_entries_match_reference():
    inp = _small_step_inputs(7)
    res = np.random.default_rng(8).normal(size=(128, 32)).astype(
        np.float32) * 3
    cbk = RefPQCodebook(jnp.asarray(inp["books"]),
                        jnp.asarray(inp["sqnorms"]))
    want = np.asarray(ref_adc.build_lut_batch(cbk, jnp.asarray(res))
                      .astype(jnp.bfloat16), np.float32)
    got = ops.lut_build_bf16(torch.from_numpy(res),
                             torch.from_numpy(inp["books"]),
                             torch.from_numpy(inp["sqnorms"]))
    assert got.dtype == torch.bfloat16 and got.shape == (128, 8, 64)
    assert_bf16_rule(got.float().numpy(), want)
    f32 = ops.lut_build(torch.from_numpy(res), torch.from_numpy(inp["books"]),
                        torch.from_numpy(inp["sqnorms"]))
    assert torch.equal(got, f32.to(torch.bfloat16))


# (d) recall on a reference-built index ------------------------------------

def _recall(found, gt):
    return float(np.mean([len(set(f.tolist()) & set(g.tolist())) / K
                          for f, g in zip(found, gt)]))


def _merge(bd, bi, nq, nprobe):
    """One task per (query, probe) -> each query's k best."""
    d = bd.reshape(nq, nprobe * K)
    i = bi.reshape(nq, nprobe * K)
    order = np.argsort(d, axis=1, kind="stable")[:, :K]
    return np.take_along_axis(i, order, 1)


@pytest.fixture(scope="module")
def recall_inputs(small_index, small_corpus):
    cl = ref_pad_clusters(small_index)
    queries = np.array(small_corpus.queries, np.float32)
    nprobe = 16
    probes = np.asarray(ref_locate(jnp.asarray(queries),
                                   small_index.centroids, nprobe)[0])
    nq = queries.shape[0]
    return {
        "codes": np.array(cl.codes), "ids": np.array(cl.ids),
        "sizes": np.array(cl.sizes),
        "cluster_of": np.arange(cl.codes.shape[0], dtype=np.int32),
        "qidx": np.repeat(np.arange(nq, dtype=np.int32), nprobe),
        "sidx": probes.reshape(-1).astype(np.int32),
        "queries": queries,
        "centroids": np.asarray(small_index.centroids, np.float32),
        "books": np.asarray(small_index.codebook.codebooks, np.float32),
        "sqnorms": np.asarray(small_index.codebook.sqnorms, np.float32),
        "nq": nq, "nprobe": nprobe,
        "gt": np.asarray(small_corpus.groundtruth)[:, :K],
    }


def test_bf16_recall_matches_f32_and_reference(recall_inputs):
    inp = recall_inputs
    nq, nprobe, gt = inp["nq"], inp["nprobe"], inp["gt"]
    rec = {}
    for pkg, step in (("ref", lambda dt: _ref_step(inp, K, True, dt)),
                      ("port", lambda dt: _port_step(inp, K, dt))):
        for name, dt in (("f32", None),
                         ("bf16", jnp.bfloat16 if pkg == "ref" else "bf16")):
            bd, bi = step(dt)
            rec[pkg, name] = _recall(_merge(bd, bi, nq, nprobe), gt)
    assert rec["ref", "f32"] > 0.5, rec
    for pkg in ("ref", "port"):
        assert abs(rec[pkg, "f32"] - rec[pkg, "bf16"]) <= 0.01, rec
    assert abs(rec["port", "bf16"] - rec["ref", "bf16"]) <= 0.01, rec


# (e) the dry-run's bf16 drim cell ------------------------------------------

DRIM_SMALL = {"slots": 4, "cpart": 64, "tasks": 32, "queries": 16,
              "nlist": 8}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_drim_cell_bf16_on_cpu(tmp_path, fused):
    rec = dryrun.run_drim_ann_cell(False, tmp_path, fused_scan=fused,
                                   lut_dtype="bf16", device="cpu",
                                   shape=DRIM_SMALL)
    name = ("drim_ann__search_100m__pod256__fused__lut_bf16" if fused
            else "drim_ann__search_100m__pod256__lut_bf16")
    saved = json.loads((tmp_path / f"{name}.json").read_text())
    assert saved["tag"] == rec["tag"] == name.split("pod256__")[1]
    assert rec["fits"] is True and rec["step_ms"] > 0
    f32 = roofline.drim_search_work(32, 64, 16, 256, 8, 10, False, fused, 4)
    bf16 = roofline.drim_search_work(32, 64, 16, 256, 8, 10, False, fused, 4,
                                     bf16=True)
    assert rec["per_device_hbm_bytes"] == bf16["hbm_bytes"]
    # the table term (written by LC, read by DC) at 2 B an entry: half
    # of f32's 2 T M CB 4 B
    assert (f32["hbm_bytes"] - bf16["hbm_bytes"]) * 2 == \
        2 * 32 * 16 * 256 * 4


def test_drim_step_bf16_dataflows_agree():
    """The bf16 cell's fused (A-bf16 + E-bf16) and unfused (A-bf16 +
    C-bf16 + torch.topk) programs give the same distances."""
    from repro_torch.configs import drim_ann
    shp = dict(dryrun._drim_shape(drim_ann.config(), 256), **DRIM_SMALL)
    inp = dryrun.drim_inputs(shp, torch.device("cpu"))
    d1, i1 = dryrun.drim_step(inp, shp["k"], True, False, "bf16")
    d2, i2 = dryrun.drim_step(inp, shp["k"], False, False, "bf16")
    assert torch.equal(d1, d2) and d1.shape == (32, 10)
    assert torch.equal(d1.to(torch.bfloat16).float(), d1)
    f32, _ = dryrun.drim_step(inp, shp["k"], True, False)
    assert not torch.equal(d1, f32)


def test_dryrun_main_lut_dtype_bf16(tmp_path, monkeypatch):
    """``--lut-dtype bf16`` reaches the cell (at the small shard shape:
    ``main`` runs the 100M one)."""
    orig = dryrun.run_drim_ann_cell
    monkeypatch.setattr(dryrun, "run_drim_ann_cell",
                        lambda *a, **kw: orig(*a, shape=DRIM_SMALL, **kw))
    dryrun.main(["--arch", "drim_ann", "--fused-scan", "--lut-dtype",
                     "bf16", "--device", "cpu", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / "drim_ann__search_100m__pod256__fused__"
                                  "lut_bf16.json").read_text())
    assert rec["shard_shape"]["slots"] == 4 and rec["fits"] is True


@pytest.mark.parametrize("kind,c,entry,bits", [
    ("bf16", 1024, "pq_scan_topk_bf16", 32),
    ("bf16", 65535, "pq_scan_topk_bf16", 32),
    ("bf16", 65536, "pq_scan_topk_bf16_wide", 64),
    ("f32", 1024, "pq_scan_topk_f32", 64),
    ("u8", 1024, "pq_scan_topk_u8", 64),
])
def test_fused_kernel_instance_by_table_and_rows(kind, c, entry, bits):
    """The fused wrapper's instance: 32-bit selection keys on a bf16
    table of at most 65,535 rows a slot (the row fills the key's low 16
    bits, 0xffff meaning none), 64-bit keys otherwise; both launch a
    hand-written kernel (the CPU runs the plain version either way)."""
    assert ops.BF16_KEY32_MAX_C == 0xffff
    assert ops._topk_entry(kind, c) == (entry, bits)
