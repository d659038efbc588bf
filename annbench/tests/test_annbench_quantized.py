"""The uint8-table configuration on a tiny drawn index: the program's
cell judged correct by ``quantized_ivfpq``, the reference's other tables
in its place failing the check, runs with the timed path broken
underneath coming out not correct, the uint8 reference against the
program's search, and the u8 kernels' roofline counts and readers."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from annbench import calibrate_u8, harness, roofline, roofline_u8  # noqa: E402
from annbench import trace  # noqa: E402
from annbench.reference_u8 import ReferenceU8, quantize  # noqa: E402
from annbench.tests import tiny  # noqa: E402
from annbench.tests.test_annbench_reference import _broken  # noqa: E402
from repro_torch.core.search import SearchParams, search_ivfpq  # noqa: E402
from repro_torch.core.ivf import pad_clusters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CELL = "tinyu8.tbatch"
U8 = json.loads((ROOT / "annbench" / "configs" / "sift100m-u8lut.json")
                .read_text())
# M and CB as the configuration's, at a width and a size the CPU runs
SHAPE = {"n_points": 20_000, "dim": 64}
INDEX = {"nlist": 64, "m": 16, "cb": 256}
judge = harness.plugin("checks", "quantized_ivfpq")
data = harness.plugin("draws", "ivfpq")


def u8_config() -> dict:
    cfg = tiny.tiny_config(lut_dtype="uint8", index=INDEX)
    cfg.update(SHAPE, name="tinyu8", precision=U8["precision"],
               check=U8["check"])
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root, with a cell of the uint8 configuration at a tiny
    size reading the uint8 cell's metrics."""
    root = tiny.make_root(tmp_path_factory.mktemp("tinyu8"))
    (root / "tinyu8.json").write_text(json.dumps(u8_config()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyu8", "source": "a test's",
                             "file": "tinyu8.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tinyu8",
                               "traffic": "tbatch", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sift100m-u8lut.batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def cfg(root):
    return harness.load_cell(CELL, root).config


def test_the_cell_is_the_sift_index_on_uint8_tables():
    sift = json.loads((ROOT / "annbench" / "configs" / "sift100m.json")
                      .read_text())
    assert U8["service"] == dict(sift["service"], lut_dtype="uint8")
    for key in ("n_points", "dim", "query_domain", "draw", "reduced"):
        assert U8[key] == sift[key]
    assert U8["check"]["kind"] == "quantized_ivfpq"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell("sift100m-u8lut.batch")
    got = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert got == {"qps", "setup_s", "cl_share.batch", "ts_share.batch",
                   "idle_share.batch", "program_idle_share.batch",
                   "dc_useful_share.batch", "lc_u8_roofline.batch",
                   "dc_u8_roofline.batch"}
    assert [w["name"] for w in bench["workloads"]][-1] == \
        "sift100m-u8lut.batch"


@pytest.mark.parametrize("traced", [False, True])
def test_the_program_reads_correct(root, traced):
    out = tiny.run(root, CELL, seconds=0.3, traced=traced)
    assert out["correct"] is True
    assert set(out["compared"]) == {"dist_gap", "id_gap", "unanswered"}
    if traced:      # no B or D on the CPU: their readers find nothing
        assert "lc_u8_roofline.batch" not in out["metrics"]
        assert "dc_useful_share.batch" in out["metrics"]


@pytest.mark.parametrize("seed", [9, 2 ** 33 + 5])
@pytest.mark.parametrize("table", ["f32", "u7"])
def test_control_fails_the_check(root, cfg, seed, table):
    cell = harness.load_cell(CELL, root)
    got = calibrate_u8.control_readings(cell, seed, [table], "cpu",
                                        seconds=0.5)[0]
    assert got["id_gap"] > cfg["check"]["id_gap"]


@pytest.mark.parametrize("how", ["half", "altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, how):
    _broken(monkeypatch, how)
    out = tiny.run(root, CELL, seconds=0.3)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 2 ** 40 + 11])
def test_reference_agrees_with_the_program(cfg, seed):
    """Within one count a row, and the same ids wherever the reference's
    k-th and (k+1)-th rows lie two counts or more apart."""
    index, g = data.draw_index(cfg, seed, "cpu")
    q = data.draw_queries(cfg, {}, index, g, 200)
    ivf = harness.program_index(index)
    nprobe, k = cfg["service"]["nprobe"], cfg["service"]["k"]
    d, i = search_ivfpq(ivf, pad_clusters(ivf), q, SearchParams(
        nprobe=nprobe, k=k, use_kernels=True, lut_dtype="uint8"))
    ref = ReferenceU8(index, nprobe, k)
    gaps = judge.gaps(ref, q, d.numpy(), i.numpy())
    assert gaps["dist_gap"] <= 1.0 + 1e-3 and gaps["id_gap"] <= 1.0 + 1e-3
    wide = ReferenceU8(index, nprobe, k + 1).search(q)
    unit = ref.query_count(q, wide.allowed)
    clear = wide.exact & (wide.low[:, k] - wide.low[:, k - 1] >= 2 * unit)
    assert int(clear.sum()) > 50
    for b in np.flatnonzero(clear.numpy()):
        assert set(i[b].tolist()) == set(wide.ids[b, :k].tolist())


def test_quantize_by_hand():
    lut = torch.tensor([[[0.0, 255.0, 127.5, 1.5], [3.0, 3.0, 3.0, 3.0]]])
    t = quantize(lut, 255.0)
    assert t.step.tolist() == [[1.0, 1.0]] and t.bias.tolist() == [[0.0, 3.0]]
    # 127.5 and 1.5 round half to even
    assert t.q.tolist() == [[[0.0, 255.0, 128.0, 2.0], [0.0] * 4]]
    t7 = quantize(lut, 127.0)
    assert t7.step[0, 0] == pytest.approx(255.0 / 127.0)
    assert float(t7.q.max()) == 127.0


def test_u8_counts_by_hand():
    nbytes, ops_ = roofline_u8.lut_u8_bytes_ops(t=2, m=2, cb=4, dsub=3)
    assert nbytes == 2 * 6 * 4 + 2 * 4 * 3 * 4 + 2 * 4 * 4 + 2 * 2 * 4 \
        + 2 * 2 * 8
    assert ops_ == 2 * 2 * 4 * (2 * 3 + 4 + 3) + 2 * 2 * 2 * 3
    assert roofline_u8.lut_u8_bytes_ops(2, 2, 4, 3, launches=3)[0] == \
        nbytes + 2 * (2 * 4 * 3 * 4 + 2 * 4 * 4)
    nbytes, ops_ = roofline_u8.dc_u8_bytes_ops(t=3, m=2, cb=4, rows=10)
    assert nbytes == 3 * (2 * 4 + 8 * 2) + 10 * 2 + 3 * 4 + 10 * 4
    assert ops_ == 10 * 2 * 2 + 3 * 2
    # sift100m's chunk, 256 queries x 96 probes: a quarter of the f32
    # table, plus the scales and biases
    t = 256 * 96
    a = roofline.dc_bytes_ops(t, 16, 256, t * 1526)[0]
    d = roofline_u8.dc_u8_bytes_ops(t, 16, 256, t * 1526)[0]
    assert a - d == t * 16 * 256 * 3 - t * 16 * 8


class _Ctx:
    def __init__(self, tr, rows):
        self.window = harness.Window(1.0, [(np.arange(256), None, None)] * 2)
        self.trace = tr
        self.cell = type("C", (), {"config": {
            "dim": 128, "service": {"index": {"m": 16, "cb": 256},
                                    "nprobe": 96}}})()
        self._rows = rows

    def scanned_rows(self):
        return self._rows


KERNELS = {
    "void (anonymous namespace)::lut_build_kernel<8, true, 0>(float const*)":
        (2, 1e-3),
    "void (anonymous namespace)::lut_build_kernel<8, true, 1>(float const*)":
        (2, 4e-4),
    "void (anonymous namespace)::lut_build_kernel<0, true, 2>(float const*)":
        (1, 9.0),
    "void (anonymous namespace)::pq_scan_kernel<unsigned char, 0, true>"
    "(void const*, float const*)": (2, 5.0),
    "void (anonymous namespace)::pq_scan_kernel<unsigned char, 1, true>"
    "(void const*, float const*)": (2, 2e-3),
    "void (anonymous namespace)::pq_scan_kernel<int, 2, false>(void const*)":
        (1, 7.0),
    "void (anonymous namespace)::pq_scan_topk_kernel<1, unsigned char, 1, "
    "true>(void const*)": (1, 8.0),
}


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_u8_readers_read_only_b_and_d():
    rows = 512 * 96 * 1500
    ctx = _Ctx(trace.Trace(1.0, 1.0, kernels=KERNELS), rows)
    lc = roofline.bound_s(*roofline_u8.lut_u8_bytes_ops(
        512 * 96, 16, 256, 8, launches=2))
    dc = roofline.bound_s(*roofline_u8.dc_u8_bytes_ops(512 * 96, 16, 256,
                                                       rows))
    assert _read("lc_u8_roofline.batch", ctx) == pytest.approx(
        100 * lc / 4e-4)
    assert _read("dc_u8_roofline.batch", ctx) == pytest.approx(
        100 * dc / 2e-3)
    f32_only = {n: v for n, v in KERNELS.items()
                if "true, 1>" not in n and "char, 1," not in n}
    for tr in (trace.Trace(1.0, 1.0, kernels=f32_only),
               trace.Trace(1.0, 1.0), None):
        ctx = _Ctx(tr, rows)
        assert _read("lc_u8_roofline.batch", ctx) is None
        assert _read("dc_u8_roofline.batch", ctx) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_b_and_d_serve_the_cell_and_controls_fail_on_the_card(root, cuda):
    """A mid-size draw on the card: the service launches B and D only,
    its answers pass the check, and the controls fail it."""
    cell = harness.load_cell(CELL, root)
    big = dict(cell.config, n_points=400_000, dim=128,
               service=dict(cell.config["service"], nprobe=32,
                            index={"nlist": 1024, "m": 16, "cb": 256}))
    lim = big["check"]
    drawn = cell.draw.draw(big, cell.traffic, 9, cuda, 2048)
    from repro_torch.service import AnnService, ServiceSpec
    svc = AnnService.build(ServiceSpec.from_dict(big["service"]),
                           index=harness.program_index(drawn.index),
                           device=cuda)
    ops.reset_launches()
    d, i = svc.search(drawn.queries.cpu().numpy())
    svc.shutdown()
    got = {n: c for n, c in ops.launches.items() if c}
    assert set(got) == {"lut_build_q", "pq_scan_dc_q"}
    g = judge.gaps(ReferenceU8(drawn.index, 32, big["service"]["k"]),
                   drawn.queries, d, i)
    assert g["dist_gap"] <= lim["dist_gap"] and g["id_gap"] <= lim["id_gap"]
    cell = harness.Cell(cell.name, big, cell.traffic, 1, [], [], cell.draw,
                        cell.kind, cell.check)
    for got in calibrate_u8.control_readings(cell, 9, ["f32", "u7"], cuda,
                                             seconds=0.5):
        assert got["id_gap"] > lim["id_gap"]


@pytest.mark.parametrize("name", ["reference_u8.py",
                                  "checks/quantized_ivfpq.py",
                                  "roofline_u8.py", "calibrate_u8.py"])
def test_the_u8_yardstick_imports_nothing_of_the_program(name):
    from annbench.tests.test_annbench_imports import _top_level_imports
    got = _top_level_imports(ROOT / "annbench" / name)
    assert not got & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
