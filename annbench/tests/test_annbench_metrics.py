"""The metric arithmetic: a rate over the whole window, the check's
sample, the trace's union and idle share, and the roofline counts
against hand counts."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from annbench import harness, roofline, trace  # noqa: E402


class _Ctx:
    def __init__(self, window=None, tr=None):
        self.window, self.trace = window, tr


def _read(name, ctx):
    return harness.reader(name)(ctx)


def _blocks(n, b):
    return [(np.arange(b), np.zeros((b, 10)), np.zeros((b, 10), np.int64))
            for _ in range(n)]


def test_rate_over_the_whole_window():
    w = harness.Window(4.0, _blocks(3, 10_000))
    assert w.attempted == w.answered == 30_000
    assert _read("qps", _Ctx(w)) == pytest.approx(7_500.0)
    assert _read("qps", _Ctx(harness.Window(4.0))) is None


def test_the_check_sample_is_drawn_from_every_block():
    blocks = [(np.arange(s, s + 5), np.arange(s, s + 5)[:, None] * 1.0,
               np.arange(s, s + 5)[:, None]) for s in (0, 5, 10)]
    w = harness.Window(1.0, blocks)
    rows, d, i = harness.served_sample(w, 15, seed=3)
    assert rows.tolist() == list(range(15))
    assert (d[:, 0] == rows).all() and (i[:, 0] == rows).all()
    rows, d, i = harness.served_sample(w, 6, seed=2 ** 40 + 1)
    assert len(set(rows.tolist())) == 6 and (d[:, 0] == rows).all()
    assert np.array_equal(rows, harness.served_sample(w, 6, 2 ** 40 + 1)[0])


def test_trace_union_and_idle_share():
    iv = np.array([[0, 10], [5, 20], [30, 40]], dtype=np.int64)
    assert trace._union(iv).tolist() == [[0, 20], [30, 40]]
    tr = trace.Trace(window_s=2.0, busy_s=1.5)
    assert _read("idle_share.batch", _Ctx(tr=tr)) == pytest.approx(25.0)
    assert _read("idle_share.batch",
                 _Ctx(tr=trace.Trace(window_s=1.0, busy_s=0.0))) is None
    ev = [("aten::mm", False, 0, 100, False)]
    gaps = trace._idle_gaps(ev, np.array([[10, 60]], dtype=np.int64), 0, 100)
    assert gaps == [["aten::mm", pytest.approx(50e-9)]]


def test_topk_share_reads_kernel_names():
    tr = trace.Trace(1.0, 1.0, kernels={
        "void at::native::sbtopk::gatherTopK<float>": (3, 0.3),
        "void at::native::bitonicSortKVInPlace<>": (1, 0.1),
        "pq_scan_kernel<unsigned char, 0, true>": (3, 0.4),
        "Memcpy HtoD": (1, 0.2)})
    assert _read("topk_share.batch", _Ctx(None, tr)) == pytest.approx(40.0)


def test_lc_counts_by_hand():
    nbytes, ops = roofline.lut_bytes_ops(t=2, m=2, cb=4, dsub=3)
    assert nbytes == 2 * 6 * 4 + 2 * 4 * 3 * 4 + 2 * 4 * 4 + 2 * 2 * 4 * 4
    assert ops == 2 * 2 * 4 * (2 * 3 + 4) + 2 * 2 * 2 * 3
    # three launches read the codebooks and their norms three times
    assert roofline.lut_bytes_ops(2, 2, 4, 3, launches=3)[0] == \
        nbytes + 2 * (2 * 4 * 3 * 4 + 2 * 4 * 4)
    # sift100m's chunk: 256 queries x 96 probes
    t = 256 * 96
    nbytes, ops = roofline.lut_bytes_ops(t, 16, 256, 8)
    assert nbytes == t * 128 * 4 + 16 * 256 * 8 * 4 + 16 * 256 * 4 \
        + 402_653_184
    assert ops == t * 16 * 256 * 20 + t * 16 * 16
    assert roofline.bound_s(nbytes, ops) == pytest.approx(
        nbytes / 3.35e12)                      # bytes bound it


def test_dc_counts_by_hand():
    nbytes, ops = roofline.dc_bytes_ops(t=3, m=2, cb=4, rows=10)
    assert nbytes == 3 * 2 * 4 * 4 + 10 * 2 + 3 * 4 + 10 * 4
    assert ops == 20
    # sift100m's chunk: 0.40 GB of tables, the real rows' codes and their
    # distances (not the rows gathered or written by padded width)
    t, rows = 256 * 96, 256 * 96 * 1526
    nbytes, ops = roofline.dc_bytes_ops(t, 16, 256, rows)
    assert nbytes == 402_653_184 + rows * 16 + t * 4 + rows * 4
    assert roofline.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)


def test_probed_rows_by_hand():
    cen = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [10.0, 10.0]])
    sizes = torch.tensor([1, 20, 300, 4000])
    q = torch.tensor([[1.0, 1.0], [9.0, 9.5], [9.0, 1.0]])
    got = roofline.probed_rows(cen, sizes, q, nprobe=2, block=2)
    # nearest two: {0, 1 or 2}: a tie, {3, 2}, {1, 0 or 3}
    assert got[1] == 4300 and got[0] in (21, 301) and got[2] in (21, 4020)


class _CellCtx(_Ctx):
    def __init__(self, window, tr, rows):
        super().__init__(window, tr)
        self.cell = type("C", (), {"config": {
            "dim": 128, "service": {"index": {"m": 16, "cb": 256},
                                    "nprobe": 96}}})()
        self._rows = rows

    def scanned_rows(self):
        return self._rows


def test_roofline_readers_divide_the_window_bound_by_kernel_time():
    w = harness.Window(1.0, _blocks(2, 256))
    tr = trace.Trace(1.0, 1.0, kernels={
        "void pq_scan_kernel<0, true>(...)": (2, 2e-3),
        "void lut_build_kernel<8>(...)": (2, 4e-4)})
    rows = 512 * 96 * 1500
    ctx = _CellCtx(w, tr, rows)
    dc = roofline.bound_s(*roofline.dc_bytes_ops(512 * 96, 16, 256, rows))
    assert _read("dc_roofline.batch", ctx) == pytest.approx(100 * dc / 2e-3)
    lc = roofline.bound_s(*roofline.lut_bytes_ops(512 * 96, 16, 256, 8,
                                                  launches=2))
    assert _read("lc_roofline.batch", ctx) == pytest.approx(100 * lc / 4e-4)
    # no launch in the trace: nothing to read
    empty = _CellCtx(w, trace.Trace(1.0, 1.0), rows)
    assert _read("dc_roofline.batch", empty) is None
    assert _read("lc_roofline.batch", empty) is None
