"""The program's spans in a trace (``annbench.spans``) against hand counts,
the five readers over them, and a traced CPU run that finds the spans
and the counter through the harness."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from annbench import harness, spans, trace  # noqa: E402
from annbench.tests import tiny  # noqa: E402
from repro_torch import obs  # noqa: E402

E = spans.Event
SHARES = {"cl_share.batch": "drim.cl", "gather_share.batch": "drim.gather",
          "ts_share.batch": "drim.ts"}


def _host(name, s, e, corr=0, thread=1):
    return E(name, False, s, e, name.startswith(("drim.", "annbench.")),
             corr, thread)


def _kernel(s, e, corr, name="k"):
    return E(name, True, s, e, False, corr, 0)


# ns.  Thread 1 runs the program; thread 2 has a range of its own open at
# the first launch; thread 99 holds no range.
EVENTS = [
    _host(trace.WINDOW, 0, 1000),
    _host(spans.SERVICE, 100, 830),
    _host("drim.ts", 200, 400),
    _host("aten::topk", 250, 350, corr=501),  # a host id equal to a launch's
    _host("drim.cl", 240, 290, thread=2),
    _host("cudaLaunchKernel", 260, 270, corr=501),
    _kernel(300, 500, 501, "topk"),           # launched in drim.ts
    _kernel(520, 560, 777),                   # no launch event
    _host("cudaLaunchKernel", 450, 455, corr=503, thread=99),
    _kernel(600, 700, 503),                   # the service's own
    _host("cuLaunchKernel", 950, 960, corr=502),
    _kernel(960, 1100, 502),                  # in no range; ends past
    E("drim.ts", True, 300, 500, True, 0, 0),        # the range on the card
]


def test_device_and_idle_seconds_by_hand():
    sp = spans.attribute(EVENTS)
    assert sp.found
    assert sp.device_s == pytest.approx({
        "drim.ts": 200e-9, spans.UNLINKED: 40e-9, spans.SERVICE: 100e-9,
        spans.NONE: 40e-9})
    # idle [0,300] [500,520] [560,600] [700,960] under [100,830]: the
    # last one half under it
    assert sp.program_idle_s == pytest.approx((200 + 20 + 40 + 130) * 1e-9)


def test_no_program_ranges():
    sp = spans.attribute([e for e in EVENTS
                          if not e.name.startswith(spans.PREFIX)])
    assert not sp.found and sp.program_idle_s == 0.0
    assert sp.device_s[spans.NONE] == pytest.approx(340e-9)
    with pytest.raises(RuntimeError, match=trace.WINDOW):
        spans.attribute(EVENTS[1:])


class _Ctx:
    def __init__(self, tr, sp, rows=0):
        self.trace, self._rows = tr, rows
        self._cache = {spans.KEY: sp}

    def scanned_rows(self):
        return self._rows


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_readers_on_a_hand_built_context():
    tr = trace.Trace(window_s=2.0, busy_s=1.6, kernels={"a": (3, 0.5),
                                                       "b": (1, 1.5)})
    sp = spans.Spans(device_s={"drim.cl": 0.1, "drim.gather": 0.6,
                               "drim.ts": 0.8, spans.NONE: 0.5},
                     program_idle_s=0.3, found=True)
    for metric, name in SHARES.items():
        assert _read(metric, _Ctx(tr, sp)) == pytest.approx(
            100 * sp.device_s[name] / 2.0)
    assert _read("program_idle_share.batch", _Ctx(tr, sp)) == \
        pytest.approx(15.0)
    for metric in [*SHARES, "program_idle_share.batch"]:
        assert _read(metric, _Ctx(tr, None)) is None              # untraced
        assert _read(metric, _Ctx(tr, spans.Spans())) is None     # parent
        assert _read(metric, _Ctx(trace.Trace(1.0, 0.0), sp)) is None


def test_useful_rows_reader(monkeypatch):
    tr = trace.Trace(1.0, 1.0)
    monkeypatch.setattr(obs.counts, "traced", {"dc.rows_scanned": 6200})
    assert _read("dc_useful_share.batch", _Ctx(tr, None, 1526)) == \
        pytest.approx(100 * 1526 / 6200)
    assert _read("dc_useful_share.batch", _Ctx(None, None, 1526)) is None
    monkeypatch.setattr(obs.counts, "traced", {"dc.rows_scanned": 0})
    assert _read("dc_useful_share.batch", _Ctx(tr, None, 1526)) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)   # parent
    assert _read("dc_useful_share.batch", _Ctx(tr, None, 1526)) is None


def test_traced_cpu_run_finds_the_programs_spans(tmp_path, monkeypatch):
    """Through ``harness.run``: the readers find the harness's profiler and
    the program's ranges, and the counter of the traced window alone.  On
    the CPU the trace holds no device operation, so the shares read
    nothing and the useful-row share reads the counter."""
    found = []

    def attribute(ev):
        found.append(real(ev))
        return found[-1]

    real = spans.attribute
    monkeypatch.setattr(spans, "attribute", attribute)
    root = tiny.make_root(tmp_path)
    obs.reset()
    out = tiny.run(root, "tiny.tbatch", traced=True)
    assert len(found) == 1 and found[0].found
    assert set(found[0].device_s) <= {spans.NONE}
    got = out["metrics"]
    assert not set(got) & {*SHARES, "program_idle_share.batch"}
    cfg = tiny.tiny_config()["service"]
    rows_a_task = obs.counts.traced["dc.rows_scanned"] / (
        out["attempted"] * cfg["nprobe"])
    assert rows_a_task == int(rows_a_task) > 0          # the padded width
    assert 0 < got["dc_useful_share.batch"]["value"] <= 100
    assert out["correct"]
    obs.reset()


def test_intersection_by_hand():
    a = np.array([[0, 10], [20, 30]], dtype=np.int64)
    b = np.array([[5, 25]], dtype=np.int64)
    assert spans._intersect_s(a, b) == pytest.approx(10e-9)
    assert spans._intersect_s(a, b[:0]) == 0.0
