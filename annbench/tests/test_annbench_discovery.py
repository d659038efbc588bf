"""The benchmark's files against its contract, and discovery by name:
cells, configurations, mixes and metric readers."""

import json
import math
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from annbench import harness  # noqa: E402
from annbench.tests import tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(dim|m|cb|k|nprobe|hidden|intermediate)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["annbench"]
    assert BENCH["command"] == ["python3", "annbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_fits_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("roofline.batch") or "_roofline" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("annbench/")
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert not any(WIDTH.search(k) for k in cfg["reduced"])
    for key in ("n_points", "dim", "draw", "service", "check", "assumed"):
        assert key in body
    from repro_torch.service import ServiceSpec
    spec = ServiceSpec.from_dict(body["service"])
    assert (spec.index.nlist, spec.index.m, spec.index.cb) == (65_536, 16,
                                                              256)
    assert all(len(x) <= 200 for x in (cfg["source"], cfg["why"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_discovery(cell):
    c = harness.load_cell(cell["name"])
    assert c.config["name"] == cell["config"]
    for mod in (c.draw, c.kind, c.check):
        assert isinstance(mod.KEYS, set)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert len(cell["why"]) <= 200


def test_layers_named_alike():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"**{m['layer']}**" in perf, m["layer"]


def test_unknown_cell_is_refused():
    with pytest.raises(harness.BenchError):
        harness.load_cell("nosuch.cell")


@pytest.mark.parametrize("where,key", [("config", "nprobes"),
                                       ("mix", "batches"),
                                       ("check", "dist_gaps")])
def test_unknown_keys_are_refused(tmp_path, where, key):
    root = tiny.make_root(tmp_path)
    if where == "mix":
        path = root / "annbench" / "traffic" / "tbatch.json"
    else:
        path = root / "tiny.json"
    body = json.loads(path.read_text())
    (body["check"] if where == "check" else body)[key] = 1
    path.write_text(json.dumps(body))
    with pytest.raises(harness.BenchError, match=key):
        harness.load_cell("tiny.tbatch", root)


def test_unknown_service_key_is_refused(tmp_path):
    """The service block goes to the program's ServiceSpec whole: a key it
    does not know stops the run before anything is drawn."""
    root = tiny.make_root(tmp_path)
    cfg = json.loads((root / "tiny.json").read_text())
    cfg["service"]["cache_capacityy"] = 8
    (root / "tiny.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="cache_capacityy"):
        tiny.run(root, "tiny.tbatch")


STREAM_KIND = """
import time
import numpy as np
from annbench.harness import Window

KEYS = {"requests"}


def pool_size(traffic, seconds):
    return traffic["requests"]


def warm(svc, traffic, pool):
    svc.submit_async(pool[0]).result(timeout=60)


def run(svc, traffic, pool, seconds, seed, sync):
    assert svc.spec.router == "least_queue" and len(svc.replicas) == 2
    out = Window(0.0)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        r = i % len(pool)
        d, ids = svc.submit_async(pool[r]).result(timeout=60)
        out.blocks.append((np.array([r]), d[None], ids[None]))
        i += 1
    out.window_s = time.perf_counter() - t0
    return out
"""


def test_throwaway_cell_needs_only_new_files(tmp_path):
    """A new configuration that sets ServiceSpec fields no configuration
    sets yet, a new kind of mix with its own generator, a new metric and
    a new cell: new files and new BENCHMARK.json entries only, and a run
    serves through them, reports the new metric and is judged."""
    root = tiny.make_root(tmp_path)
    cfg = tiny.tiny_config(nprobe=4, replicas=2, router="least_queue",
                           max_wait_s=1e-3)
    cfg["name"] = "tiny2"
    (root / "tiny2.json").write_text(json.dumps(cfg))
    (root / "annbench" / "kinds" / "one_by_one.py").write_text(STREAM_KIND)
    (root / "annbench" / "traffic" / "stream.json").write_text(json.dumps(
        {"kind": "one_by_one", "requests": 50, "check_sample": 32}))
    (root / "annbench" / "metrics" / "requests.stream.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx.window.blocks)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "a test's",
                             "file": "tiny2.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "tiny2.stream", "config": "tiny2",
                               "traffic": "stream", "chips": 1,
                               "why": "a throwaway"})
    bench["end_to_end"][0]["workloads"].append("tiny2.stream")   # qps
    bench["per_layer"].append({"name": "requests.stream", "unit": "requests",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "service", "moves": "qps",
                               "workloads": ["tiny2.stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # the generator above asserts that the service has the configuration's
    # router and replicas
    out = tiny.run(root, "tiny2.stream", seconds=0.3, traced=False)
    assert out["correct"] and set(out["metrics"]) == {"qps", "setup_s"}
    assert out["attempted"] > 0
    out = tiny.run(root, "tiny2.stream", seconds=0.3, traced=True)
    assert out["metrics"]["requests.stream"]["value"] == out["attempted"]
    assert math.isfinite(out["compared"]["dist_gap"]["value"])
