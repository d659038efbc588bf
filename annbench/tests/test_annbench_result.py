"""The result line: its keys, the CUDA and JAX refusals, and a directory
that holds only the benchmark's own files."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from annbench import harness  # noqa: E402
from annbench.tests import tiny  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def test_untraced_line(root):
    cell = "tiny.tbatch"
    out = tiny.run(root, cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in harness.load_cell(cell, root).end_to_end}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(out))


def test_traced_line(root):
    cell = "tiny.tbatch"
    out = tiny.run(root, cell, traced=True)
    names = {m["name"] for m in harness.load_cell(cell, root).per_layer}
    assert set(out["metrics"]) <= names
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    b = out["breakdown"]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert out["correct"] is True


def test_main_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = subprocess.run([sys.executable, str(ROOT / "annbench" / "run.py"),
                        "--workload", "sift100m.batch", "--seed",
                        str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """Without the program beside it the harness fails, printing nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "annbench", tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = [sys.argv[1]]\n"
            "from pathlib import Path\n"
            "from annbench import harness\n"
            "print(harness.run('sift100m.batch', 1, 1.0, False, "
            "t_start=time.perf_counter(), root=Path(sys.argv[1]), "
            "device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env={k: v for k, v in os.environ.items()
                                          if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]
