"""A tiny copy of the benchmark for CPU tests: a checkout-like root with
``BENCHMARK.json`` and the benchmark's plug-in folders, and one small
configuration under the real batch mix's generator."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from annbench import harness

REPO = Path(__file__).resolve().parents[2]
FOLDERS = ("traffic", "metrics", "kinds", "draws", "checks")
TINY_SHAPE = {"n_points": 20_000, "dim": 16}
TINY_SERVICE = {"index": {"nlist": 64, "m": 4, "cb": 16}, "nprobe": 8}
TBATCH = {"kind": "closed_batch", "batch": 64, "pool_batches": 2,
          "check_sample": 64}


def tiny_config(**service) -> dict:
    cfg = json.loads((REPO / "annbench" / "configs" / "sift100m.json")
                     .read_text())
    cfg.update(TINY_SHAPE, name="tiny")
    cfg["service"].update(TINY_SERVICE, **service)
    return cfg


def make_root(tmp: Path) -> Path:
    """A root at ``tmp`` whose BENCHMARK.json adds ``tiny.tbatch`` to the
    real benchmark, reading the metrics of the real batch cells."""
    (tmp / "annbench").mkdir(parents=True)
    for d in FOLDERS:
        shutil.copytree(REPO / "annbench" / d, tmp / "annbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "tiny.json").write_text(json.dumps(tiny_config()))
    bench["configs"].append({"name": "tiny", "source": "a test's",
                             "file": "tiny.json", "reduced": [],
                             "why": "CPU tests"})
    (tmp / "annbench" / "traffic" / "tbatch.json").write_text(
        json.dumps(TBATCH))
    bench["workloads"].append({"name": "tiny.tbatch", "config": "tiny",
                               "traffic": "tbatch", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.tbatch")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def run(root: Path, cell: str, seed: int = 20_260_000_001,
        seconds: float = 0.5, traced: bool = False) -> dict:
    return harness.run(cell, seed, seconds, traced,
                       t_start=time.perf_counter(), root=root, device="cpu",
                       log=lambda s: None)
