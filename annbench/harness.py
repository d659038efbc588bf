"""One run of one cell: draw the inputs, build the service, warm the
cell's shapes, measure for the window, judge what it served, and return
the result line's object.

Everything a cell needs is found by name, so a later cell, configuration,
mix, generator, check or metric is new files and new ``BENCHMARK.json``
entries:

* the cell: an entry of ``BENCHMARK.json``'s ``workloads``;
* its configuration: the file its ``configs`` entry names.  The
  ``"service"`` block is the program's ``ServiceSpec`` in its serialized
  form, passed whole to ``ServiceSpec.from_dict`` (which refuses an
  unknown key by name); ``"draw"`` names the module under
  ``annbench/draws/`` that draws the inputs from the seed, and
  ``"check"``'s ``"kind"`` the module under ``annbench/checks/`` that
  decides ``correct``;
* its mix: ``annbench/traffic/<mix>.json``, whose ``"kind"`` names the
  generator under ``annbench/kinds/`` that drives the service;
* each metric: ``annbench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the number, or None where it finds nothing to read.

Each module lists the keys it reads (``KEYS``; a draw also
``TRAFFIC_KEYS``); a key of a configuration or a mix that neither the
harness nor its modules read is refused before anything is drawn.

The interfaces: a draw has ``draw(cfg, traffic, seed, device, count)``
-> an object with ``index`` (an IVF-PQ index in CSR form: ``centroids``,
``codebooks``, ``codes``, ``ids``, ``offsets``), ``queries`` (count, D)
on the device, and ``points`` (raw vectors for a mutable service, or
None); a generator has ``pool_size(traffic, seconds)``, ``warm(svc,
traffic, pool)`` and ``run(svc, traffic, pool, seconds, seed, sync)`` ->
:class:`Window`; a check has ``compare(cfg, index, queries, dists,
ids)`` -> ``{name: {"value", "limit"}}``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from annbench import roofline, trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CONFIG_KEYS = {"name", "source", "deployment", "precision", "draw",
               "service", "reduced", "assumed", "check"}
MIX_KEYS = {"kind", "check_sample", "why"}
SAMPLE_QUERIES = 256          # queries the sharded engine's heat estimate sees


class BenchError(RuntimeError):
    pass


def plugin(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``annbench/<folder>/<name>.py`` under ``root``."""
    path = root / "annbench" / folder / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(
        f"annbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> Callable:
    return plugin("metrics", metric, root).read


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    draw: ModuleType
    kind: ModuleType
    check: ModuleType


def _refuse_unknown(what: str, got, known) -> None:
    bad = sorted(set(got) - set(known))
    if bad:
        raise BenchError(f"{what}: unknown keys {bad} (known: "
                         f"{sorted(known)})")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "annbench" / "traffic" / f"{w['traffic']}.json").read_text())
    draw = plugin("draws", config["draw"], root)
    kind = plugin("kinds", traffic["kind"], root)
    check = plugin("checks", config["check"]["kind"], root)
    _refuse_unknown(entry["file"], config, CONFIG_KEYS | draw.KEYS)
    _refuse_unknown(f"traffic/{w['traffic']}.json", traffic,
                    MIX_KEYS | kind.KEYS | draw.TRAFFIC_KEYS)
    _refuse_unknown(f"{entry['file']} check", config["check"],
                    {"kind"} | check.KEYS)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, config, traffic, w["chips"], e2e, per_layer, draw,
                kind, check)


@dataclass
class Window:
    """What one measured window served, on the host's clock: each block
    of answers as (pool rows (b,), dists (b, k), ids (b, k)), in the
    order served, and the requests never answered."""
    window_s: float
    blocks: List[tuple] = field(default_factory=list)
    failed: int = 0

    @property
    def answered(self) -> int:
        return sum(len(b[0]) for b in self.blocks)

    @property
    def attempted(self) -> int:
        return self.answered + self.failed

    def served_rows(self) -> np.ndarray:
        if not self.blocks:
            return np.zeros(0, np.int64)
        return np.concatenate([b[0] for b in self.blocks])


@dataclass
class Context:
    """What a metric's reader may read."""
    cell: Cell
    setup_s: float
    window: Window
    trace: Optional[trace.Trace]
    drawn: object
    _cache: dict = field(default_factory=dict)

    def scanned_rows(self) -> int:
        """Index rows the probes of every query the window answered hold,
        summed: the probes by the harness's own float32 CL over the drawn
        index, the rows by its cluster sizes."""
        if "rows" not in self._cache:
            svc = self.cell.config["service"]
            idx = self.drawn.index
            per_query = roofline.probed_rows(
                idx.centroids, idx.offsets[1:] - idx.offsets[:-1],
                self.drawn.queries, svc["nprobe"])
            self._cache["rows"] = int(
                per_query[self.window.served_rows()].sum())
        return self._cache["rows"]


def program_index(index):
    """The program's ``IVFPQIndex`` over a drawn CSR index's arrays."""
    from repro_torch.core.ivf import IVFPQIndex
    from repro_torch.core.pq import PQCodebook
    books = index.codebooks
    return IVFPQIndex(index.centroids,
                      PQCodebook(books, (books * books).sum(-1)),
                      index.codes, index.ids, index.offsets)


def _sync(device: str) -> Callable[[], None]:
    if device.startswith("cuda"):
        return torch.cuda.synchronize
    return lambda: None


def device_info(device: str) -> dict:
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def served_sample(window: Window, n: int, seed: int):
    """(pool rows, dists, ids) of the answers the check compares: at most
    ``n`` of the window's answers, drawn from the seed."""
    rng = np.random.default_rng([seed, 0xC4EC])
    sizes = np.asarray([len(b[0]) for b in window.blocks], np.int64)
    total = int(sizes.sum())
    pick = np.sort(rng.choice(total, size=min(n, total), replace=False))
    starts = np.cumsum(sizes) - sizes
    blk = np.searchsorted(starts, pick, side="right") - 1
    at = pick - starts[blk]
    rows = np.asarray([window.blocks[b][0][a] for b, a in zip(blk, at)],
                      np.int64)
    dd = np.stack([window.blocks[b][1][a] for b, a in zip(blk, at)])
    ii = np.stack([window.blocks[b][2][a] for b, a in zip(blk, at)])
    return rows, dd, ii


def _stamper(t_start: float, sync, log):
    """Logs the set-up's phases, seconds since process start."""
    def stamp(what: str) -> float:
        sync()
        t = time.perf_counter() - t_start
        log(f"annbench: {what} at {t:.3f} s")
        return t
    return stamp


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, root: Path = ROOT, device: str = "cuda",
        log=print) -> dict:
    """One run; returns the result line's object (``correct`` false where
    the check fails).  Raises where the run cannot be judged."""
    cell = load_cell(name, root)
    cfg, traffic = cell.config, cell.traffic
    from repro_torch.service import AnnService, ServiceSpec
    spec = ServiceSpec.from_dict(cfg["service"])
    sync = _sync(device)
    stamp = _stamper(t_start, sync, log)
    stamp("started")
    drawn = cell.draw.draw(cfg, traffic, seed, device,
                           cell.kind.pool_size(traffic, seconds))
    pool = drawn.queries.cpu().numpy()
    stamp("drawn")
    svc = AnnService.build(spec, index=program_index(drawn.index),
                           points=drawn.points,
                           sample_queries=pool[:SAMPLE_QUERIES],
                           device=device)
    stamp("built")
    cell.kind.warm(svc, traffic, pool)
    setup_s = stamp("warmed")

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(trace.WINDOW):
        window = cell.kind.run(svc, traffic, pool, seconds, seed, sync)
    if prof is not None:
        prof.stop()
    dev = device_info(device)
    tr = trace.collect(prof) if prof is not None else None
    svc.shutdown()
    del svc
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    ctx = Context(cell, setup_s, window, tr, drawn)
    metrics: Dict[str, dict] = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    del ctx

    rows, dd, ii = served_sample(window, traffic["check_sample"], seed)
    compared = cell.check.compare(
        cfg, drawn.index, drawn.queries[torch.as_tensor(
            rows, device=drawn.queries.device)], dd, ii)
    compared["unanswered"] = {"value": window.failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    stamp("judged")
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    out = {"correct": bool(correct), "attempted": int(window.attempted),
           "failed": int(window.failed), "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["compared"] = compared
    return out
