"""Multi-pod dry-run on the H100: rank 0's step of every (arch x shape x
mesh) cell, run on the card inside a one-process stand-in for the world.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b \
        --shape train_4k --mesh pod           # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

The reference (``src/repro/launch/dryrun.py``) lowers and compiles each
cell on 512 forced host devices and reads XLA's ``memory_analysis()`` and
``cost_analysis()``.  Torch has no ahead-of-time compiler for SPMD
programs; its counterpart is the "fake" process group
(``launch/mesh.py::fake_world``): this process is rank 0 of a world of 256
(or 512 for the pod mesh), parameters, AdamW moments and the batch are
DTensors sharded by the reference's rules, every collective is a no-op
with the right shapes, and the local program runs for real on the card.
So each cell gives, from the card itself, rank 0's peak memory
(``torch.cuda.max_memory_allocated`` against 80 GB: it fits or it does
not), its FLOPs on local shards and the bytes of each collective kind
(``roofline.StepCounter``, during the warm step) and the time of one step
with free collectives (CUDA events, the second step).  Values after a
no-op collective are garbage, so nothing here checks them: the tests hold
the sharded steps to one process on a real 4-process gloo group.

A cell that runs out of the card's memory is recorded with ``fits:
false`` and the request that failed, as the reference records a cell
whose temp size passes HBM; any other exception is a failure.  Records
go to ``experiments/dryrun_torch/<cell>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeCell
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as rooflib
from repro_torch.launch import specs as speclib
from repro_torch.launch import steps as steplib
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, AdamWState

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")

FSDP_THRESHOLD = 8e9     # params; above this, shard "embed" over data axis
# timed steps of the drim cell after its warm one: a ~1 ms step timed once
# moved 1.78 -> 8.45 ms between two runs of one process on the H100; the
# record's step_ms is their median
DRIM_TIMED_STEPS = 5

_HBM_SOURCE = ("analytic: roofline.analytic_roofline (torch has no "
               "counterpart of XLA's bytes accessed)")


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _batch_pspec(shape, mesh, dp):
    """The reference's per-leaf rule: batch on dim 0 (or dim 1 of a
    group-stacked cache leaf) over ``dp``; the trailing feature dim of 3-D+
    leaves over ``model`` when it divides."""
    sizes = meshlib.axis_sizes(mesh)
    nd = len(shape)
    if nd == 0:
        return meshlib.P()
    dpn = math.prod(sizes[a] for a in dp)
    dims = [None] * nd
    if shape[0] % dpn == 0 and shape[0] > 1:
        dims[0] = dp if len(dp) > 1 else dp[0]
    elif nd >= 2 and shape[1] % dpn == 0 and shape[1] > 1:
        dims[1] = dp if len(dp) > 1 else dp[0]
    msize = sizes.get("model", 1)
    if nd >= 3 and dims[-1] is None and shape[-1] % msize == 0 \
            and shape[-1] >= msize:
        dims[-1] = "model"
    return meshlib.P(*dims)


def _map_batch(fn, tree, n_groups=None):
    """``fn(leaf, n_groups)`` over a batch tree; ``n_groups`` is the
    number of groups for a leaf inside the caches' ``groups`` list (the
    reference stacks those leaves on a leading group axis)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, n_groups)
    if isinstance(tree, dict):
        return {k: _map_batch(fn, v, len(v) if k == "groups" else n_groups)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_batch(fn, v, n_groups) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_batch(fn, v, n_groups) for v in tree)
    return tree


def batch_pspecs(batch_specs, mesh, dp_axes=("pod", "data")):
    """The reference's ``_batch_shardings`` as PartitionSpecs, on the
    reference's view of each leaf: a leaf inside the caches' ``groups``
    list is specced as the stacked ``(n_groups, ...)`` leaf the reference
    holds."""
    names = meshlib.axis_sizes(mesh)
    dp = tuple(a for a in dp_axes if a in names)
    return _map_batch(
        lambda t, ng: _batch_pspec(
            tuple(t.shape) if ng is None else (ng,) + tuple(t.shape),
            mesh, dp), batch_specs)


def _batch_shardings(batch_specs, mesh, dp_axes=("pod", "data")):
    """Activations: batch dim over dp_axes; caches per logical role.  A
    per-group cache leaf takes the reference's stacked spec without its
    group entry; where the reference shards the group axis itself (the
    port's groups are a list, not an axis) the leaf is specced alone."""
    names = meshlib.axis_sizes(mesh)
    dp = tuple(a for a in dp_axes if a in names)

    def one(t, ng):
        shape = tuple(t.shape)
        if ng is None:
            spec = _batch_pspec(shape, mesh, dp)
        else:
            stacked = _batch_pspec((ng,) + shape, mesh, dp)
            spec = (meshlib.P(*stacked[1:]) if stacked[0] is None
                    else _batch_pspec(shape, mesh, dp))
        return meshlib.NamedSharding(mesh, spec)

    return _map_batch(one, batch_specs)


def _rules(cfg, sharding: str, n_params: int):
    """-> (param rules, optimizer rules or None, batch axes)."""
    opt_rules = None
    if sharding == "fsdp_dp":
        rules = {k: None for k in meshlib.BASE_RULES}
        rules["embed"] = "data"
        rules["batch"] = ("pod", "data", "model")
        dp_axes = ("pod", "data", "model")
    elif sharding == "zero1_dp":
        # pure DP: replicated bf16 params (no contraction resharding),
        # optimizer moments sharded over the whole mesh (ZeRO-1).
        rules = {k: None for k in meshlib.BASE_RULES}
        dp_axes = ("pod", "data", "model")
        opt_rules = {k: None for k in meshlib.BASE_RULES}
        opt_rules["embed"] = ("data", "model")
        opt_rules["mlp"] = None
    elif sharding == "tp":
        rules = meshlib.rules_for(cfg, fsdp=n_params > FSDP_THRESHOLD)
        dp_axes = ("pod", "data")
    else:
        raise ValueError(f"unknown sharding {sharding!r}")
    return rules, opt_rules, dp_axes


# ---------------------------------------------------------------------------
# rank 0's tensors, drawn on the device
# ---------------------------------------------------------------------------

def _draw(meta_tree, shardings, seed: int, device, kind: str):
    """Each leaf's local part on ``device`` as a DTensor of the global
    shape: ``"params"`` trunc-normal / sqrt(fan_in) (1-D leaves ones),
    ``"zeros"`` zeros in f32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(t, sh):
        local_shape = sh.shard_shape(t.shape)
        if kind == "zeros":
            local = torch.zeros(local_shape, dtype=torch.float32,
                                device=device)
        elif t.dim() == 1:
            local = torch.ones(local_shape, dtype=t.dtype, device=device)
        else:
            fan_in = t.shape[-2]
            local = torch.empty(local_shape, dtype=torch.float32,
                                device=device)
            torch.nn.init.trunc_normal_(local, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            local = local.mul_(1.0 / math.sqrt(fan_in)).to(t.dtype)
        return meshlib.to_dtensor(local, sh, t.shape)

    return meshlib.map_twin(one, meta_tree, shardings)


def _draw_batch(cfg, batch_meta, shardings, seed: int, device, cell):
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def one(t, sh):
        shape = sh.shard_shape(t.shape)
        if t.dtype in (torch.int32, torch.int64):
            local = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                  device=device, dtype=t.dtype)
        elif t.dim() == 0:
            local = torch.zeros((), dtype=t.dtype, device=device)
        else:
            local = torch.zeros(shape, dtype=t.dtype, device=device)
        return meshlib.to_dtensor(local, sh, t.shape)

    out = meshlib.map_twin(one, batch_meta, shardings)
    if "ctx" in out:
        out["ctx"].to_local().normal_(generator=gen)
    if "enc_out" in out:
        out["enc_out"].to_local().normal_(generator=gen)
    if "pos" in out:     # every row at the last position: the full cache
        out["pos"].to_local().fill_(cell.seq_len - 1)
    return out


# ---------------------------------------------------------------------------
# the world and the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _world(multi_pod: bool, device_type: str):
    """A fake world of 256 (512 for the pod mesh), or the one already up
    if it is a fake world of that size (``chip_smoke.py`` holds one of 256
    for its one-pod cells).  Any other group raises: on a real one the
    collectives would move data and rank 0 would not be measured alone."""
    import torch.distributed as dist
    n = 512 if multi_pod else 256
    if dist.is_initialized():
        backend, world = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or world != n:
            raise RuntimeError(
                f"the dry-run needs a fake world of {n}; the default "
                f"process group is {backend!r} of {world}")
        yield
        return
    with meshlib.fake_world(n, device_type):
        yield


def device_info(device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    name, limit = torch.cuda.get_device_name(dev), None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        name, limit = [x.strip() for x in out.stdout.strip().split(",")]
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    return {"name": name, "power_limit": limit}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_ms(fn, device) -> tuple:
    """(result, ms) of one call: CUDA events on the card, the host clock
    on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.OutOfMemoryError)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the dry-run runs on the card: no CUDA device "
                               "(pass --device cpu for the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _write(rec: dict, name: str, out_dir: pathlib.Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, cell: ShapeCell, multi_pod: bool,
             out_dir: pathlib.Path = ART_DIR, verbose: bool = True,
             overrides=None, sharding: str = "tp", tag: str = "",
             device="cuda", smoke: bool = False, seed: int = 0):
    """sharding: 'tp' (default TP-over-model [+FSDP >= 8B]), 'fsdp_dp'
    (batch over ALL axes, params ZeRO-3 over 'data', no TP) or 'zero1_dp'
    (replicated params, moments sharded over the mesh).  ``smoke`` takes
    the arch's smoke config (the tests' CPU size)."""
    t0 = time.time()
    dev = _resolve(device)
    cfg = registry.get_config(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh_name = "multipod512" if multi_pod else "pod256"
    name = f"{arch}__{cell.name}__{mesh_name}" + (f"__{tag}" if tag else "")
    pmeta, paxes = speclib.param_specs(cfg)
    n_params = sum(x.numel() for x in tree_leaves(pmeta))
    rules, opt_rules, dp_axes = _rules(cfg, sharding, n_params)
    rec = {"arch": arch, "shape": cell.name, "mesh": mesh_name,
           "n_params": n_params, "kind": cell.kind, "sharding": sharding,
           "tag": tag, "device": device_info(dev)}
    with _world(multi_pod, dev.type):
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                            device_type=dev.type)
        chips = mesh.size()
        rec["chips"] = chips
        pshard = meshlib.shardings_for_tree(pmeta, paxes, rules, mesh)
        batch_meta = speclib.input_specs(cfg, cell)
        bshard = _batch_shardings(batch_meta, mesh, dp_axes=dp_axes)
        run = _run_step(cfg, cell, mesh, pmeta, paxes, pshard, batch_meta,
                        bshard, opt_rules, dev, seed)
        del mesh
    _free(dev)
    ana = rooflib.analytic_roofline(cfg, cell, chips, multi_pod)
    run["hbm_bytes"] = ana["hbm_bytes_per_dev"]
    if run["fits"]:
        analysis = rooflib.analyze_step(run, chips)
        mf = rooflib.model_flops(cfg, cell)
        analysis["model_flops_total"] = mf
        total = analysis["per_device_flops"] * chips
        analysis["useful_flop_ratio"] = mf / total if total else None
    else:
        analysis = {"chips": chips, "per_device_flops": None,
                    "per_device_hbm_bytes": ana["hbm_bytes_per_dev"],
                    "per_device_collective_bytes": {"total": 0.0},
                    "terms_s": ana["terms_s"], "dominant": ana["dominant"],
                    "memory_analysis": {},
                    "model_flops_total": rooflib.model_flops(cfg, cell),
                    "useful_flop_ratio": None}
    rec.update(analysis)
    rec["analytic"] = {k: v for k, v in ana.items() if k != "terms_s"}
    rec["analytic_terms_s"] = ana["terms_s"]
    rec["hbm_bytes_source"] = _HBM_SOURCE
    for k in ("fits", "peak_bytes", "step_ms", "warm_ms", "oom",
              "flops_by_shape", "collectives_by_site"):
        rec[k] = run.get(k)
    rec["wall_s"] = time.time() - t0
    _write(rec, name, out_dir)
    if verbose:
        _print(name, rec)
    return rec


def _run_step(cfg, cell, mesh, pmeta, paxes, pshard, batch_meta, bshard,
              opt_rules, dev, seed):
    """Rank 0's tensors, one counted warm step and one timed step; an OOM
    anywhere is the cell's result (``fits: false``)."""
    cuda = dev.type == "cuda"
    out = {"fits": True, "oom": None}
    state = {}
    if cuda:
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        params = _draw(pmeta, pshard, seed, dev, "params")
        batch = _draw_batch(cfg, batch_meta, bshard, seed, dev, cell)
        state.update(params=params, batch=batch)
        if cell.kind == "train":
            mshard = (pshard if opt_rules is None else
                      meshlib.shardings_for_tree(pmeta, paxes, opt_rules,
                                                 mesh))
            opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                             mu=_draw(pmeta, mshard, seed, dev, "zeros"),
                             nu=_draw(pmeta, mshard, seed, dev, "zeros"))
            state["opt"] = opt
            step = steplib.make_train_step(cfg, AdamWConfig())

            def call():
                return step(state["params"], state["opt"], state["batch"])[2]
        elif cell.kind == "prefill":
            step = steplib.make_prefill_step(cfg)

            def call():
                return step(state["params"], state["batch"])
        else:
            step = steplib.make_decode_step(cfg)

            def call():
                return step(state["params"], state["batch"])[0]
        _sync(dev)
        arg_bytes = torch.cuda.memory_allocated(dev) if cuda else None
        counter = rooflib.StepCounter()
        with counter:
            res, warm_ms = _timed_ms(call, dev)
        out["output_bytes"] = sum(
            t.numel() * t.element_size() for t in (
                x.to_local() if hasattr(x, "to_local") else x
                for x in tree_leaves(res)))
        del res
        _, step_ms = _timed_ms(call, dev)
        out.update(flops=counter.flops, flops_by_shape=counter.top_shapes(),
                   collective_bytes=counter.collective_bytes(),
                   collectives_by_site=counter.top_collectives(),
                   warm_ms=warm_ms, step_ms=step_ms)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        out["peak_bytes"] = peak
        out["memory"] = {"argument_bytes": arg_bytes or 0,
                         "output_bytes": out["output_bytes"],
                         "peak_bytes": peak}
    except Exception as e:                       # noqa: BLE001
        if not (cuda and _is_oom(e)):
            raise
        out.update(fits=False, oom=str(e).splitlines()[0],
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
    finally:
        state.clear()
    return out


def _print(name, rec):
    t = rec["terms_s"]
    coll = rec["per_device_collective_bytes"]
    flops = rec["per_device_flops"]
    peak = rec["peak_bytes"]
    print(f"[{name}] fits={rec['fits']} step_ms={rec['step_ms']} "
          f"peak_bytes={peak} per_device_flops={flops} "
          f"collective_bytes={json.dumps(coll)} "
          f"compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
          f"collective={t['collective_s']:.4f}s dominant={rec['dominant']}"
          + (f" oom={rec['oom']!r}" if rec.get("oom") else ""), flush=True)
    for site, v in list((rec.get("collectives_by_site") or {}).items())[:3]:
        print(f"  {v['bytes']:.4g} B in {v['count']}: {site}", flush=True)


def _drim_shape(dcfg, chips: int) -> dict:
    """Rank 0's shard at the config's shape: slot provisioning ~ n_points
    / split_max split parts, x2 for duplication headroom, over all chips."""
    n_instances = 2 * max(dcfg.n_points // dcfg.split_max, dcfg.nlist)
    return {"slots": max(-(-n_instances // chips), 1),
            "cpart": dcfg.split_max, "tasks": dcfg.tasks_per_shard,
            "m": dcfg.m, "cb": dcfg.cb, "d": dcfg.dim,
            "queries": dcfg.queries_per_batch, "nlist": dcfg.nlist,
            "k": dcfg.k}


def drim_inputs(shape: dict, device, seed: int = 0) -> dict:
    """Rank 0's shard tensors of the drim cell, drawn on ``device``:
    uint8 codes in every slot (full split parts), the task table of
    ``tasks`` (query, slot) pairs, the replicated queries, centroids and
    the PQ codebook."""
    from repro_torch.core.pq import PQCodebook
    g = torch.Generator(device=device).manual_seed(seed)
    s, c, m, cb, d = (shape[k] for k in ("slots", "cpart", "m", "cb", "d"))
    t, q, nl = shape["tasks"], shape["queries"], shape["nlist"]
    dsub = d // m

    def ri(hi, size, dtype=torch.int32):
        return torch.randint(0, hi, size, generator=g, device=device,
                             dtype=dtype)

    books = torch.randn((m, cb, dsub), generator=g, device=device)
    return {
        "codes": ri(cb, (s, c, m), torch.uint8),
        "ids": ri(2 ** 31 - 1, (s, c)),
        "sizes": torch.full((s,), c, dtype=torch.int32, device=device),
        "cluster_of": ri(nl, (s,)),
        "qidx": ri(q, (t,)),
        "sidx": ri(s, (t,)),
        "queries": torch.randn((q, d), generator=g, device=device) * 20,
        "centroids": torch.randn((nl, d), generator=g, device=device) * 20,
        "codebook": PQCodebook(books, (books * books).sum(-1)),
    }


def drim_step(inp: dict, k: int, fused_scan: bool, quantize: bool,
              lut_dtype=None):
    """Rank 0's shard program: ``core/sharded_search.py::_shard_tasks_fn``
    (LC through A, B or A-bf16, then the fused DC+TS E, F or E-bf16) or,
    with ``fused_scan`` off, LC then DC (C, D or C-bf16) over the gathered
    slots and ``torch.topk``.  ``lut_dtype``: ``_shard_tasks_fn``'s (None,
    "f32" or "bf16"; ``quantize`` is the uint8 path).  -> ((T, k)
    distances, (T, k) ids)."""
    from repro_torch.core import sharded_search as ss
    from repro_torch.kernels import ops as kops
    args = (inp["codes"], inp["ids"], inp["sizes"], inp["cluster_of"],
            inp["qidx"], inp["sidx"], inp["queries"], inp["centroids"],
            inp["codebook"], None)
    if fused_scan:
        return ss._shard_tasks_fn(*args, k=k, strategy="gather",
                                  quantize=quantize, lut_dtype=lut_dtype)
    codes, ids, sizes, cluster_of, qidx, sidx = args[:6]
    valid = qidx >= 0
    si = sidx.clamp(0, codes.shape[0] - 1).long()
    lut = ss._task_lut(cluster_of, qidx, si, inp["queries"],
                       inp["centroids"], inp["codebook"], None, quantize,
                       lut_dtype)
    c, i, sz = kops.gather_slots(codes, ids, sizes, ss._task_slots(si, valid))
    dist = kops.pq_scan_dc(lut, c, sz)
    bd, pos = torch.topk(dist, k, dim=1, largest=False)
    bi = i.gather(1, pos)
    return bd, bi.masked_fill(~torch.isfinite(bd), -1)


def run_drim_ann_cell(multi_pod: bool, out_dir: pathlib.Path = ART_DIR,
                      fused_scan: bool = False, lut_dtype=None,
                      tag: str = "", device="cuda", seed: int = 0,
                      shape: dict | None = None):
    """The paper's own workload as a dry-run cell: rank 0's shard of the
    sharded search step at ``configs/drim_ann.py``'s 100M shape (the mesh
    axes act as one flat pool of shards; queries replicated, exactly the
    engine's layout; no collective, as the reference's out spec is
    ``P(shard_axes)``).  ``lut_dtype``: None / ``"f32"`` (A, then E or C),
    ``"uint8"`` (B, then F or D) or ``"bf16"`` (A-bf16, then E-bf16 or
    C-bf16: the reference's ``jnp.bfloat16``, record tag ``lut_bf16``).
    ``shape`` overrides the shard shape (the tests' small size).  After
    one warm step (FLOPs and collectives counted), ``step_ms`` is the
    median of ``DRIM_TIMED_STEPS`` timed ones (``step_ms_samples``)."""
    if lut_dtype not in (None, "f32", "uint8", "bf16"):
        raise ValueError(f"lut_dtype {lut_dtype!r}")
    from repro_torch.configs import drim_ann
    t0 = time.time()
    dev = _resolve(device)
    quant = lut_dtype == "uint8"
    bf16 = lut_dtype == "bf16"
    with _world(multi_pod, dev.type):
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                            device_type=dev.type)
        chips = mesh.size()
        del mesh
    dcfg = drim_ann.config()
    shp = dict(_drim_shape(dcfg, chips), **(shape or {}))
    mesh_name = "multipod512" if multi_pod else "pod256"
    if not tag:
        tag = "__".join(p for p in (("fused" if fused_scan else ""),
                                    (f"lut_{lut_dtype}" if lut_dtype
                                     else "")) if p)
    name = f"drim_ann__search_100m__{mesh_name}" + (f"__{tag}" if tag else "")
    cuda = dev.type == "cuda"
    if cuda:
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    inp = drim_inputs(shp, dev, seed)
    _sync(dev)
    arg_bytes = torch.cuda.memory_allocated(dev) if cuda else 0
    counter = rooflib.StepCounter()

    def step():
        return drim_step(inp, shp["k"], fused_scan, quant,
                         "bf16" if bf16 else None)
    with counter:
        (bd, bi), warm_ms = _timed_ms(step, dev)
    out_bytes = bd.numel() * 4 + bi.numel() * 4
    samples = [_timed_ms(step, dev)[1] for _ in range(DRIM_TIMED_STEPS)]
    step_ms = statistics.median(samples)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    work = rooflib.drim_search_work(shp["tasks"], shp["cpart"], shp["m"],
                                    shp["cb"], shp["d"] // shp["m"],
                                    shp["k"], quant, fused_scan,
                                    shp["slots"], bf16=bf16)
    analysis = rooflib.analyze_step(
        {"flops": work["flops"], "hbm_bytes": work["hbm_bytes"],
         "collective_bytes": counter.collective_bytes(),
         "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "peak_bytes": peak}}, chips)
    rec = {"arch": "drim_ann", "shape": "search_100m", "mesh": mesh_name,
           "chips": chips, "kind": "search", "tag": tag, **analysis,
           "device": device_info(dev), "shard_shape": shp,
           "code_bytes": shp["slots"] * shp["cpart"] * shp["m"],
           "flops_source": "kernel work formulas "
                           "(roofline.drim_search_work)",
           "hbm_bytes_source": "kernel work formulas "
                               "(roofline.drim_search_work)",
           "aten_flops": counter.flops,
           "fits": True, "peak_bytes": peak, "step_ms": step_ms,
           "step_ms_samples": samples, "warm_ms": warm_ms, "oom": None,
           "wall_s": time.time() - t0}
    _write(rec, name, out_dir)
    del inp, bd, bi
    _free(dev)
    _print(name, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS + ("drim_ann",))
    ap.add_argument("--shape", choices=tuple(registry.SHAPES_BY_NAME))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fused-scan", action="store_true",
                    help="drim_ann cell: the fused DC+TS kernel (E / F)")
    ap.add_argument("--lut-dtype", choices=("f32", "bf16", "uint8"),
                    default=None,
                    help="drim_ann cell: LUT dtype (uint8 = the quantized "
                         "path, B then F or D; bf16 = A-bf16 then E-bf16 "
                         "or C-bf16)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=str(ART_DIR))
    args = ap.parse_args(argv)
    meshes = {"pod": (False,), "multipod": (True,),
              "both": (False, True)}[args.mesh]
    out_dir = pathlib.Path(args.out_dir)
    lut_dtype = None if args.lut_dtype == "f32" else args.lut_dtype

    failures = []
    if args.all:
        for mp in meshes:
            run_drim_ann_cell(mp, out_dir, fused_scan=args.fused_scan,
                              lut_dtype=lut_dtype, device=args.device)
        for (a, s, skip) in registry.all_cells():
            for mp in meshes:
                mesh_name = "multipod512" if mp else "pod256"
                if skip:
                    print(f"[{a}__{s.name}__{mesh_name}] {skip}")
                    continue
                fname = out_dir / f"{a}__{s.name}__{mesh_name}.json"
                if args.skip_existing and fname.exists():
                    continue
                try:
                    run_cell(a, s, mp, out_dir, device=args.device)
                except Exception as e:           # noqa: BLE001
                    traceback.print_exc()
                    failures.append((a, s.name, mesh_name, repr(e)))
                    _free(args.device)
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("ALL CELLS OK")
        return
    if args.arch == "drim_ann":
        for mp in meshes:
            run_drim_ann_cell(mp, out_dir, fused_scan=args.fused_scan,
                              lut_dtype=lut_dtype, device=args.device)
        return
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape (or --all)")
    cell = registry.SHAPES_BY_NAME[args.shape]
    for mp in meshes:
        run_cell(args.arch, cell, mp, out_dir, device=args.device)


if __name__ == "__main__":
    main()
