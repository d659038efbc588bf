"""The dry-run (``launch/dryrun.py``), its roofline (``launch/roofline.py``)
and the two post-processors, against the reference.

* ``_batch_shardings`` of every cell's inputs equals the reference's: the
  reference's specs come from one subprocess with 512 forced host devices
  (``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported, so it is never
  imported in this process), the port's from a stand-in mesh, on both
  production shapes and both batch layouts (``("pod", "data")`` and the
  DP shardings' all-axes batch).
* ``analytic_roofline``'s FLOPs and bytes and ``model_flops`` equal the
  reference's exactly for every (arch x shape x mesh) cell; its terms are
  those over the H100's constants.
* ``run_cell`` and ``run_drim_ann_cell`` on the CPU under a fake world of
  256, at the smoke configs and small cells, for every arch and kind: the
  reference's record keys and the card's own, ``per_device_flops`` equal
  to this file's own count of the local matmuls' shapes.  The
  post-processors over those records.  The drim cell's ``--lut-dtype
  bf16`` is held to the reference in ``test_torch_bf16_lut.py``.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs

from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeCell
from repro_torch.launch import dryrun, roofline, roofline_patch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline_report, specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s.name) for a, s, skip in registry.all_cells() if not skip]
MESHES = {"pod256": ((16, 16), ("data", "model")),
          "multipod512": ((2, 16, 16), ("pod", "data", "model"))}
DP = {"tp": ("pod", "data"), "dp": ("pod", "data", "model")}


class StandIn:
    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


_REF_BATCH = textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as D          # sets XLA_FLAGS first
    import jax
    from repro.configs import registry
    from repro.launch import mesh as meshlib, specs as speclib
    DP = {"tp": ("pod", "data"), "dp": ("pod", "data", "model")}

    def key(path):
        out = []
        for k in path:
            for attr in ("key", "name", "idx"):
                if hasattr(k, attr):
                    out.append(str(getattr(k, attr)))
                    break
        return "/".join(out)

    res = {}
    for mp in (False, True):
        mesh = meshlib.make_production_mesh(multi_pod=mp)
        mname = "multipod512" if mp else "pod256"
        for a, s, skip in registry.all_cells():
            if skip:
                continue
            cfg = registry.get_config(a)
            bs = speclib.input_specs(cfg, s)
            for dn, dp in DP.items():
                name = f"{a}__{s.name}__{mname}__{dn}"
                try:
                    sh = D._batch_shardings(bs, mesh, cfg, dp_axes=dp)
                except Exception as e:       # an axis used twice
                    res[name] = {"error": type(e).__name__}
                    continue
                flat = jax.tree_util.tree_flatten_with_path(sh)[0]
                res[name] = {
                    key(p): [list(e) if isinstance(e, tuple) else e
                             for e in tuple(x.spec)] for p, x in flat}
    json.dump(res, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def ref_batch(tmp_path_factory):
    out = tmp_path_factory.mktemp("batch") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_BATCH, str(out)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text())


def _port_specs(tree, path=()):
    """{path: spec} of ``dryrun.batch_pspecs``' tree, a ``groups`` list
    read as the reference's one stacked leaf."""
    out = {}
    if isinstance(tree, dryrun.meshlib.PartitionSpec):
        out["/".join(path)] = [list(e) if isinstance(e, tuple) else e
                               for e in tree]
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_specs(v[0] if k == "groups" else v,
                                   path + (k,)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_port_specs(getattr(tree, f), path + (f,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_port_specs(v, path + (str(i),)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_shardings_equal_reference(ref_batch, arch, shape, mesh_name):
    cfg = registry.get_config(arch)
    cell = registry.SHAPES_BY_NAME[shape]
    stand = StandIn(*MESHES[mesh_name])
    meta = specs.input_specs(cfg, cell)
    for dn, dp in DP.items():
        want = ref_batch[f"{arch}__{shape}__{mesh_name}__{dn}"]
        if "error" in want:
            # the reference's rule puts "model" on the batch and on the
            # trailing dim of a 3-D leaf, and jax refuses the spec
            with pytest.raises(ValueError, match="twice"):
                dryrun._batch_shardings(meta, stand, dp)
            continue
        got = _port_specs(dryrun.batch_pspecs(meta, stand, dp))
        assert got == want, (dn, {k: (got.get(k), want.get(k))
                                  for k in set(got) | set(want)
                                  if got.get(k) != want.get(k)})
        # the port's per-group cache leaves: the reference's stacked spec
        # without its group entry (the batch on the leaf's dim 0 where the
        # reference puts it on dim 1)
        shard = dryrun._batch_shardings(meta, stand, dp)
        groups = (shard.get("caches") or {}).get("groups", [])
        for g in groups:
            got_g = _port_specs({"caches": {"groups": [g]}})
            for k, spec in got_g.items():
                if want[k][0] is None:
                    assert list(spec) == want[k][1:], k


_REF_COUNT = functools.lru_cache(maxsize=None)(
    ref_specs.count_params_analytic)
_PORT_COUNT = functools.lru_cache(maxsize=None)(specs.count_params_analytic)
ALL = [(a, s.name) for a, s, _ in registry.all_cells()]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", ALL)
def test_analytic_roofline_equals_reference(monkeypatch, arch, shape,
                                            multi_pod):
    # the parameter counts (already held equal in test_torch_models.py)
    # are cached across cells: the configs are frozen and hashable
    monkeypatch.setattr(ref_specs, "count_params_analytic", _REF_COUNT)
    monkeypatch.setattr(specs, "count_params_analytic", _PORT_COUNT)
    cfg, rcfg = registry.get_config(arch), ref_registry.get_config(arch)
    cell = registry.SHAPES_BY_NAME[shape]
    rcell = ref_registry.SHAPES_BY_NAME[shape]
    chips = 512 if multi_pod else 256
    got = roofline.analytic_roofline(cfg, cell, chips, multi_pod)
    want = ref_roofline.analytic_roofline(rcfg, rcell, chips, multi_pod)
    for k in ("exec_flops", "hbm_bytes_per_dev", "collective_bytes_per_dev"):
        assert got[k] == want[k], k
    assert roofline.model_flops(cfg, cell) == ref_roofline.model_flops(
        rcfg, rcell)
    assert roofline._cache_bytes(cfg, 8, 1024) == ref_roofline._cache_bytes(
        rcfg, 8, 1024)
    for frac in (1.0, 0.5):
        assert roofline._attn_flops_fwd(cfg, cell, frac) == \
            ref_roofline._attn_flops_fwd(rcfg, rcell, frac)
    t = got["terms_s"]
    assert t["compute_s"] == got["exec_flops"] / (
        chips * roofline.PEAK_FLOPS_BF16)
    assert t["memory_s"] == got["hbm_bytes_per_dev"] / roofline.HBM_BW
    assert t["collective_s"] == got["collective_bytes_per_dev"] / \
        roofline.NVLINK_BW
    assert got["dominant"] == max(t, key=t.get)


def test_h100_constants():
    assert roofline.PEAK_FLOPS_BF16 == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert "H100" in roofline.DEVICE and "700 W" in roofline.DEVICE


# ---------------------------------------------------------------------------
# run_cell / run_drim_ann_cell on the CPU under a fake world of 256
# ---------------------------------------------------------------------------

SMALL = {"train": ShapeCell("train_s", 32, 32, "train"),
         "prefill": ShapeCell("prefill_s", 64, 32, "prefill"),
         "decode": ShapeCell("decode_s", 64, 32, "decode")}
REF_KEYS = {"arch", "shape", "mesh", "chips", "n_params", "kind",
            "sharding", "tag", "per_device_flops", "per_device_hbm_bytes",
            "per_device_collective_bytes", "terms_s", "dominant",
            "memory_analysis", "model_flops_total", "useful_flop_ratio"}
CARD_KEYS = {"device", "peak_bytes", "step_ms", "fits"}


def _matmul_counter():
    """This file's own count: 2 M N K of every local (b)mm / addmm /
    baddbmm the step runs, from the shapes of its operands."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t.__name__ == "DTensor" for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            fake = out.is_meta or type(out).__name__ == "FakeTensor" \
                if isinstance(out, torch.Tensor) else True
            pkt = func._overloadpacket
            if not fake and pkt in (aten.mm, aten.bmm, aten.addmm,
                                    aten.baddbmm):
                a, b = ((args[1], args[2]) if pkt in (aten.addmm,
                                                      aten.baddbmm)
                        else (args[0], args[1]))
                Count.total += 2 * a.numel() * b.shape[-1]
            return out
    return Count


@pytest.fixture
def counted(monkeypatch):
    """The dry-run's StepCounter, with this file's count beside it."""
    box = {}
    mine = _matmul_counter()
    orig = roofline.StepCounter

    class Both:
        def __init__(self):
            self.inner, self.mine = orig(), mine()

        def __enter__(self):
            mine.total = 0
            self.mine.__enter__()
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            self.inner.__exit__(*exc)
            self.mine.__exit__(*exc)
            box["mine"] = mine.total

        @property
        def flops(self):
            return self.inner.flops

        def collective_bytes(self):
            return self.inner.collective_bytes()

        def top_shapes(self):
            return self.inner.top_shapes()

        def top_collectives(self):
            return self.inner.top_collectives()

    monkeypatch.setattr(roofline, "StepCounter", Both)
    return box


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_run_cell_on_cpu_under_fake_world(tmp_path, counted, arch, kind):
    import torch.distributed as dist
    rec = dryrun.run_cell(arch, SMALL[kind], False, tmp_path, verbose=False,
                          device="cpu", smoke=True)
    assert not dist.is_initialized()
    assert REF_KEYS | CARD_KEYS <= set(rec)
    assert rec["chips"] == 256 and rec["mesh"] == "pod256"
    assert rec["fits"] is True and rec["step_ms"] > 0
    assert rec["per_device_flops"] == counted["mine"] > 0
    assert rec["per_device_collective_bytes"]["total"] == sum(
        v for k, v in rec["per_device_collective_bytes"].items()
        if k != "total")
    sites = rec["collectives_by_site"]
    assert sum(v["bytes"] for v in sites.values()) <= \
        rec["per_device_collective_bytes"]["total"]
    assert all(" | " in k and v["count"] > 0 for k, v in sites.items())
    assert rec["per_device_hbm_bytes"] == rec["analytic"]["hbm_bytes_per_dev"]
    saved = json.loads((tmp_path / f"{arch}__{SMALL[kind].name}__pod256"
                                   ".json").read_text())
    assert saved["per_device_flops"] == rec["per_device_flops"]


@pytest.mark.parametrize("sharding", ["fsdp_dp", "zero1_dp"])
def test_run_cell_dp_shardings_on_cpu(tmp_path, sharding):
    rec = dryrun.run_cell("mamba2_2p7b", SMALL["train"], False, tmp_path,
                          verbose=False, device="cpu", smoke=True,
                          sharding=sharding, tag=sharding)
    assert rec["sharding"] == sharding and rec["fits"]
    assert (tmp_path / f"mamba2_2p7b__train_s__pod256__{sharding}.json"
            ).exists()


def test_run_cell_multipod_on_cpu(tmp_path):
    rec = dryrun.run_cell("qwen3_14b", SMALL["decode"], True, tmp_path,
                          verbose=False, device="cpu", smoke=True)
    assert rec["chips"] == 512 and rec["mesh"] == "multipod512"


DRIM_SMALL = {"slots": 4, "cpart": 64, "tasks": 32, "queries": 16,
              "nlist": 8}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lut", [None, "uint8"])
def test_run_drim_ann_cell_on_cpu(tmp_path, fused, lut):
    rec = dryrun.run_drim_ann_cell(False, tmp_path, fused_scan=fused,
                                   lut_dtype=lut, device="cpu",
                                   shape=DRIM_SMALL)
    assert REF_KEYS - {"n_params", "sharding", "model_flops_total",
                       "useful_flop_ratio"} <= set(rec)
    assert CARD_KEYS <= set(rec)
    assert rec["per_device_collective_bytes"] == {"total": 0}
    shp = rec["shard_shape"]
    assert shp["slots"] == 4 and shp["m"] == 16 and shp["cb"] == 256
    work = roofline.drim_search_work(32, 64, 16, 256, 8, 10, lut == "uint8",
                                     fused, 4)
    assert rec["per_device_flops"] == work["flops"]


def test_drim_cell_is_rank0_shard_program():
    """drim_step's fused and unfused paths agree on rank 0's tensors."""
    shp = dict(dryrun._drim_shape(
        __import__("repro_torch.configs.drim_ann",
                   fromlist=["config"]).config(), 256), **DRIM_SMALL)
    inp = dryrun.drim_inputs(shp, torch.device("cpu"))
    for quant in (False, True):
        d1, i1 = dryrun.drim_step(inp, shp["k"], True, quant)
        d2, i2 = dryrun.drim_step(inp, shp["k"], False, quant)
        torch.testing.assert_close(d1, d2, rtol=1e-5, atol=1e-4)
        assert d1.shape == (32, 10)


def test_drim_shape_at_the_paper_config():
    from repro_torch.configs import drim_ann
    shp = dryrun._drim_shape(drim_ann.config(), 256)
    assert (shp["slots"], shp["cpart"], shp["m"], shp["tasks"]) == (
        512, 4096, 16, 8192)
    assert shp["slots"] * shp["cpart"] * shp["m"] == 33_554_432
    assert dryrun._drim_shape(drim_ann.config(), 512)["slots"] == 256


def test_cuda_is_the_default_device():
    import inspect
    for fn in (dryrun.run_cell, dryrun.run_drim_ann_cell):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.run_drim_ann_cell(False)


def test_patch_and_report_over_records(tmp_path, capsys):
    dryrun.run_cell("qwen3_14b", SMALL["prefill"], False, tmp_path,
                    verbose=False, device="cpu", smoke=True)
    dryrun.run_drim_ann_cell(False, tmp_path, device="cpu",
                             shape=DRIM_SMALL)
    # the patch reads the published config of the record's arch
    p = tmp_path / "qwen3_14b__prefill_s__pod256.json"
    r = json.loads(p.read_text())
    r["shape"] = "prefill_32k"
    p.write_text(json.dumps(r))
    # run_cell writes the analytic terms itself: the patch refuses such a
    # record and writes nothing
    with pytest.raises(ValueError, match="analytic_terms_s"):
        roofline_patch.patch(tmp_path)
    assert json.loads(p.read_text()) == r
    # the reference's record layout, counted terms only: patched
    counted = r["terms_s"]
    del r["analytic_terms_s"]
    p.write_text(json.dumps(r))
    assert roofline_patch.patch(tmp_path) == 1
    r = json.loads(p.read_text())
    ana = roofline.analytic_roofline(
        registry.get_config("qwen3_14b"),
        registry.SHAPES_BY_NAME["prefill_32k"], 256, False)
    assert r["terms_s"] == ana["terms_s"] and r["counted_terms_s"] == counted
    recs = roofline_report.load_records(None, tmp_path)
    assert len(recs) == 2
    # the roofline table reads a record's analytic terms, the card table
    # its counted ones
    r = next(x for x in recs if x["arch"] == "qwen3_14b")
    r["analytic_terms_s"], r["terms_s"] = ana["terms_s"], counted
    roof = roofline_report.roofline_table([r])
    assert f"{ana['terms_s']['compute_s']:.4f}" in roof
    assert f"{counted['compute_s']:.4f}" in roofline_report.card_table([r])
    coll = roofline_report.collective_table(recs)
    assert coll.count("\n") == 2 and "qwen3_14b__prefill_32k" in coll
    assert coll.splitlines()[-1].count("|") == 7
    table = roofline_report.dryrun_table(recs)
    assert "| fits |" in table and "step ms" in table
    assert table.count("\n") == 3
    roofline_report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Roofline table" in out and "dominant-term histogram" in out
    card = roofline_report.card_table(recs)
    assert card.count("\n") == 3 and "| True |" in card


@pytest.mark.parametrize("group", ["fake_4", "gloo_1"])
def test_dry_run_refuses_a_group_other_than_its_fake_world(group):
    """Under any default group but a fake world of the mesh's size the
    dry-run raises: its collectives would not be the no-ops it counts."""
    import torch.distributed as dist
    if group == "fake_4":
        ctx = meshlib.fake_world(4, "cpu")
    else:
        ctx = _gloo_world_of_one()
    with ctx:
        with pytest.raises(RuntimeError, match="fake world of 256"):
            dryrun.run_drim_ann_cell(False, device="cpu", shape=DRIM_SMALL)
    assert not dist.is_initialized()


@contextlib.contextmanager
def _gloo_world_of_one():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_perf_summary_holds_only_what_the_card_measured():
    from repro_torch.launch import perf_iterations
    terms = {"compute_s": 1.0, "memory_s": 0.5, "collective_s": 0.25}

    def rec(cell, variant, card):
        return {"cell": cell, "variant": variant, "terms_s": terms,
                "card": card}

    def card(fits, step):
        return {"fits": fits, "peak_bytes": 7, "step_ms": step,
                "per_device_flops": 1.0, "oom": None if fits else "OOM"}

    s = perf_iterations.summarize([
        rec("a", "baseline", card(True, 10.0)),
        rec("a", "napkin", None),
        rec("a", "bigger", card(False, None)),
        rec("b", "baseline", card(True, 10.0)),
        rec("b", "faster", card(True, 5.0)),
    ])
    assert set(s["a"]["measured"]) == {"baseline", "bigger"}
    assert s["a"]["fastest_fitting"] == "baseline"
    assert s["a"]["measured"]["bigger"] == {"fits": False, "peak_bytes": 7,
                                            "step_ms": None}
    assert s["a"]["measured"]["baseline"]["analytic_terms_s"] == terms
    assert s["b"]["fastest_fitting"] == "faster"
