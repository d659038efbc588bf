"""The LM's production mesh and sharding rules (``launch/mesh.py``), the
parameter trees' logical axes, ``roofline.StepCounter`` and the
sharded train step, against the reference.

* The axes tree of every arch at its published config equals the
  reference's ``init_params`` axes (the port's ``groups`` list read as the
  reference's stacked leaves, ``("layers",) + axes``), with the same
  leaves and parameter count.
* ``rules_for``, ``resolve_pspec`` and the shard shapes equal the
  reference's for every leaf of every arch under each sharding of the
  dry-run, on both production shapes.  The reference's ``resolve_pspec``
  reads only ``mesh.axis_names`` and ``mesh.devices.shape``, so a
  stand-in object serves in-process (no 512 forced devices here).
* ``StepCounter`` on a small DTensor program under a fake world of 4: a
  known all-gather, all-reduce and reduce-scatter, FLOPs counted on the
  local shards, and the port's lines named as the sites of collectives.
* On a real 4-process gloo group on a (2, 2) mesh (one spawn for the
  module, ``tests/torch_gloo_worker.py``): the sharded train step of a
  dense, an MoE and an SSD arch equals the one-process port (loss at rtol
  1e-5, gradient norm too, gradients and updated parameters within 1e-3
  of each leaf's scale; the worst measured is 8.9e-06 of a leaf's
  scale, the MoE's parameters); from the reference's weights it equals
  the reference's loss; and
  ``restore(shardings=)`` of the one-process checkpoint puts on every
  rank exactly the slice its placements name, on (2, 2) and on
  ``plan_elastic_mesh``'s (4, 1).
"""

import functools
import json
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import registry as ref_registry
from repro.launch import mesh as ref_mesh
from repro.launch import specs as ref_specs
from repro.launch import steps as ref_steps
from repro.optim import adamw as ref_adamw

from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline
from repro_torch.launch import specs
from repro_torch.launch.dryrun import _rules
from repro_torch.models.common import count_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = registry.ARCH_IDS
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-3                 # of each leaf's scale (test_torch_train.py)


class StandIn:
    """The two attributes the reference's resolve_pspec reads."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


MESHES = {"pod256": ((16, 16), ("data", "model")),
          "multipod512": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """{path: (stacked shape, axes)} of the reference's param specs."""
    shapes, axes = ref_specs.param_specs(ref_registry.get_config(arch))
    out = {}

    def walk(s, a, path):
        if isinstance(s, dict):
            for k in s:
                walk(s[k], a[k], path + (k,))
        else:
            out["/".join(path)] = (tuple(s.shape), tuple(a))
    walk(shapes, axes, ())
    return out


@functools.lru_cache(maxsize=None)
def _port_tree(arch):
    """{path: (stacked shape, stacked axes, per-group shape, axes)} of the
    port's param specs; ``groups`` read as the reference's stacked view."""
    meta, axes = specs.param_specs(registry.get_config(arch))
    out = {}

    def walk(s, a, path, n_groups):
        if isinstance(s, dict):
            for k in s:
                if k == "groups":
                    assert all(g == a[k][0] for g in a[k])   # one axes a group
                    walk(s[k][0], a[k][0], path + (k,), len(s[k]))
                else:
                    walk(s[k], a[k], path + (k,), n_groups)
        else:
            shape, ax = tuple(s.shape), tuple(a)
            stacked = ((n_groups,) + shape, ("layers",) + ax) \
                if n_groups else (shape, ax)
            out["/".join(path)] = stacked + (shape, ax)
    walk(meta, axes, (), None)
    return out, meta, axes


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_equals_reference(arch):
    ref = _ref_tree(arch)
    port, meta, _ = _port_tree(arch)
    assert set(port) == set(ref)
    for k, (shape, ax, _, _) in port.items():
        assert (shape, ax) == ref[k], k
    assert count_params(meta) == sum(math.prod(s) for s, _ in ref.values())


def _ref_rules(cfg, mode, n_params):
    """The reference's rules for each sharding of its ``run_cell``
    (``src/repro/launch/dryrun.py``), and ``rules_for``."""
    if mode == "tp":
        return ref_mesh.rules_for(cfg, fsdp=n_params > 8e9)
    if mode == "tp_fsdp":
        return ref_mesh.rules_for(cfg, fsdp=True)
    if mode == "tp_nofsdp":
        return ref_mesh.rules_for(cfg, fsdp=False)
    rules = {k: None for k in ref_mesh.BASE_RULES}
    if mode == "fsdp_dp":
        rules["embed"] = "data"
        rules["batch"] = ("pod", "data", "model")
    elif mode == "zero1_opt":
        rules["embed"] = ("data", "model")
        rules["mlp"] = None
    return rules


def _port_rules(cfg, mode, n_params):
    if mode == "tp_fsdp":
        return M.rules_for(cfg, fsdp=True)
    if mode == "tp_nofsdp":
        return M.rules_for(cfg, fsdp=False)
    if mode == "zero1_opt":
        return _rules(cfg, "zero1_dp", n_params)[1]
    return _rules(cfg, mode, n_params)[0]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", ["tp", "tp_fsdp", "tp_nofsdp", "fsdp_dp",
                                  "zero1_dp", "zero1_opt"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_specs_and_shard_shapes_equal_reference(arch, mode, mesh_name):
    cfg, rcfg = registry.get_config(arch), ref_registry.get_config(arch)
    port, meta, axes = _port_tree(arch)
    n_params = count_params(meta)
    rules = _port_rules(cfg, mode, n_params)
    assert rules == _ref_rules(rcfg, mode, n_params)
    stand = StandIn(*MESHES[mesh_name])
    sizes = dict(zip(stand.axis_names, stand.devices.shape))
    shardings = M.shardings_for_tree(meta, axes, rules, stand)
    flat = {}

    def walk(s, path):
        if isinstance(s, M.NamedSharding):
            flat["/".join(path)] = s
        elif isinstance(s, dict):
            for k in s:
                walk(s[k] if k != "groups" else s[k][0], path + (k,))
    walk(shardings, ())
    for k, (shape, ax, gshape, _) in port.items():
        want = tuple(ref_mesh.resolve_pspec(shape, ax, rules, stand))
        got = flat[k].spec
        if len(shape) == len(gshape):
            assert tuple(got) == want, k
        else:                    # the stacked view: "layers" is replicated
            assert want[0] is None and tuple(got) == want[1:], k
        assert tuple(M.resolve_pspec(shape, ax, rules, stand)) == want
        # shard shape: each dim over the product of its axes
        ref_shard = []
        for dim, entry in zip(gshape, want[len(shape) - len(gshape):]):
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(sizes[a] for a in names if a is not None)
            assert dim % n == 0
            ref_shard.append(dim // n)
        assert flat[k].shard_shape(gshape) == tuple(ref_shard), k


def test_partition_spec_and_placements():
    stand = StandIn(*MESHES["multipod512"])
    sh = M.NamedSharding(stand, M.P(("pod", "data"), None, "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    # pod-major: (pod 1, data 3) holds block 1 * 16 + 3 of dim 0
    assert sh.local_slices((64, 3, 32), (1, 3, 5)) == (
        slice(38, 40), slice(0, 3), slice(10, 12))
    assert M.NamedSharding(stand, M.P()).placements == (Replicate(),) * 3
    assert repr(M.P("data", None)) == "PartitionSpec('data', None)"
    with pytest.raises(ValueError):
        M.NamedSharding(stand, M.P(("data", "pod")))


def test_production_mesh_under_fake_world():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with M.fake_world(512, "cpu"):
        for mp, shape in ((False, (16, 16)), (True, (2, 16, 16))):
            mesh = M.make_production_mesh(multi_pod=mp, device_type="cpu")
            assert tuple(mesh.mesh.shape) == shape
            assert list(mesh.get_coordinate()) == [0] * len(shape)
        with pytest.raises(RuntimeError):
            M.fake_world(4, "cpu").__enter__()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        M.make_production_mesh(device_type="cpu")
    with M.fake_world(256, "cpu"):
        with pytest.raises(ValueError):
            M.make_production_mesh(multi_pod=True, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                M.make_production_mesh()
    assert not dist.is_initialized()


def test_distribute_tree_slices_locally():
    with M.fake_world(256, "cpu"):
        mesh = M.make_production_mesh(device_type="cpu")
        t = torch.arange(32 * 3 * 64, dtype=torch.float32).reshape(32, 3, 64)
        tree = {"a": t, "b": [t[0]]}
        sh = {"a": M.NamedSharding(mesh, M.P("data", None, "model")),
              "b": [M.NamedSharding(mesh, M.P(None, "model"))]}
        out = M.distribute_tree(tree, sh)
        a = out["a"]
        assert a.shape == t.shape and a.to_local().shape == (2, 3, 4)
        assert torch.equal(a.to_local(), t[:2, :, :4])
        assert torch.equal(out["b"][0].to_local(), t[0][:, :4])
        a.to_local().zero_()
        assert t.sum() > 0             # a copy, as jax.device_put makes


def test_collective_bytes_of_a_known_program():
    """The counterpart of the reference's test_collective_bytes_parser:
    a Shard -> Replicate all-gather, a Partial -> Replicate all-reduce and
    a Partial -> Shard reduce-scatter of an (8, 16) f32 tensor on 4 ranks,
    summed by result bytes; a local matmul's FLOPs on the local shapes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with M.fake_world(4, "cpu"):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.ones(2, 16), mesh, [Shard(0)])
        p = DTensor.from_local(torch.ones(8, 16), mesh, [Partial()])
        with roofline.StepCounter() as c:
            x.redistribute(mesh, [Replicate()])
            p.redistribute(mesh, [Replicate()])
            p.redistribute(mesh, [Shard(0)])
        assert c.collective_bytes() == {"all-gather": 512.0,
                                        "all-reduce": 512.0,
                                        "reduce-scatter": 128.0,
                                        "total": 1152.0}
        a = DTensor.from_local(torch.ones(8, 64), mesh, [Shard(0)])
        b = DTensor.from_local(torch.ones(64, 32), mesh, [Replicate()])
        with roofline.StepCounter() as c:
            a @ b
        assert c.flops == 2 * 8 * 64 * 32      # global: 4x that
        assert c.collective_bytes() == {"total": 0}


def test_step_counter_names_the_sites_of_collectives():
    """The port's rmsnorm on an activation sharded on its last dim: the
    forward all-reduces the (8, 1) mean of squares at the port's line, the
    backward reduce-scatters an (8, 4) gradient, named by its autograd
    node and the forward line that made the node."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import layers
    with M.fake_world(4, "cpu"):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        x = DTensor.from_local(torch.ones(8, 4, requires_grad=True), mesh,
                               [Shard(1)])
        w = DTensor.from_local(torch.ones(16), mesh, [Replicate()])
        with roofline.StepCounter() as c:
            layers.rmsnorm(w, x).sum().backward()
        top = c.top_collectives()
    assert sum(v["bytes"] for v in top.values()) == \
        c.collective_bytes()["total"] == 288.0
    fwd = [k for k in top if k.startswith("all-reduce [8, 1] float32 | ")]
    bwd = [k for k in top if k.startswith("reduce-scatter [8, 4] float32 | "
                                          "bwd MulBackward0 @ ")]
    assert len(fwd) == 1 and len(bwd) == 1, top
    assert top[fwd[0]] == {"count": 1, "bytes": 32.0}
    assert top[bwd[0]] == {"count": 2, "bytes": 256.0}
    for k in fwd + bwd:
        assert k.endswith(" rmsnorm") and "models/layers.py:" in k


# ---------------------------------------------------------------------------
# a real 4-process gloo group
# ---------------------------------------------------------------------------

GLOO_ARCHS = ("qwen3_14b", "qwen2_moe_a2p7b", "mamba2_2p7b")
B, S = 4, 16


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One spawn of four processes for every check; the reference's
    weights and losses from this process."""
    d = tmp_path_factory.mktemp("gloo")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 512, (B, S), dtype=np.int32),
             "labels": rng.integers(0, 512, (B, S), dtype=np.int32)}
    weights, ref_loss = {}, {}
    for arch in GLOO_ARCHS:
        rcfg = ref_registry.get_config(arch, smoke=True)
        assert rcfg.vocab_size == 512
        rparams, _ = R.init_params(jax.random.PRNGKey(0), rcfg)
        weights[arch] = jax.tree.map(np.asarray, rparams)
        step = jax.jit(ref_steps.make_train_step(rcfg,
                                                 ref_adamw.AdamWConfig()))
        _, _, m = step(rparams, ref_adamw.init(rparams),
                       {k: jnp.asarray(v) for k, v in batch.items()})
        ref_loss[arch] = float(m["loss"])
    inp = {"archs": GLOO_ARCHS, "batch": batch, "ref_weights": weights}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "torch_gloo_worker.py"),
                        str(d / "in.pkl"), str(d / "out.json")],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((d / "out.json").read_text()), ref_loss


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_train_step_equals_one_process(gloo, arch):
    res = gloo[0][arch]
    assert res["n_sharded"] > 0
    assert res["loss"] == pytest.approx(res["loss_one"], rel=LOSS_RTOL)
    assert res["grad_norm"] == pytest.approx(res["grad_norm_one"],
                                             rel=LOSS_RTOL)
    assert res["grad_err"] <= LEAF_TOL, res["grad_err"]
    assert res["param_err"] <= LEAF_TOL, res["param_err"]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_step_on_reference_weights_equals_reference(gloo, arch):
    res, ref_loss = gloo
    assert res[arch]["ref_weights_loss"] == pytest.approx(ref_loss[arch],
                                                          rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
@pytest.mark.parametrize("mesh_shape", ["2x2", "4x1"])
def test_restore_shardings_gives_each_rank_its_slice(gloo, arch,
                                                     mesh_shape):
    every = gloo[0][arch]["restored"]
    assert len(every) == 4
    assert all(r[mesh_shape] for r in every), every
