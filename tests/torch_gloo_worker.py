"""Four CPU processes on a real gloo group: the port's sharded train step
against the one-process port, and ``Checkpointer.restore(shardings=)``.

    python tests/torch_gloo_worker.py <in.pkl> <out.json>

Run by ``tests/test_torch_launch_mesh.py`` in a subprocess (it is not a
test module).  ``in.pkl`` holds the archs, the batches and the reference's
weights as numpy trees; ``out.json`` gets, per arch, the sharded and
one-process losses, gradient norms, the worst gradient and parameter
error of any leaf over that leaf's scale, the loss of the sharded step
from the reference's weights, and per rank and mesh whether every
restored leaf holds exactly the slice its placements name.
"""

import copy
import json
import os
import pickle
import socket
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import forward, init_params_and_axes  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import plan_elastic_mesh  # noqa: E402

AUX = 1e-3                      # make_train_step's aux_weight


def _grads(params, cfg, batch):
    """Gradients of the train step's loss (plain or DTensor trees)."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    with SH.sharded_context(params):
        logits, aux = forward(params, cfg, batch["tokens"],
                              ctx=batch.get("ctx"))
        loss = steps.cross_entropy(logits, batch["labels"]) + AUX * aux
        loss.backward()
    out = [p.grad for p in tree_leaves(params)]
    for p in tree_leaves(params):
        p.grad = None
        p.requires_grad_(False)
    return out


def _full(x):
    return x.full_tensor() if SH.is_dtensor(x) else x


def _worst(got, want) -> float:
    """max over leaves of max |got - want| / max |want|."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = _full(a).detach().float(), b.detach().float()
        scale = float(b.abs().max()) or 1.0
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def _restore_exact(ckpt, like, axes, cfg, mesh, saved) -> bool:
    """Every restored leaf holds exactly its slice, and gathers to the
    saved array."""
    sh = M.shardings_for_tree(like, axes, M.rules_for(cfg, fsdp=True), mesh)
    tree, _ = ckpt.restore(None, like, shardings=sh)
    ok = True
    for got, want, s in zip(tree_leaves(tree), tree_leaves(saved),
                            tree_leaves_sh(sh)):
        part = want[s.local_slices(want.shape)]
        ok &= SH.is_dtensor(got)
        ok &= torch.equal(got.to_local(), part)
        ok &= torch.equal(got.full_tensor(), want)
        ok &= tuple(got.placements) == tuple(s.placements)
    return bool(ok)


def tree_leaves_sh(tree) -> list:
    if isinstance(tree, M.NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves_sh(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves_sh(v)]
    return []


def run(rank, port, inp, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        plan = plan_elastic_mesh(4, 4, 1)
        mesh41 = init_device_mesh("cpu", (plan.data_axis, plan.model_axis),
                                  mesh_dim_names=("data", "model"))
        results = {}
        ckdir = inp["ckpt_dir"]
        for arch in inp["archs"]:
            cfg = registry.get_config(arch, smoke=True)
            params, axes = init_params_and_axes(cfg, 0, device="cpu")
            rules = M.rules_for(cfg, fsdp=True)
            sh = M.shardings_for_tree(params, axes, rules, mesh)
            bsh = M.NamedSharding(mesh, M.P("data", None))
            raw = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
            sbatch = {k: M.distribute_tree(v, bsh) for k, v in raw.items()}
            one = copy.deepcopy(params)
            g_one = _grads(one, cfg, raw)
            g_sh = _grads(M.distribute_tree(params, sh), cfg, sbatch)
            step = steps.make_train_step(cfg)
            one, _, m_one = step(one, adamw.init(one), raw)
            dp = M.distribute_tree(params, sh)
            dp, _, m_sh = step(dp, adamw.init(dp), sbatch)
            # the reference's weights carried across, sharded
            rp = lm_params_from_numpy(cfg, inp["ref_weights"][arch],
                                      device="cpu")
            rd = M.distribute_tree(rp, M.shardings_for_tree(rp, axes, rules,
                                                            mesh))
            _, _, m_ref = step(rd, adamw.init(rd), sbatch)
            # elastic restore of the one-process result
            ck = Checkpointer(os.path.join(ckdir, arch))
            if rank == 0:
                ck.save(1, one)
            dist.barrier()
            restored = {
                "2x2": _restore_exact(ck, params, axes, cfg, mesh, one),
                f"{plan.data_axis}x{plan.model_axis}": _restore_exact(
                    ck, params, axes, cfg, mesh41, one)}
            every = [None] * 4
            dist.all_gather_object(every, restored)
            results[arch] = {
                "loss": float(m_sh["loss"]), "loss_one": float(m_one["loss"]),
                "grad_norm": float(m_sh["grad_norm"]),
                "grad_norm_one": float(m_one["grad_norm"]),
                "grad_err": _worst(g_sh, g_one),
                "param_err": _worst(tree_leaves(dp), tree_leaves(one)),
                "ref_weights_loss": float(m_ref["loss"]),
                "restored": every,
                "n_sharded": sum(any(p.is_shard() for p in s.placements)
                                 for s in tree_leaves_sh(sh)),
            }
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    in_path, out_path = sys.argv[1], sys.argv[2]
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    with tempfile.TemporaryDirectory() as d:
        inp["ckpt_dir"] = d
        mp.spawn(run, args=(_free_port(), inp, out_path), nprocs=4,
                 join=True)


if __name__ == "__main__":
    main()
