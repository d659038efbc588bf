"""What the model, the loss and the optimizer need when their tensors are
DTensors: a parameter tree sharded by ``launch/mesh.py``'s rules.

DTensor gives most operations their sharded form.  The few it cannot
(the MoE's index-put dispatch, the vocab-parallel cross entropy, the
f32-output GEMM on the card) run on the local shards through
:func:`run_local`, with their collectives made explicitly by
:func:`reduce_over` / :func:`gather_over` on the functional collectives
that DTensor itself uses.  Nothing here imports ``torch.distributed`` until
a DTensor is seen, and plain tensors pass through every helper as they
are.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch


def is_dtensor(x) -> bool:
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(tree) -> bool:
    from repro_torch.models.common import tree_leaves
    return any(is_dtensor(x) for x in tree_leaves(tree))


@contextlib.contextmanager
def sharded_context(tree):
    """``implicit_replication()`` when ``tree`` holds a DTensor: the plain
    tensors made inside the model (masks, RoPE tables, accumulators) then
    act as replicated on the mesh.  A no-op for a plain tree."""
    if not any_dtensor(tree):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def per_dim(mesh):
    """``pl(fn)`` -> the placements ``(fn(0), ..., fn(ndim - 1))``, one a
    mesh dim."""
    return lambda fn: tuple(fn(i) for i in range(mesh.ndim))


def coordinate(mesh, dim: int) -> int:
    """This rank's index on mesh dim ``dim``."""
    return int(mesh.get_coordinate()[dim])


def sharded_dims(placements, tensor_dim: int) -> list:
    """The mesh dims whose placement shards ``tensor_dim``."""
    return [i for i, p in enumerate(placements)
            if p.is_shard() and p.dim == tensor_dim]


def run_local(fn, mesh, args: Sequence, in_placements: Sequence,
              grad_placements: Sequence, out_placements: Sequence):
    """``fn`` on the local shards of ``args``.

    Each DTensor argument is first redistributed to its ``in_placements``
    entry; its gradient comes back with the matching ``grad_placements``
    entry (``Partial`` where ``fn``'s local gradient is one rank's share).
    Each output of ``fn`` becomes a DTensor with its ``out_placements``
    entry (None: returned as it is).  A plain tensor counts as replicated,
    as under ``implicit_replication``, and is cut to its placements."""
    from torch.distributed.tensor import DTensor, Replicate
    local = []
    for x, pl, gpl in zip(args, in_placements, grad_placements):
        if (not is_dtensor(x) and isinstance(x, torch.Tensor)
                and any(p.is_shard() for p in pl)):
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        if is_dtensor(x):
            if tuple(x.placements) != tuple(pl):
                x = x.redistribute(mesh, pl)
            x = x.to_local(grad_placements=gpl)
        local.append(x)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    res = tuple(o if pl is None else
                DTensor.from_local(o, mesh, pl, run_check=False)
                for o, pl in zip(outs, out_placements))
    return res[0] if single else res


def reduce_over(x, mesh, dims: Sequence[int], op: str = "sum"):
    """All-reduce a local tensor over the mesh dims ``dims``."""
    if not dims:
        return x
    import torch.distributed._functional_collectives as funcol
    for d in dims:
        x = funcol.all_reduce(x, op, (mesh, d))
    return funcol.wait_tensor(x) if hasattr(funcol, "wait_tensor") else x


def gather_over(x, mesh, dims: Sequence[int]):
    """All-gather a local tensor over the mesh dims ``dims`` on a new
    leading axis, major to minor in the order of ``dims`` (mesh order):
    row ``i`` is the rank whose flattened coordinate on ``dims`` is ``i``."""
    import torch.distributed._functional_collectives as funcol
    x = x[None]
    for d in reversed(dims):
        x = funcol.all_gather_tensor(x, 0, (mesh, d))
        x = funcol.wait_tensor(x) if hasattr(funcol, "wait_tensor") else x
    return x


def flat_coordinate(mesh, dims: Sequence[int]) -> int:
    """This rank's flattened index over ``dims`` (major to minor)."""
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + coordinate(mesh, d)
    return idx


def linear(x, w):
    """``x @ w`` for a 2-D weight (in, out); on a DTensor weight, on local
    shards as tensor parallelism does it, so DTensor never chooses to
    gather a sharded weight and repeat its product on every rank: the
    batch (x's dim 0) keeps its sharding, a mesh dim sharding ``out`` is
    column-parallel (the output sharded on its last dim), one sharding
    ``in`` row-parallel (x sharded on its last dim, the output a partial
    sum); the weight is gathered over the batch's dims (FSDP)."""
    if not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    last = x.ndim - 1
    bdims = sharded_dims(x.placements, 0) if is_dtensor(x) else []
    col = [i for i in sharded_dims(w.placements, 1) if i not in bdims]
    row = [i for i in sharded_dims(w.placements, 0) if i not in bdims]

    pl = per_dim(mesh)

    x_pl = pl(lambda i: Shard(0) if i in bdims else
              Shard(last) if i in row else Replicate())
    x_gpl = pl(lambda i: Partial() if i in col else x_pl[i])
    w_pl = pl(lambda i: Shard(1) if i in col else
              Shard(0) if i in row else Replicate())
    w_gpl = pl(lambda i: Partial() if i in bdims else w_pl[i])
    out_pl = pl(lambda i: Shard(0) if i in bdims else
                Shard(last) if i in col else
                Partial() if i in row else Replicate())
    return run_local(lambda a, b: a @ b, mesh, (x, w), (x_pl, w_pl),
                     (x_gpl, w_gpl), (out_pl,))
