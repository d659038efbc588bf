"""AdamW with f32 moments, updating parameters and moments in place.

The reference's math (``src/repro/optim/adamw.py``): clip the gradients
by their global norm, bias-correct the moments, step by
``mhat / (sqrt(vhat) + eps)`` plus decoupled weight decay, all in f32,
and cast back to the parameter's dtype.  Not ``torch.optim.AdamW``, whose
clipping and decay differ.

Two things differ from a transcription:

* every tensor is updated in place, in flat chunks of at most
  ``CHUNK`` elements, so the f32 temporaries of a bf16 parameter stay a
  few hundred MB however large it is (a 256,000-row embedding would
  otherwise need several f32 copies of itself);
* decay follows the rank a leaf has in the reference's tree: leaves under
  ``groups`` carry a leading ``n_groups`` axis there, so a group's norm
  weights (1-D here) are decayed, while ``final_norm`` and the
  ``tail{i}`` norms are not.

The step counter lives on the host (a 0-dim int32 CPU tensor), so the
schedule and the bias corrections cost no device synchronisation.

On DTensor trees (``launch/mesh.py``'s shardings) the update is the same
elementwise math on each rank's local shards: a gradient is first
redistributed to its moment's placements (a reduce-scatter of a partial
gradient), the parameter is updated on that slice and, where its own
placements differ (ZeRO-1: moments sharded, parameters replicated),
gathered back.  The global norm sums each leaf's local squares once per
distinct shard across the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models import sharding as SH
from repro_torch.models.common import tree_leaves, tree_map

CHUNK = 1 << 26          # elements a chunk: 256 MB of f32 temporaries


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-dim int32, on the CPU
    mu: Any
    nu: Any


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in f32 as the
    reference computes it; a 0-dim CPU tensor."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                         1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_f32(p):
    if SH.is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params) -> AdamWState:
    """Zero moments shaped (and, for DTensors, sharded) like ``params``."""
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=tree_map(_zeros_f32, params),
                      nu=tree_map(_zeros_f32, params))


def _chunks(t: torch.Tensor):
    """Flat views of ``t`` of at most CHUNK elements (``t`` contiguous)."""
    return t.view(-1).split(CHUNK)


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), device=x.device)
    for c in _chunks(x.contiguous()):
        total = total + torch.sum(torch.square(c.to(torch.float32)))
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, accumulated in f32.  A
    DTensor leaf adds its local shard's squares as a share that is summed
    across the mesh dims sharding it (a replicated dim holds copies)."""
    total = torch.zeros(())
    for x in tree_leaves(tree):
        if SH.is_dtensor(x):
            from torch.distributed.tensor import DTensor, Partial, Replicate
            if any(p.is_partial() for p in x.placements):
                x = x.redistribute(x.device_mesh, tuple(
                    Replicate() if p.is_partial() else p
                    for p in x.placements))
            share = DTensor.from_local(
                _sum_squares(x.to_local()), x.device_mesh,
                tuple(Partial() if p.is_shard() else Replicate()
                      for p in x.placements), run_check=False)
            total = total + share.full_tensor()
        else:
            total = total + _sum_squares(x)
    return torch.sqrt(total)


def _walk(params, grads, mu, nu, stacked: bool = False):
    """(p, g, m, v, reference rank) for every leaf, walking ``params``'
    structure and reading the other trees by the same keys."""
    if isinstance(params, torch.Tensor):
        yield params, grads, mu, nu, params.dim() + stacked
    elif isinstance(params, dict):
        for k, p in params.items():
            yield from _walk(p, grads[k], mu[k], nu[k],
                             stacked or k == "groups")
    elif isinstance(params, (list, tuple)):
        for i, p in enumerate(params):
            yield from _walk(p, grads[i], mu[i], nu[i], stacked)
    else:
        raise TypeError(f"unexpected leaf {type(params)}")


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """-> (params, new_state, metrics).  ``params`` and the moments are
    updated in place and returned; ``metrics`` holds ``grad_norm`` (on
    the gradients' device) and ``lr``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr_t = schedule(cfg, step)
    lr = float(lr_t)
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))
    for p, g, m, v, rank in _walk(params, grads, state.mu, state.nu):
        p_full = None
        if SH.is_dtensor(p):
            # the moments' placements name the slice each rank updates
            mesh, pl = m.device_mesh, tuple(m.placements)
            g = g.redistribute(mesh, pl).to_local()
            if tuple(p.placements) != pl:
                p_full, p = p, p.redistribute(mesh, pl)
            p, m, v = p.to_local(), m.to_local(), v.to_local()
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("AdamW updates contiguous tensors in place")
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()),
                                  _chunks(m), _chunks(v)):
            gf = gc.to(torch.float32) * clip
            mc.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            vc.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
            del gf
            delta = (mc / b1c).div_((vc / b2c).sqrt_().add_(cfg.eps))
            # decoupled weight decay (skip 1-D params: norms, biases,
            # scalars -- 1-D as the reference stores them)
            if rank >= 2:
                delta.add_(pc, alpha=cfg.weight_decay)
            if pc.dtype == torch.float32:
                pc.sub_(delta.mul_(lr))
            else:
                pc.copy_(pc.to(torch.float32).sub_(delta.mul_(lr)))
        if p_full is not None:
            from torch.distributed.tensor import DTensor
            upd = DTensor.from_local(p, mesh, pl, run_check=False)
            p_full.to_local().copy_(upd.redistribute(
                mesh, p_full.placements).to_local())
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    return params, AdamWState(step, state.mu, state.nu), metrics
