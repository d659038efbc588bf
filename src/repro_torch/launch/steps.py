"""Step functions: train (forward + backward + AdamW), prefill, decode.

The reference's (``src/repro/launch/steps.py``), on the port's models.
The train step runs autograd over the parameter tree and updates it in
place; the cross entropy saves only the logits and their logsumexp, and
its backward writes the one (B, S, V) gradient it returns in place.

The steps take DTensor trees too (parameters, moments and batch sharded by
``launch/mesh.py``'s rules): they then run under ``implicit_replication``,
the loss is vocab-parallel (:class:`_VocabParallelCE`, never gathering the
logits) and the metrics come back as plain replicated tensors.
"""

from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, decode_step, forward
from repro_torch.models import sharding as SH
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState


class _CrossEntropy(torch.autograd.Function):
    """mean(logsumexp(logits) - logits[label]) over every position; the
    gradient is (softmax - onehot) / n, built in one tensor."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None]).squeeze(-1)
        ctx.save_for_backward(logits, labels, lse)
        return (lse - ll).mean()

    @staticmethod
    def backward(ctx, grad):
        logits, labels, lse = ctx.saved_tensors
        out = torch.sub(logits, lse[..., None]).exp_()
        out.scatter_add_(-1, labels[..., None],
                         torch.full_like(lse[..., None], -1.0))
        return out.mul_(grad / labels.numel()), None


class _VocabParallelCE(torch.autograd.Function):
    """One rank's share of the summed CE over ``n_total`` positions, on its
    local logits (b, s, V_local) holding vocab ids ``[v_off, v_off +
    V_local)``: the max, the sum of exponentials and the label's logit are
    reduced across the vocab's mesh dims ``vdims``; the gradient is local."""

    @staticmethod
    def forward(ctx, logits, labels, v_off, mesh, vdims, n_total):
        v_loc = logits.shape[-1]
        m = SH.reduce_over(logits.amax(-1), mesh, vdims, "max")
        sumexp = torch.exp(logits - m[..., None]).sum(-1)
        lse = m + torch.log(SH.reduce_over(sumexp, mesh, vdims))
        loc = labels - v_off
        inr = (loc >= 0) & (loc < v_loc)
        loc = loc.clamp(0, v_loc - 1)
        ll = torch.where(inr, logits.gather(-1, loc[..., None]).squeeze(-1),
                         0.0)
        ll = SH.reduce_over(ll, mesh, vdims)
        ctx.save_for_backward(logits, loc, inr, lse)
        ctx.n_total = n_total
        return (lse - ll).sum() / n_total

    @staticmethod
    def backward(ctx, grad):
        logits, loc, inr, lse = ctx.saved_tensors
        out = torch.sub(logits, lse[..., None]).exp_()
        out.scatter_add_(-1, loc[..., None], -inr[..., None].to(out.dtype))
        return out.mul_(grad / ctx.n_total), None, None, None, None, None


def _sharded_cross_entropy(logits, labels):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.ndim - 1
    lg_pl = tuple(p if p.is_shard() else Replicate()
                  for p in logits.placements)
    lb_pl = tuple(Shard(p.dim) if p.is_shard() and p.dim < last
                  else Replicate() for p in lg_pl)
    out_pl = tuple(Partial() if p.is_shard() and p.dim < last
                   else Replicate() for p in lg_pl)
    vdims = SH.sharded_dims(lg_pl, last)
    v_loc = logits.shape[-1]
    for d in vdims:
        v_loc = -(-v_loc // mesh.size(d))
    v_off = SH.flat_coordinate(mesh, vdims) * v_loc
    n_total = labels.numel()
    return SH.run_local(
        lambda lg, lb: _VocabParallelCE.apply(lg, lb.long(), v_off, mesh,
                                              vdims, n_total),
        mesh, (logits, labels), (lg_pl, lb_pl), (lg_pl, None), (out_pl,))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean CE over all positions; logits f32 (B, S, V), labels (B, S).
    On DTensors the logits stay sharded (vocab-parallel)."""
    if SH.is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels)
    return _CrossEntropy.apply(logits, labels.long())


def _plain(x):
    """A metric as a plain tensor (a DTensor's replicated value)."""
    return x.full_tensor() if SH.is_dtensor(x) else x


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    aux_weight: float = 1e-3):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics{loss, ce, aux, grad_norm, lr}).  ``params`` and the moments
    are updated in place (and returned); the metrics are 0-dim tensors.
    ``batch``: {tokens (B, S), labels (B, S), [ctx]} on the params'
    device."""

    def train_step(params, opt_state: AdamWState, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        with SH.sharded_context(params):
            logits, aux = forward(params, cfg, batch["tokens"],
                                  ctx=batch.get("ctx"))
            ce = cross_entropy(logits, batch["labels"])
            del logits
            loss = ce + aux_weight * aux
            loss.backward()
            # a leaf the loss does not reach gets zeros, as jax.grad gives
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, params)
            for p in leaves:
                p.grad = None
            params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                                 params)
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), **om}
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """-> prefill(params, batch) -> logits of the last position (B, V)."""

    @torch.no_grad()
    def prefill(params, batch):
        with SH.sharded_context(params):
            logits, _ = forward(params, cfg, batch["tokens"],
                                ctx=batch.get("ctx"))
            return logits[:, -1, :]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """-> decode(params, batch) -> (next-token logits (B, V), caches).
    batch: {tokens (B,1), pos (B,), caches, [ctx | enc_out]}; the caches
    are updated in place."""

    @torch.no_grad()
    def decode(params, batch):
        with SH.sharded_context(params):
            logits, caches = decode_step(params, cfg, batch["tokens"],
                                         batch["pos"], batch["caches"],
                                         ctx=batch.get("ctx"),
                                         enc_out=batch.get("enc_out"))
            return logits[:, 0, :], caches

    return decode
