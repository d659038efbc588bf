"""Step functions: train (forward + backward + AdamW), prefill, decode.

The reference's (``src/repro/launch/steps.py``), on the port's models.
The train step runs autograd over the parameter tree and updates it in
place; the cross entropy saves only the logits and their logsumexp, and
its backward writes the one (B, S, V) gradient it returns in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, decode_step, forward
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean CE over all positions; logits f32 (B, S, V), labels (B, S)."""
    return _CrossEntropy.apply(logits, labels.long())


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
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """-> prefill(params, batch) -> logits of the last position (B, V)."""

    @torch.no_grad()
    def prefill(params, batch):
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
        logits, caches = decode_step(params, cfg, batch["tokens"],
                                     batch["pos"], batch["caches"],
                                     ctx=batch.get("ctx"),
                                     enc_out=batch.get("enc_out"))
        return logits[:, 0, :], caches

    return decode
