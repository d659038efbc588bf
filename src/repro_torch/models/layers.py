"""Shared layers: norms, embeddings, RoPE, gated FFNs.

Where the reference computes in f32 (norms, RoPE, the logits), so does
this: a bf16 product in torch returns bf16, so every f32 step is explicit.
GELU is the tanh form, ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH
from repro_torch.models.common import ModelConfig, TreeBuilder

MASK_LOGIT = -1e30           # padded vocab rows (the reference's, not -inf)


# -- norms -------------------------------------------------------------------

def init_rmsnorm(tb: TreeBuilder, name: str, dim: int):
    tb.ones(name, dim, ("embed",))


def rmsnorm(w, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def init_layernorm(tb: TreeBuilder, name: str, dim: int):
    sub = tb.sub(name)
    sub.ones("scale", dim, ("embed",))
    sub.zeros("bias", dim, ("embed",))


def layernorm(p, x, eps: float = 1e-6):
    xf = x.float()
    if SH.is_dtensor(xf):     # mean and var by sums: DTensor's backward
        n = xf.shape[-1]      # cannot turn a P(sum) gradient into P(avg)
        mu = xf.sum(-1, keepdim=True) / n
        var = ((xf - mu) ** 2).sum(-1, keepdim=True) / n
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


# -- embedding ---------------------------------------------------------------

def init_embedding(tb: TreeBuilder, cfg: ModelConfig):
    tb.add("embedding", (cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
           cfg.dtype, scale=1.0)


def embed(params, tokens):
    table = params["embedding"]
    if SH.is_dtensor(table):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table, tokens):
    """The lookup on local shards (DTensor's embedding backward is not
    reliable across versions): each rank looks up the rows of its vocab
    shard, zero elsewhere, a partial sum over the vocab's mesh dims; the
    embed dim is gathered, the tokens keep their batch sharding."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    bdims = SH.sharded_dims(tokens.placements, 0) if SH.is_dtensor(
        tokens) else []
    vdims = [i for i in SH.sharded_dims(table.placements, 0)
             if i not in bdims]

    pl = SH.per_dim(mesh)

    t_pl = pl(lambda i: Shard(0) if i in vdims else Replicate())
    t_gpl = pl(lambda i: Shard(0) if i in vdims else
               Partial() if i in bdims else Replicate())
    tok_pl = pl(lambda i: Shard(0) if i in bdims else Replicate())
    out_pl = pl(lambda i: Shard(0) if i in bdims else
                Partial() if i in vdims else Replicate())
    v_loc = table.shape[0]
    for i in vdims:
        v_loc = -(-v_loc // mesh.size(i))
    v_off = SH.flat_coordinate(mesh, vdims) * v_loc

    def fn(tl, tok):
        loc = tok.long() - v_off
        inr = (loc >= 0) & (loc < tl.shape[0])
        rows = F.embedding(loc.clamp(0, tl.shape[0] - 1), tl)
        return rows * inr[..., None].to(rows.dtype)

    return SH.run_local(fn, mesh, (table, tokens), (t_pl, tok_pl),
                        (t_gpl, None), (out_pl,))


class _MatmulF32(torch.autograd.Function):
    """``x2 (N, d) @ w (n, d).T`` into f32 on the card, with a gradient
    (``aten::mm.dtype`` has none): the f32 output gradient is cast to the
    operands' type and both products run in it, accumulating in f32."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x2, w = ctx.saved_tensors
        grad = grad.to(x2.dtype)
        gx = grad @ w if ctx.needs_input_grad[0] else None
        gw = grad.t() @ x2 if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x, w):
    """``x (..., d) @ w (n, d).T`` with an f32 result and f32 accumulation,
    whatever the inputs' type.  On the card a bf16 product writes f32
    directly (``torch.mm(..., out_dtype=)``, differentiable through
    ``_MatmulF32``), so the weight is never copied to f32; on the CPU the
    operands are cast."""
    x2 = x.reshape(-1, x.shape[-1])
    if SH.is_dtensor(w):
        out = _matmul_f32_sharded(x2, w)
    else:
        out = _matmul_f32_2d(x2, w)
    return out.reshape(*x.shape[:-1], w.shape[0])


def _matmul_f32_2d(x2, w):
    if x2.dtype == w.dtype == torch.float32:
        return x2 @ w.t()
    if x2.is_cuda:
        return _MatmulF32.apply(x2, w)
    return x2.float() @ w.float().t()


def _matmul_f32_sharded(x2, w):
    """:func:`matmul_f32` on local shards (``aten::mm.dtype`` has no
    DTensor rule on the card, and DTensor may gather the vocab): rows of
    ``x2`` and of ``w`` keep their sharding, the contracted dim is
    gathered; the product is sharded on its rows as ``x2`` and on its
    columns as ``w``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    xr = SH.sharded_dims(x2.placements, 0) if SH.is_dtensor(x2) else []
    wr = [i for i in SH.sharded_dims(w.placements, 0) if i not in xr]

    pl = SH.per_dim(mesh)

    x_pl = pl(lambda i: Shard(0) if i in xr else Replicate())
    w_pl = pl(lambda i: Shard(0) if i in wr else Replicate())
    x_gpl = pl(lambda i: Shard(0) if i in xr else
               Partial() if i in wr else Replicate())
    w_gpl = pl(lambda i: Shard(0) if i in wr else
               Partial() if i in xr else Replicate())
    out_pl = pl(lambda i: Shard(0) if i in xr else
                Shard(1) if i in wr else Replicate())
    return SH.run_local(_matmul_f32_2d, mesh, (x2, w), (x_pl, w_pl),
                        (x_gpl, w_gpl), (out_pl,))


def unembed(params, x, cfg: ModelConfig):
    """Final logits in f32.  Padded vocab rows are set to -1e30."""
    w = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    logits = matmul_f32(x, w)
    if cfg.vocab_padded != cfg.vocab_size:
        if SH.is_dtensor(logits):     # no in-place rule for every layout
            pad = torch.arange(cfg.vocab_padded,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, MASK_LOGIT)
        else:
            logits[..., cfg.vocab_size:] = MASK_LOGIT
    return logits


# -- RoPE --------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split (NeoX) rotary embedding in f32.  x (..., S, H, hd);
    positions (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    angles = angles[..., None, :]                               # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# -- FFN ---------------------------------------------------------------------

def gelu(x):
    return F.gelu(x, approximate="tanh")


def init_ffn(tb: TreeBuilder, cfg: ModelConfig, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    sub = tb.sub("ffn")
    if cfg.ffn in ("swiglu", "geglu"):
        sub.add("w_gate", (cfg.d_model, d_ff), ("embed", "mlp"), cfg.dtype)
        sub.add("w_up", (cfg.d_model, d_ff), ("embed", "mlp"), cfg.dtype)
    else:
        sub.add("w_up", (cfg.d_model, d_ff), ("embed", "mlp"), cfg.dtype)
    sub.add("w_down", (d_ff, cfg.d_model), ("mlp", "embed"), cfg.dtype)


def ffn_apply(p, x, kind: str):
    if kind == "swiglu":
        h = F.silu(SH.linear(x, p["w_gate"])) * SH.linear(x, p["w_up"])
    elif kind == "geglu":
        h = gelu(SH.linear(x, p["w_gate"])) * SH.linear(x, p["w_up"])
    else:
        h = gelu(SH.linear(x, p["w_up"]))
    return SH.linear(h, p["w_down"])
