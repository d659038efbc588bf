"""Shared layers: norms, embeddings, RoPE, gated FFNs.

Where the reference computes in f32 (norms, RoPE, the logits), so does
this: a bf16 product in torch returns bf16, so every f32 step is explicit.
GELU is the tanh form, ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, TreeBuilder

MASK_LOGIT = -1e30           # padded vocab rows (the reference's, not -inf)


# -- norms -------------------------------------------------------------------

def init_rmsnorm(tb: TreeBuilder, name: str, dim: int):
    tb.ones(name, dim)


def rmsnorm(w, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def init_layernorm(tb: TreeBuilder, name: str, dim: int):
    sub = tb.sub(name)
    sub.ones("scale", dim)
    sub.zeros("bias", dim)


def layernorm(p, x, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


# -- embedding ---------------------------------------------------------------

def init_embedding(tb: TreeBuilder, cfg: ModelConfig):
    tb.add("embedding", (cfg.vocab_padded, cfg.d_model), cfg.dtype,
           scale=1.0)


def embed(params, tokens):
    return params["embedding"][tokens]


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
    if x.dtype == w.dtype == torch.float32:
        return x @ w.t()
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = _MatmulF32.apply(x2, w)
    else:
        out = x2.float() @ w.float().t()
    return out.reshape(*x.shape[:-1], w.shape[0])


def unembed(params, x, cfg: ModelConfig):
    """Final logits in f32.  Padded vocab rows are set to -1e30."""
    w = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    logits = matmul_f32(x, w)
    if cfg.vocab_padded != cfg.vocab_size:
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
        sub.add("w_gate", (cfg.d_model, d_ff), cfg.dtype)
        sub.add("w_up", (cfg.d_model, d_ff), cfg.dtype)
    else:
        sub.add("w_up", (cfg.d_model, d_ff), cfg.dtype)
    sub.add("w_down", (d_ff, cfg.d_model), cfg.dtype)


def ffn_apply(p, x, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        h = gelu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]
