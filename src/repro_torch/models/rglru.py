"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

    r_t = sigmoid(W_a x_t)                      (recurrence gate)
    i_t = sigmoid(W_x x_t)                      (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)           (per-channel decay, c=8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Train / prefill runs the recurrence as a log-depth (Hillis-Steele) scan in
f32, the work of the reference's ``lax.associative_scan`` in plain torch;
decode is the one-step recurrence.  The block: linear in -> temporal conv
(width 4) -> RG-LRU -> gated (GeGLU-style, tanh GELU) merge -> linear out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH
from repro_torch.models.common import ModelConfig, RGLRUConfig, TreeBuilder
from repro_torch.models.layers import gelu

_C = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor       # (B, d_rnn) f32
    conv: torch.Tensor    # (B, W-1, d_rnn)


def init_rglru(tb: TreeBuilder, cfg: ModelConfig, name="rglru"):
    rc: RGLRUConfig = cfg.rglru
    d = cfg.d_model
    dr = rc.d_rnn or d
    sub = tb.sub(name)
    sub.add("w_x", (d, dr), ("embed", "mlp"), cfg.dtype)
    sub.add("w_y", (d, dr), ("embed", "mlp"), cfg.dtype)     # gate branch
    sub.add("conv_w", (rc.conv_width, dr), (None, "mlp"), cfg.dtype)
    sub.zeros("conv_b", dr, ("mlp",), cfg.dtype)
    sub.add("w_a_gate", (dr, dr), ("mlp", "mlp2"), cfg.dtype)
    sub.add("w_i_gate", (dr, dr), ("mlp", "mlp2"), cfg.dtype)
    sub.add("lam", (dr,), ("mlp",), torch.float32, init=torch.log(torch.expm1(
        torch.linspace(0.9, 0.999, dr) ** (-1.0 / _C) - 1.0 + 1e-8)))
    sub.add("w_out", (dr, d), ("mlp", "embed"), cfg.dtype)


def _gates(p, xr):
    """xr (..., dr) -> log-decay log_a and the gated input contribution."""
    r = torch.sigmoid(SH.linear(xr, p["w_a_gate"]).float())
    i = torch.sigmoid(SH.linear(xr, p["w_i_gate"]).float())
    log_a = -_C * F.softplus(p["lam"]) * r              # (..., dr) <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return log_a, beta * (i * xr.float())


def _conv(x, w, b, cache=None):
    width = w.shape[0]
    pad = (x.new_zeros(x.shape[0], width - 1, x.shape[2])
           if cache is None else cache)
    xp = torch.cat([pad, x], dim=1)
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :], xp[:, -(width - 1):, :]


def linear_scan(log_a, x):
    """h_t = exp(log_a_t) h_{t-1} + x_t along axis 1 from h_{-1} = 0, as a
    log-depth scan: after the step at offset d each position holds the
    composition of the last 2d steps."""
    la, h = log_a, x
    d = 1
    while d < h.shape[1]:
        h = torch.cat([h[:, :d], h[:, d:] + torch.exp(la[:, d:]) * h[:, :-d]],
                      dim=1)
        la = torch.cat([la[:, :d], la[:, d:] + la[:, :-d]], dim=1)
        d *= 2
    return h


def rglru_apply(p, x, cfg: ModelConfig):
    """Full-sequence RG-LRU block.  x (B, L, d) -> (B, L, d)."""
    xr = SH.linear(x, p["w_x"])
    xr, _ = _conv(xr, p["conv_w"], p["conv_b"])
    log_a, gx = _gates(p, xr)
    h = linear_scan(log_a, gx)
    y = h.to(x.dtype) * gelu(SH.linear(x, p["w_y"]))
    return SH.linear(y, p["w_out"])


def rglru_decode(p, x, cfg: ModelConfig, cache: RGLRUCache):
    """One-step recurrence.  x (B, 1, d)."""
    xr = SH.linear(x, p["w_x"])
    xr, new_conv = _conv(xr, p["conv_w"], p["conv_b"], cache=cache.conv)
    log_a, gx = _gates(p, xr[:, 0])
    h = torch.exp(log_a) * cache.h + gx
    y = h[:, None, :].to(x.dtype) * gelu(SH.linear(x, p["w_y"]))
    return SH.linear(y, p["w_out"]), RGLRUCache(h, new_conv)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    rc: RGLRUConfig = cfg.rglru
    dr = rc.d_rnn or cfg.d_model
    return RGLRUCache(
        torch.zeros((batch, dr), dtype=torch.float32, device=device),
        torch.zeros((batch, rc.conv_width - 1, dr), dtype=dtype,
                    device=device))
