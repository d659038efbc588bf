"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) temporal mixer.

Chunked SSD as in the reference: within a chunk the quadratic form with
the 1-semiseparable decay mask (``_segsum``, -inf above the diagonal);
across chunks a recurrence over per-chunk states (B, H, P, N), carried in
f32 by a loop over chunks.  The chunk is ``min(chunk, L)``, the sequence
zero-padded to a multiple of it; B / C groups repeat to heads.

Decode is the recurrent form, h = exp(A dt) h + dt B x, one token a step,
equal to the chunked forward token for token.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, SSMConfig, TreeBuilder


class SSMCache(NamedTuple):
    state: torch.Tensor    # (B, H, P, N) f32
    conv: torch.Tensor     # (B, W-1, d_inner + 2*G*N)


def init_ssd(tb: TreeBuilder, cfg: ModelConfig, name="ssd"):
    sc: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner = sc.expand * d
    n_heads = d_inner // sc.head_dim
    g, n = sc.n_groups, sc.d_state
    conv_dim = d_inner + 2 * g * n
    sub = tb.sub(name)
    sub.add("w_in", (d, 2 * d_inner + 2 * g * n + n_heads),
            cfg.dtype)                               # [z, x, B, C, dt]
    sub.add("conv_w", (sc.conv_width, conv_dim), cfg.dtype)
    sub.zeros("conv_b", conv_dim, cfg.dtype)
    sub.add("a_log", (n_heads,), torch.float32,
            init=torch.log(torch.linspace(1.0, 16.0, n_heads)))
    sub.zeros("dt_bias", n_heads)
    sub.ones("d_skip", n_heads)
    sub.ones("norm", d_inner)
    sub.add("w_out", (d_inner, d), cfg.dtype)


def _split_proj(proj, cfg: ModelConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    g, n = sc.n_groups, sc.d_state
    nh = d_inner // sc.head_dim
    z, xbc, dt = proj.split([d_inner, d_inner + 2 * g * n, nh], dim=-1)
    return z, xbc, dt, (d_inner, g, n, nh)


def _causal_conv(xbc, w, b, cache=None):
    """Depthwise causal conv along time, then SiLU.  xbc (B, L, C); w (W,
    C); ``cache`` the previous W-1 inputs (zeros when None)."""
    width = w.shape[0]
    if cache is None:
        pad = xbc.new_zeros(xbc.shape[0], width - 1, xbc.shape[2])
    else:
        pad = cache
    xp = torch.cat([pad, xbc], dim=1)                     # (B, L+W-1, C)
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
    new_cache = xp[:, -(width - 1):, :] if width > 1 else pad
    return F.silu(out + b[None, None, :]), new_cache


def _segsum(x):
    """Log-decay cumulative matrix: out[i, j] = sum_{j<k<=i} x[k]; -inf
    for j > i."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, -torch.inf)


def _gated_norm(y, z, p, cfg: ModelConfig, dtype):
    """Mamba-2's gated RMSNorm in f32, cast to ``dtype``."""
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * p["norm"]).to(dtype)


def ssd_apply(p, x, cfg: ModelConfig):
    """Full-sequence SSD (train / prefill).  x (B, L, d) -> (B, L, d)."""
    sc: SSMConfig = cfg.ssm
    b, l, _ = x.shape
    proj = x @ p["w_in"]
    z, xbc, dt, (d_inner, g, n, nh) = _split_proj(proj, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = xbc.split([d_inner, g * n, g * n], dim=-1)
    hp = sc.head_dim
    xs = xs.reshape(b, l, nh, hp)
    bmat = bmat.reshape(b, l, g, n)
    cmat = cmat.reshape(b, l, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, L, H)
    a = -torch.exp(p["a_log"])                                 # (H,)
    da = dt * a[None, None, :]                                 # (B, L, H)

    # ---- chunked scan ----
    ck = min(sc.chunk, l)
    pad = (-l) % ck
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nck = (l + pad) // ck
    rep = nh // g
    b_h = bmat.repeat_interleave(rep, dim=2).float()          # (B, L', H, N)
    c_h = cmat.repeat_interleave(rep, dim=2).float()
    xs_f = xs.float()

    state = x.new_zeros((b, nh, hp, n), dtype=torch.float32)
    ys = []
    for c in range(nck):
        sl = slice(c * ck, (c + 1) * ck)
        xs_k, b_k, c_k = xs_f[:, sl], b_h[:, sl], c_h[:, sl]
        da_k, dt_k = da[:, sl], dt[:, sl]
        # decay within the chunk: L-matrix (B, H, ck, ck)
        lmat = torch.exp(_segsum(da_k.transpose(1, 2)))
        # intra-chunk (quadratic in ck)
        scores = torch.einsum("bchn,blhn->bhcl", c_k, b_k) * lmat
        intra = torch.einsum("bhcl,blh,blhp->bchp", scores, dt_k, xs_k)
        # inter-chunk: the entering state's contribution
        decay_in = torch.exp(torch.cumsum(da_k, dim=1))       # (B, ck, H)
        inter = torch.einsum("bchn,bhpn,bch->bchp", c_k, state, decay_in)
        # state' = decay_total * state + sum_l decay_rest B x
        decay_total = torch.exp(da_k.sum(1))                  # (B, H)
        decay_rest = torch.exp(da_k.sum(1, keepdim=True)
                               - torch.cumsum(da_k, dim=1))   # (B, ck, H)
        dstate = torch.einsum("blhn,blh,blh,blhp->bhpn", b_k, decay_rest,
                              dt_k, xs_k)
        state = state * decay_total[:, :, None, None] + dstate
        ys.append((intra + inter).to(xs.dtype))
    y = torch.cat(ys, dim=1)[:, :l]
    y = y + xs[:, :l] * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(b, l, d_inner)
    return _gated_norm(y, z[:, :l], p, cfg, x.dtype) @ p["w_out"]


def ssd_decode(p, x, cfg: ModelConfig, cache: SSMCache):
    """Single-token recurrent step.  x (B, 1, d)."""
    sc: SSMConfig = cfg.ssm
    b = x.shape[0]
    proj = x @ p["w_in"]
    z, xbc, dt, (d_inner, g, n, nh) = _split_proj(proj, cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 cache=cache.conv)
    xs, bvec, cvec = xbc[:, 0].split([d_inner, g * n, g * n], dim=-1)
    hp = sc.head_dim
    xs = xs.reshape(b, nh, hp).float()
    bvec = bvec.reshape(b, g, n).repeat_interleave(nh // g, dim=1).float()
    cvec = cvec.reshape(b, g, n).repeat_interleave(nh // g, dim=1).float()
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])         # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dtv * a[None, :])                        # (B, H)
    upd = torch.einsum("bhn,bh,bhp->bhpn", bvec, dtv, xs)
    state = cache.state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, cvec)
    y = y + xs * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner)
    out = _gated_norm(y, z, p, cfg, x.dtype) @ p["w_out"]
    return out, SSMCache(state, new_conv)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    sc: SSMConfig = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    nh = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.n_groups * sc.d_state
    return SSMCache(
        torch.zeros((batch, nh, sc.head_dim, sc.d_state),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, sc.conv_width - 1, conv_dim), dtype=dtype,
                    device=device))
