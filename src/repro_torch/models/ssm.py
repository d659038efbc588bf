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

from repro_torch.models import sharding as SH
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
            ("embed", "mlp"), cfg.dtype)             # [z, x, B, C, dt]
    sub.add("conv_w", (sc.conv_width, conv_dim), (None, "mlp"), cfg.dtype)
    sub.zeros("conv_b", conv_dim, ("mlp",), cfg.dtype)
    sub.add("a_log", (n_heads,), ("heads",), torch.float32,
            init=torch.log(torch.linspace(1.0, 16.0, n_heads)))
    sub.zeros("dt_bias", n_heads, ("heads",))
    sub.ones("d_skip", n_heads, ("heads",))
    sub.ones("norm", d_inner, ("mlp",))
    sub.add("w_out", (d_inner, d), ("mlp", "embed"), cfg.dtype)


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
    """Mamba-2's gated RMSNorm in f32, cast to ``dtype`` (the mean as a
    sum on DTensors, whose sharded mean has no reliable backward)."""
    yf = y.float() * F.silu(z.float())
    if SH.is_dtensor(yf):
        var = (yf * yf).sum(-1, keepdim=True) / yf.shape[-1]
    else:
        var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * p["norm"]).to(dtype)


def ssd_apply(p, x, cfg: ModelConfig):
    """Full-sequence SSD (train / prefill).  x (B, L, d) -> (B, L, d)."""
    proj = SH.linear(x, p["w_in"])
    if SH.is_dtensor(proj):
        y = _ssd_sharded(p, proj, cfg, x.dtype)
    else:
        z, y = _ssd_scan(proj, *(p[k] for k in _SCAN), cfg=cfg)
        y = _gated_norm(y, z, p, cfg, x.dtype)
    return SH.linear(y, p["w_out"])


_SCAN = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip")
_SMALL = _SCAN + ("norm",)


def _ssd_sharded(p, proj, cfg: ModelConfig, dtype):
    """The SSD mixer on DTensors: the batch keeps its sharding and the
    heads are split over the other mesh dims (where they divide), so each
    rank scans its own heads against the shared B / C; the gated norm runs
    on the head-sharded output (its sum of squares reduced by DTensor)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = proj.device_mesh
    sc: SSMConfig = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    nh = d_inner // sc.head_dim
    bdims = SH.sharded_dims(proj.placements, 0)
    rest = [i for i in range(mesh.ndim) if i not in bdims]
    n = 1
    for i in rest:
        n *= mesh.size(i)
    hdims = rest if nh % n == 0 else []
    n = n if hdims else 1
    r = SH.flat_coordinate(mesh, hdims)
    heads = (r * nh // n, (r + 1) * nh // n)

    pl = SH.per_dim(mesh)

    act = pl(lambda i: Shard(0) if i in bdims else Replicate())
    rep = pl(lambda i: Replicate())
    act_g = pl(lambda i: Shard(0) if i in bdims else
               Partial() if i in hdims else Replicate())
    w_g = pl(lambda i: Partial() if i in bdims or i in hdims
             else Replicate())
    y_pl = pl(lambda i: Shard(0) if i in bdims else
              Shard(2) if i in hdims else Replicate())
    if tuple(proj.placements) != act:
        proj = proj.redistribute(mesh, act)
    y = SH.run_local(
        lambda pr, *w: _ssd_scan(pr, *w, cfg=cfg, heads=heads)[1], mesh,
        (proj,) + tuple(p[k] for k in _SCAN), (act,) + (rep,) * 5,
        (act_g,) + (w_g,) * 5, (y_pl,))
    return _gated_norm(y, proj[..., :d_inner], p, cfg, dtype)


def _mix_sharded(fn, proj, small, caches):
    """``fn(proj, *small, *caches)`` on local shards: the batch keeps its
    sharding, everything else is whole on every rank (the one-token step
    is cheap); returns the output and the caches, these in their own
    placements again."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = proj.device_mesh
    bdims = SH.sharded_dims(proj.placements, 0)

    pl = SH.per_dim(mesh)

    act = pl(lambda i: Shard(0) if i in bdims else Replicate())
    rep = pl(lambda i: Replicate())
    wgrad = pl(lambda i: Partial() if i in bdims else Replicate())
    n_out = 1 + len(caches)
    outs = SH.run_local(
        fn, mesh, (proj,) + tuple(small) + tuple(caches),
        (act,) + (rep,) * len(small) + (act,) * len(caches),
        (act,) + (wgrad,) * len(small) + (act,) * len(caches),
        (act,) * n_out)
    outs = (outs,) if n_out == 1 else outs
    return (outs[0],) + tuple(
        o.redistribute(mesh, c.placements) if SH.is_dtensor(c) else o
        for o, c in zip(outs[1:], caches))


def _ssd_scan(proj, conv_w, conv_b, dt_bias, a_log, d_skip, *,
              cfg: ModelConfig, heads=None):
    """The SSD mixer between its projection and its gated norm: conv,
    chunked scan and skip, for the heads ``[h0, h1)`` (default all: the
    x channels and dt of those heads, B and C whole).  proj (B, L, 2
    d_inner + 2 g n + H) -> (z (B, L, d_inner), y (B, L, (h1 - h0) P))."""
    sc: SSMConfig = cfg.ssm
    b, l, _ = proj.shape
    z, xbc, dt, (d_inner, g, n, nh) = _split_proj(proj, cfg)
    hp = sc.head_dim
    h0, h1 = heads or (0, nh)
    if (h0, h1) != (0, nh):
        cols = torch.cat([torch.arange(h0 * hp, h1 * hp),
                          torch.arange(d_inner, d_inner + 2 * g * n)]).to(
                              xbc.device)
        xbc, conv_w, conv_b = xbc[..., cols], conv_w[:, cols], conv_b[cols]
        dt, dt_bias = dt[..., h0:h1], dt_bias[h0:h1]
        a_log, d_skip = a_log[h0:h1], d_skip[h0:h1]
    nh_l = h1 - h0
    xbc, _ = _causal_conv(xbc, conv_w, conv_b)
    xs, bmat, cmat = xbc.split([nh_l * hp, g * n, g * n], dim=-1)
    xs = xs.reshape(b, l, nh_l, hp)
    bmat = bmat.reshape(b, l, g, n)
    cmat = cmat.reshape(b, l, g, n)
    dt = F.softplus(dt.float() + dt_bias)                      # (B, L, H)
    a = -torch.exp(a_log)                                      # (H,)
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
    b_h = bmat.repeat_interleave(rep, dim=2)[:, :, h0:h1].float()
    c_h = cmat.repeat_interleave(rep, dim=2)[:, :, h0:h1].float()
    xs_f = xs.float()

    state = proj.new_zeros((b, nh_l, hp, n), dtype=torch.float32)
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
    y = y + xs[:, :l] * d_skip[None, None, :, None].to(xs.dtype)
    return z[:, :l], y.reshape(b, l, nh_l * hp)


def ssd_decode(p, x, cfg: ModelConfig, cache: SSMCache):
    """Single-token recurrent step.  x (B, 1, d)."""
    proj = SH.linear(x, p["w_in"])
    small = tuple(p[k] for k in _SMALL)
    if SH.is_dtensor(proj):
        y, state, conv = _mix_sharded(
            lambda pr, *w: _ssd_step(pr, *w, cfg=cfg, dtype=x.dtype),
            proj, small, (cache.state, cache.conv))
    else:
        y, state, conv = _ssd_step(proj, *small, cache.state, cache.conv,
                                   cfg=cfg, dtype=x.dtype)
    return SH.linear(y, p["w_out"]), SSMCache(state, conv)


def _ssd_step(proj, conv_w, conv_b, dt_bias, a_log, d_skip, norm, state,
              conv, *, cfg: ModelConfig, dtype):
    """One recurrent step between the projections -> (y, state, conv)."""
    sc: SSMConfig = cfg.ssm
    b = proj.shape[0]
    z, xbc, dt, (d_inner, g, n, nh) = _split_proj(proj, cfg)
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, cache=conv)
    xs, bvec, cvec = xbc[:, 0].split([d_inner, g * n, g * n], dim=-1)
    hp = sc.head_dim
    xs = xs.reshape(b, nh, hp).float()
    bvec = bvec.reshape(b, g, n).repeat_interleave(nh // g, dim=1).float()
    cvec = cvec.reshape(b, g, n).repeat_interleave(nh // g, dim=1).float()
    dtv = F.softplus(dt[:, 0].float() + dt_bias)              # (B, H)
    a = -torch.exp(a_log)
    decay = torch.exp(dtv * a[None, :])                        # (B, H)
    upd = torch.einsum("bhn,bh,bhp->bhpn", bvec, dtv, xs)
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, cvec)
    y = y + xs * d_skip[None, :, None]
    y = y.reshape(b, 1, d_inner)
    return _gated_norm(y, z, {"norm": norm}, cfg, dtype), state, new_conv


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
