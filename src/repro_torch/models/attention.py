"""Attention variants: GQA (full / local / cross, optional qk-norm) and MLA.

All return (B, S, d_model).  Decode writes the new token into a
preallocated cache (length = max context) at ``pos % L``, in place: the
caches are tensors the caller owns, and the same NamedTuple comes back.

Scores are computed in f32 from the inputs cast up (the reference's
``preferred_element_type=float32``); the probabilities are cast to the
values' type before the PV product, as there.  Above ``_DENSE_SCORE_LIMIT``
score entries, ``attention_apply`` takes the online-softmax chunked path.

MLA (DeepSeek-V2): queries / keys split into a no-position part (from a
compressed kv latent) and a shared rotary part; only the (kv_lora + rope)
latent is cached.  q-LoRA is omitted (dense W_q), as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models import sharding as SH
from repro_torch.models.common import MLAConfig, ModelConfig, TreeBuilder
from repro_torch.models.layers import apply_rope, rmsnorm

MASK_VALUE = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, L, KV, hd)
    v: torch.Tensor       # (B, L, KV, hd)


class MLACache(NamedTuple):
    kv_c: torch.Tensor    # (B, L, kv_lora)
    k_rope: torch.Tensor  # (B, L, rope_dim)


def _proj_in(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one GEMM."""
    if SH.is_dtensor(w):
        return _proj_sharded(x, w, into=True)
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_out(o, w):
    """``einsum("bshk,hkd->bsd", o, w)`` as one GEMM."""
    if SH.is_dtensor(w):
        return _proj_sharded(o, w, into=False)
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d)


def _proj_sharded(x, w, *, into: bool):
    """:func:`_proj_in` / :func:`_proj_out` on local shards, so that no
    flattened (h, k) dim is ever sharded unevenly: the batch keeps its
    sharding, the model dim ``d`` is gathered, and the weight's (h, k)
    sharding carries over to the activations (into) or makes the output a
    partial sum (out)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    xd = x.ndim                            # (..., d) or (..., h, k)
    bdims = SH.sharded_dims(x.placements, 0) if SH.is_dtensor(x) else []
    hk = (1, 2) if into else (0, 1)        # the weight's h and k dims
    wdims = {i: p.dim for i, p in enumerate(w.placements)
             if p.is_shard() and p.dim in hk and i not in bdims}

    pl = SH.per_dim(mesh)

    w_pl = pl(lambda i: Shard(wdims[i]) if i in wdims else Replicate())
    w_gpl = pl(lambda i: Shard(wdims[i]) if i in wdims else
               Partial() if i in bdims else Replicate())
    if into:
        # w (d, h, k) -> activations (..., h, k) sharded as w's h / k
        x_pl = pl(lambda i: Shard(0) if i in bdims else Replicate())
        x_gpl = pl(lambda i: Shard(0) if i in bdims else
                   Partial() if i in wdims else Replicate())
        out_pl = pl(lambda i: Shard(0) if i in bdims else
                    Shard(xd - 1 + wdims[i] - 1) if i in wdims
                    else Replicate())

        def fn(xl, wl):
            d, h, k = wl.shape
            return (xl @ wl.reshape(d, h * k)).reshape(*xl.shape[:-1], h, k)
    else:
        # o (..., h, k) sharded as w's h / k -> partial (..., d)
        x_pl = pl(lambda i: Shard(0) if i in bdims else
                  Shard(xd - 2 + wdims[i]) if i in wdims else Replicate())
        x_gpl = x_pl
        out_pl = pl(lambda i: Shard(0) if i in bdims else
                    Partial() if i in wdims else Replicate())

        def fn(ol, wl):
            h, k, d = wl.shape
            return ol.reshape(*ol.shape[:-2], h * k) @ wl.reshape(h * k, d)
    return SH.run_local(fn, mesh, (x, w), (x_pl, w_pl), (x_gpl, w_gpl),
                        (out_pl,))


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_attention(tb: TreeBuilder, cfg: ModelConfig, name="attn"):
    sub = tb.sub(name)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sub.add("wq", (d, h, hd), ("embed", "heads", "head_dim"), cfg.dtype)
    sub.add("wk", (d, kv, hd), ("embed", "kv_heads", "head_dim"),
            cfg.dtype)
    sub.add("wv", (d, kv, hd), ("embed", "kv_heads", "head_dim"),
            cfg.dtype)
    sub.add("wo", (h, hd, d), ("heads", "head_dim", "embed"), cfg.dtype)
    if cfg.qk_norm:
        sub.ones("q_norm", hd, ("head_dim",))
        sub.ones("k_norm", hd, ("head_dim",))


def _sdpa(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,L,KV,hd) -> (B,S,H,hd_v); grouped heads.

    mask is bool, (S, L) or (B, S, L), True = attend."""
    if SH.is_dtensor(q):
        return _sdpa_sharded(q, k, v, mask)
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd).float()
    scores = torch.einsum("bskgh,blkh->bkgsl", qg, k.float())
    scores = scores / math.sqrt(hd)
    if mask.dim() == 2:
        mask = mask[None, None, None, :, :]
    else:
        mask = mask[:, None, None, :, :]
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgsl,blkh->bskgh", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


def _sdpa_sharded(q, k, v, mask):
    """:func:`_sdpa` on local shards: the batch keeps its sharding, and
    the heads are split over the other mesh dims where both the query and
    the KV heads divide (whole GQA groups on each rank), else whole on
    every rank."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    bdims = SH.sharded_dims(q.placements, 0)
    rest = [i for i in range(mesh.ndim) if i not in bdims]
    n = 1
    for i in rest:
        n *= mesh.size(i)
    hdims = rest if h % n == 0 and kvh % n == 0 else []

    pl = SH.per_dim(mesh)

    qkv = pl(lambda i: Shard(0) if i in bdims else
             Shard(2) if i in hdims else Replicate())
    m_pl = pl(lambda i: Shard(0) if i in bdims and mask.dim() == 3
              else Replicate())
    return SH.run_local(lambda ql, kl, vl, ml: _sdpa(ql, kl, vl, ml), mesh,
                        (q, k, v, mask), (qkv, qkv, qkv, m_pl),
                        (qkv, qkv, qkv, None), (qkv,))


def _kv_block(t, kb: int, bkv: int):
    """Block ``kb`` of ``t`` along axis 1, with the start clamped into
    range as ``lax.dynamic_slice`` clamps it (the block's positions are
    still labelled from ``kb``, so such a block is fully masked)."""
    start = min(kb * bkv, t.shape[1] - bkv)
    return t[:, start:start + bkv]


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      bq: int = 512, bkv: int = 512,
                      causal_skip: bool = True, q_offset: int = 0,
                      q_stride: int = 1):
    """Flash-style attention: online softmax over KV blocks, never
    materialising the (S, L) score matrix; a loop over q blocks.

    For ``window > 0`` (local attention) a q block visits only
    ``window // bkv + 2`` KV blocks from the window's start, a block past
    the end clamped as ``lax.dynamic_slice`` clamps it (fully masked).
    With ``causal_skip`` causal full attention visits KV blocks only up to
    the q block's diagonal (the reference's data-dependent trip count);
    ``causal_skip=False`` visits every block, masked.

    Query row ``i`` sits at position ``q_offset + q_stride * i`` (a
    rank's stripe of the rows, see :func:`_attention_sharded`); the
    default is every row in order.  A strided q block visits every KV
    block from its first row's window start to its last row's position.
    """
    b, s, h, hd = q.shape
    l = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    bq = min(bq, s)
    bkv = min(bkv, l)
    pad_q = (-s) % bq
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    pad_kv = (-l) % bkv
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    sq, lk = q.shape[1], k.shape[1]
    nq, nkv = sq // bq, lk // bkv
    qr = q.reshape(b, nq, bq, kvh, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    outs = []
    for qi in range(nq):
        qblk = qr[:, qi]                                  # (b, bq, kvh, g, hd)
        qpos = q_offset + q_stride * (qi * bq + torch.arange(bq, device=dev))
        first = q_offset + q_stride * qi * bq
        last = q_offset + q_stride * (qi * bq + bq - 1)
        lo = max(first - (window - 1), 0) // bkv if window > 0 else 0
        if window > 0 and q_stride == 1:
            hi = lo + min(window // bkv + 2, nkv)
        else:
            hi = min(last // bkv + 1, nkv) if causal and causal_skip else nkv
        m = torch.full((b, kvh, g, bq), -math.inf, device=dev)
        lse = torch.zeros((b, kvh, g, bq), device=dev)
        acc = torch.zeros((b, kvh, g, bq, hd), device=dev)
        for kb in range(lo, max(hi, lo + 1)):
            kblk = _kv_block(k, kb, bkv).float()
            vblk = _kv_block(v, kb, bkv).float()
            kpos = kb * bkv + torch.arange(bkv, device=dev)
            scores = torch.einsum("bqkgh,blkh->bkgql", qblk, kblk) * scale
            mask = (kpos < l)[None, :].expand(bq, bkv)   # kv padding
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            scores = torch.where(mask, scores, MASK_VALUE)
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgql,blkh->bkgqh", p, vblk)
            m = m_new
        out = acc / torch.clamp_min(lse, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (b, bq, kvh, g, hd)
    out = torch.stack(outs, 1).reshape(b, sq, h, hd)[:, :s]
    return out.to(v.dtype)


def _attention_local(q, k, v, *, causal, window, q_offset, q_stride,
                     s_total):
    """One rank's attention over its query rows (at ``q_offset +
    q_stride * i``) against every key: the chunked path when the full
    (S, L) score matrix would pass ``_DENSE_SCORE_LIMIT`` entries, as in
    :func:`attention_apply`, else the dense one with the rows' mask."""
    l = k.shape[1]
    if s_total * l > _DENSE_SCORE_LIMIT:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, q_stride=q_stride)
    i = q_offset + q_stride * torch.arange(q.shape[1], device=q.device)
    j = torch.arange(l, device=q.device)[None, :]
    mask = torch.ones((q.shape[1], l), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i[:, None]
    if window > 0:
        mask &= j > i[:, None] - window
    return _sdpa(q, k, v, mask)


def _attention_sharded(q, k, v, *, causal, window):
    """Attention on DTensors: the batch keeps its sharding and the query
    rows are striped over the other mesh dims (rank ``r`` of ``n`` takes
    rows ``r, r + n, ...``, so causal work is even across ranks) against
    the whole of K and V; each rank runs :func:`_attention_local` on its
    rows, and the rows are put back in order."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    b, s, h, hd = q.shape
    bdims = SH.sharded_dims(q.placements, 0)
    rest = [i for i in range(mesh.ndim) if i not in bdims]
    n = 1
    for i in rest:
        n *= mesh.size(i)
    sdims = rest if n > 1 and s % n == 0 else []
    if not sdims:
        n = 1

    pl = SH.per_dim(mesh)

    q_pl = pl(lambda i: Shard(0) if i in bdims else
              Shard(1) if i in sdims else Replicate())
    kv_pl = pl(lambda i: Shard(0) if i in bdims else Replicate())
    kv_gpl = pl(lambda i: Shard(0) if i in bdims else
                Partial() if i in sdims else Replicate())
    # the stripes are cut and put back on replicated rows, so that no view
    # of a sharded dim is asked of DTensor
    if tuple(q.placements) != kv_pl:
        q = q.redistribute(mesh, kv_pl)
    if n > 1:
        q = q.reshape(b, s // n, n, h, hd).transpose(1, 2).reshape(
            b, s, h, hd)
    r = SH.flat_coordinate(mesh, sdims)
    out = SH.run_local(
        lambda ql, kl, vl: _attention_local(
            ql, kl, vl, causal=causal, window=window, q_offset=r,
            q_stride=n, s_total=s),
        mesh, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl, kv_gpl, kv_gpl),
        (q_pl,))
    if n > 1:
        out = out.redistribute(mesh, kv_pl)
        hv = out.shape[-1]
        out = out.reshape(b, n, s // n, h, hv).transpose(1, 2).reshape(
            b, s, h, hv)
    return out


def causal_mask(s: int, device=None):
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def local_mask(s: int, window: int, device=None):
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (j > i - window)


_DENSE_SCORE_LIMIT = 1024 * 1024


def attention_apply(p, x, cfg: ModelConfig, *, positions,
                    causal: bool = True, window: int = 0,
                    kv_source: Optional[torch.Tensor] = None,
                    use_rope: bool = True):
    """Full-sequence attention (train / prefill).  kv_source != None ->
    cross-attention (keys / values from the encoder or image context).
    Takes the chunked path when the score matrix would pass 1024 x 1024
    entries."""
    src = x if kv_source is None else kv_source
    q = _proj_in(x, p["wq"])
    k = _proj_in(src, p["wk"])
    v = _proj_in(src, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if use_rope and kv_source is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    s, l = q.shape[1], k.shape[1]
    if SH.is_dtensor(q):
        out = _attention_sharded(q, k, v, causal=causal, window=window)
    elif s * l > _DENSE_SCORE_LIMIT:
        out = chunked_attention(q, k, v, causal=causal, window=window)
    else:
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(l, device=x.device)[None, :]
        mask = torch.ones((s, l), dtype=torch.bool, device=x.device)
        if causal:
            mask &= j <= i
        if window > 0:
            mask &= j > i - window
        out = _sdpa(q, k, v, mask)
    return _proj_out(out, p["wo"])


def _write_slot(cache, new, slot):
    """cache[b, slot[b]] = new[b, 0] for every row b, in place.  On a
    DTensor cache the write is local: ``new`` takes the cache's
    placements and ``slot`` its batch sharding."""
    if SH.is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        mesh, pl = cache.device_mesh, tuple(cache.placements)
        bd = SH.sharded_dims(pl, 0)
        slot_pl = tuple(Shard(0) if i in bd else Replicate()
                        for i in range(mesh.ndim))
        new = new.redistribute(mesh, pl).to_local()
        if SH.is_dtensor(slot):
            slot = slot.redistribute(mesh, slot_pl).to_local()
        cache = cache.to_local()
    cache[torch.arange(cache.shape[0], device=cache.device), slot] = \
        new[:, 0].to(cache.dtype)


def attention_decode(p, x, cfg: ModelConfig, cache: KVCache, pos,
                     *, window: int = 0, use_rope: bool = True):
    """One-token decode: x (B, 1, d); cache length L; pos (B,) int.  The
    new K/V go into the ring cache at ``pos % L`` in place."""
    L = cache.k.shape[1]
    q = _proj_in(x, p["wq"])
    k_new = _proj_in(x, p["wk"])
    v_new = _proj_in(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k_new = rmsnorm(p["k_norm"], k_new, cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    _write_slot(cache.k, k_new, pos % L)
    _write_slot(cache.v, v_new, pos % L)
    # ring-cache validity: slot i holds absolute position
    # pos - ((pos - i) mod L); valid iff that position was written (>= 0)
    # and, for a window, inside it
    idx = torch.arange(L, device=x.device)[None, :]
    absolute = pos[:, None] - ((pos[:, None] - idx) % L)
    valid = absolute >= 0
    if window:
        valid &= absolute > (pos[:, None] - window)
    out = _sdpa(q, cache.k, cache.v, valid[:, None, :])
    return _proj_out(out, p["wo"]), cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(tb: TreeBuilder, cfg: ModelConfig, name="attn"):
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    sub = tb.sub(name)
    sub.add("wq", (d, h, qk), ("embed", "heads", "head_dim"), cfg.dtype)
    sub.add("w_dkv", (d, m.kv_lora_rank + m.qk_rope_dim),
            ("embed", None), cfg.dtype)
    sub.ones("kv_norm", m.kv_lora_rank, (None,))
    sub.add("w_uk", (m.kv_lora_rank, h, m.qk_nope_dim),
            (None, "heads", "head_dim"), cfg.dtype)
    sub.add("w_uv", (m.kv_lora_rank, h, m.v_head_dim),
            (None, "heads", "head_dim"), cfg.dtype)
    sub.add("wo", (h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
            cfg.dtype)


def _mla_qkv(p, x, kv_c, k_rope, cfg: ModelConfig, positions, q_positions):
    m: MLAConfig = cfg.mla
    q = _proj_in(x, p["wq"])
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, q_positions, cfg.rope_theta)
    k_nope = _proj_in(kv_c, p["w_uk"])
    v = _proj_in(kv_c, p["w_uv"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    k_rope = k_rope.expand(*k_nope.shape[:3], m.qk_rope_dim)
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope], -1)
    return q_full, k_full, v


def _mla_latent(p, x, cfg: ModelConfig):
    m: MLAConfig = cfg.mla
    latent = SH.linear(x, p["w_dkv"])
    kv_c, k_rope = latent.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    return rmsnorm(p["kv_norm"], kv_c, cfg.norm_eps), k_rope


def mla_apply(p, x, cfg: ModelConfig, *, positions, mask):
    kv_c, k_rope = _mla_latent(p, x, cfg)
    q, k, v = _mla_qkv(p, x, kv_c, k_rope, cfg, positions, positions)
    out = _sdpa(q, k, v, mask)
    return _proj_out(out, p["wo"])


def mla_decode(p, x, cfg: ModelConfig, cache: MLACache, pos):
    """One-token MLA decode; the latent goes into the cache at
    ``pos % L`` in place."""
    L = cache.kv_c.shape[1]
    kv_c_new, k_rope_new = _mla_latent(p, x, cfg)
    _write_slot(cache.kv_c, kv_c_new, pos % L)
    _write_slot(cache.k_rope, k_rope_new, pos % L)
    positions = torch.arange(L, device=x.device)[None, :].expand(
        x.shape[0], L)
    q, k, v = _mla_qkv(p, x, cache.kv_c, cache.k_rope, cfg, positions,
                       pos[:, None])
    valid = torch.arange(L, device=x.device)[None, :] <= pos[:, None]
    out = _sdpa(q, k, v, valid[:, None, :])
    return _proj_out(out, p["wo"]), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None):
    m: MLAConfig = cfg.mla
    return MLACache(
        torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                    device=device))
