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
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_out(o, w):
    """``einsum("bshk,hkd->bsd", o, w)`` as one GEMM."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_attention(tb: TreeBuilder, cfg: ModelConfig, name="attn"):
    sub = tb.sub(name)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sub.add("wq", (d, h, hd), cfg.dtype)
    sub.add("wk", (d, kv, hd), cfg.dtype)
    sub.add("wv", (d, kv, hd), cfg.dtype)
    sub.add("wo", (h, hd, d), cfg.dtype)
    if cfg.qk_norm:
        sub.ones("q_norm", hd)
        sub.ones("k_norm", hd)


def _sdpa(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,L,KV,hd) -> (B,S,H,hd_v); grouped heads.

    mask is bool, (S, L) or (B, S, L), True = attend."""
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


def _kv_block(t, kb: int, bkv: int):
    """Block ``kb`` of ``t`` along axis 1, with the start clamped into
    range as ``lax.dynamic_slice`` clamps it (the block's positions are
    still labelled from ``kb``, so such a block is fully masked)."""
    start = min(kb * bkv, t.shape[1] - bkv)
    return t[:, start:start + bkv]


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      bq: int = 512, bkv: int = 512,
                      causal_skip: bool = True):
    """Flash-style attention: online softmax over KV blocks, never
    materialising the (S, L) score matrix; a loop over q blocks.

    For ``window > 0`` (local attention) a q block visits only
    ``window // bkv + 2`` KV blocks from the window's start.  With
    ``causal_skip`` causal full attention visits KV blocks only up to the
    q block's diagonal (the reference's data-dependent trip count);
    ``causal_skip=False`` visits every block, masked.
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
    blocks_needed = min(window // bkv + 2, nkv) if window > 0 else nkv

    outs = []
    for qi in range(nq):
        qblk = qr[:, qi]                                  # (b, bq, kvh, g, hd)
        qpos = qi * bq + torch.arange(bq, device=dev)
        if window > 0:
            kv_base = max(qi * bq - (window - 1), 0) // bkv
            trips = blocks_needed
        else:
            kv_base = 0
            trips = ((qi * bq + bq - 1) // bkv + 1
                     if causal and causal_skip else blocks_needed)
        m = torch.full((b, kvh, g, bq), -math.inf, device=dev)
        lse = torch.zeros((b, kvh, g, bq), device=dev)
        acc = torch.zeros((b, kvh, g, bq, hd), device=dev)
        for j in range(trips):
            kb = kv_base + j
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
    if s * l > _DENSE_SCORE_LIMIT:
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
    """cache[b, slot[b]] = new[b, 0] for every row b, in place."""
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
    sub.add("wq", (d, h, qk), cfg.dtype)
    sub.add("w_dkv", (d, m.kv_lora_rank + m.qk_rope_dim), cfg.dtype)
    sub.ones("kv_norm", m.kv_lora_rank)
    sub.add("w_uk", (m.kv_lora_rank, h, m.qk_nope_dim), cfg.dtype)
    sub.add("w_uv", (m.kv_lora_rank, h, m.v_head_dim), cfg.dtype)
    sub.add("wo", (h, m.v_head_dim, d), cfg.dtype)


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
    latent = x @ p["w_dkv"]
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
