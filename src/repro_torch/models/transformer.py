"""Composable decoder / encoder-decoder stack over the mixer zoo.

Layer recipe (pre-norm residual):
    x += mixer(norm(x))            mixer in {attn, attn_local, mla, rglru,
                                             ssd, cross_attn}
    [enc-dec only] x += cross_attn(norm(x), enc_out)
    x += ffn_or_moe(norm(x))

Layers are grouped by the smallest period of ``cfg.layer_types``
(``group_structure``), as the reference groups them for its layer scan:
``params["groups"]`` is a list of ``n_groups`` dicts of ``l{j}`` layers
(the reference stacks them on a leading axis), and a non-divisible tail
(recurrentgemma's 26 = 3 x 8 + 2) is ``tail{i}``.  Caches for decode have
the same structure; attention caches are written in place.

Training recomputes activations by group as the reference's scan does
(``cfg.remat``, see ``_remat_group``): a checkpointed group keeps only
its input and reruns its forward in the backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, TreeBuilder
from repro_torch.models import layers as L
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import rglru as RG
from repro_torch.util import resolve_device


# ---------------------------------------------------------------------------
# pattern grouping
# ---------------------------------------------------------------------------

def _pattern_period(types: tuple) -> int:
    n = len(types)
    for p in range(1, n + 1):
        if all(types[i] == types[i % p] for i in range(n - n % p)):
            return p
    return n


def group_structure(cfg: ModelConfig):
    """-> (period, n_groups, tail_types).  Layers [0, period*n_groups) are
    the groups; the rest are the tail."""
    if not cfg.scan_layers:
        return len(cfg.layer_types), 1, ()
    p = _pattern_period(cfg.layer_types)
    n_groups = cfg.n_layers // p
    tail = cfg.layer_types[p * n_groups:]
    return p, n_groups, tail


def _moe_types(cfg: ModelConfig) -> tuple:
    return cfg.moe_layer_types or ("",) * cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(tb: TreeBuilder, cfg: ModelConfig, ltype: str, mtype: str,
                cross_extra: bool):
    L.init_rmsnorm(tb, "norm_mix", cfg.d_model)
    if ltype in ("attn", "attn_local", "cross_attn"):
        A.init_attention(tb, cfg)
    elif ltype == "mla":
        A.init_mla(tb, cfg)
    elif ltype == "rglru":
        RG.init_rglru(tb, cfg)
    elif ltype == "ssd":
        SSM.init_ssd(tb, cfg)
    else:
        raise ValueError(ltype)
    if cross_extra:                       # enc-dec decoder layer
        L.init_rmsnorm(tb, "norm_cross", cfg.d_model)
        A.init_attention(tb, cfg, name="cross")
    if mtype == "moe":
        L.init_rmsnorm(tb, "norm_ffn", cfg.d_model)
        MOE.init_moe(tb, cfg)
    elif cfg.d_ff > 0:
        L.init_rmsnorm(tb, "norm_ffn", cfg.d_model)
        L.init_ffn(tb, cfg)
    # d_ff == 0 (mamba2): pure mixer stack, no channel mixer


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """The parameter tree of ``cfg`` on ``device``, every random tensor
    drawn from one ``torch.Generator`` seeded with ``seed`` on that device,
    tensor by tensor (no f32 copy of the whole model).  On ``"meta"``
    nothing is allocated."""
    return init_params_and_axes(cfg, seed, device=device)[0]


def init_params_and_axes(cfg: ModelConfig, seed: int = 0, *,
                         device="cuda") -> tuple:
    """-> (params, logical axes): :func:`init_params`'s tree and its twin
    of axis-name tuples, as the reference's ``init_params`` returns them
    (``groups`` is a list of per-group axes, each the reference's group
    axes without the leading ``"layers"``)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    tb = TreeBuilder(gen, dev)
    L.init_embedding(tb, cfg)
    if not cfg.tie_embeddings:
        tb.add("lm_head", (cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
               cfg.dtype)
    L.init_rmsnorm(tb, "final_norm", cfg.d_model)

    period, n_groups, tail = group_structure(cfg)
    moe_types = _moe_types(cfg)
    groups, group_axes = [], []
    for _ in range(n_groups):
        gtb = TreeBuilder(gen, dev)
        for j in range(period):
            _init_layer(gtb.sub(f"l{j}"), cfg, cfg.layer_types[j],
                        moe_types[j], cfg.is_encdec)
        groups.append(gtb.params)
        group_axes.append(gtb.axes)
    if groups:
        tb.params["groups"] = groups
        tb.axes["groups"] = group_axes
    for t_i, ltype in enumerate(tail):
        _init_layer(tb.sub(f"tail{t_i}"), cfg, ltype,
                    moe_types[period * n_groups + t_i], cfg.is_encdec)

    if cfg.is_encdec:
        etb = tb.sub("encoder")
        L.init_layernorm(etb, "enc_final_norm", cfg.d_model)
        enc_cfg = dataclasses.replace(cfg, qk_norm=False)
        for e in range(cfg.encoder_layers):
            letb = etb.sub(f"e{e}")
            L.init_rmsnorm(letb, "norm_mix", cfg.d_model)
            A.init_attention(letb, enc_cfg)
            L.init_rmsnorm(letb, "norm_ffn", cfg.d_model)
            L.init_ffn(letb, enc_cfg)
    return tb.params, tb.axes


def _layers(params, cfg: ModelConfig):
    """(layer params, layer type, moe type) for every layer in order."""
    period, n_groups, tail = group_structure(cfg)
    moe_types = _moe_types(cfg)
    for g in range(n_groups):
        for j in range(period):
            yield params["groups"][g][f"l{j}"], cfg.layer_types[j], \
                moe_types[j]
    for t_i, ltype in enumerate(tail):
        yield params[f"tail{t_i}"], ltype, moe_types[period * n_groups + t_i]


# ---------------------------------------------------------------------------
# forward (prefill logits)
# ---------------------------------------------------------------------------

def _apply_mixer(lp, x, cfg: ModelConfig, ltype: str, *, positions, ctx):
    h = L.rmsnorm(lp["norm_mix"], x, cfg.norm_eps)
    if ltype == "attn":
        return A.attention_apply(lp["attn"], h, cfg, positions=positions)
    if ltype == "attn_local":
        return A.attention_apply(lp["attn"], h, cfg, positions=positions,
                                 window=cfg.window)
    if ltype == "mla":
        return A.mla_apply(lp["attn"], h, cfg, positions=positions,
                           mask=A.causal_mask(x.shape[1], x.device))
    if ltype == "cross_attn":
        return A.attention_apply(lp["attn"], h, cfg, positions=positions,
                                 kv_source=ctx, causal=False, use_rope=False)
    if ltype == "rglru":
        return RG.rglru_apply(lp["rglru"], h, cfg)
    if ltype == "ssd":
        return SSM.ssd_apply(lp["ssd"], h, cfg)
    raise ValueError(ltype)


def _channel_mix(lp, x, cfg: ModelConfig, mtype: str, *, positions,
                 enc_out):
    """The enc-dec cross-attention and the FFN / MoE after the mixer."""
    aux = torch.zeros((), device=x.device)
    if cfg.is_encdec:
        h = L.rmsnorm(lp["norm_cross"], x, cfg.norm_eps)
        x = x + A.attention_apply(lp["cross"], h, cfg, positions=positions,
                                  kv_source=enc_out, causal=False,
                                  use_rope=False)
    if mtype == "moe":
        h = L.rmsnorm(lp["norm_ffn"], x, cfg.norm_eps)
        y, aux = MOE.moe_apply(lp["moe"], h, cfg)
        x = x + y
    elif cfg.d_ff > 0:
        h = L.rmsnorm(lp["norm_ffn"], x, cfg.norm_eps)
        x = x + L.ffn_apply(lp["ffn"], h, cfg.ffn)
    return x, aux


def encode(params, cfg: ModelConfig, enc_in: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, T, d)."""
    x = enc_in.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[0], -1)
    ep = params["encoder"]
    enc_cfg = dataclasses.replace(cfg, qk_norm=False)
    for e in range(cfg.encoder_layers):
        lp = ep[f"e{e}"]
        h = L.rmsnorm(lp["norm_mix"], x, cfg.norm_eps)
        x = x + A.attention_apply(lp["attn"], h, enc_cfg, positions=pos,
                                  causal=False, use_rope=True)
        h = L.rmsnorm(lp["norm_ffn"], x, cfg.norm_eps)
        x = x + L.ffn_apply(lp["ffn"], h, enc_cfg.ffn)
    return L.layernorm(ep["enc_final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            ctx: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, S, V) f32, aux losses scalar).

    ctx: encoder frames (whisper) or image patch embeddings (vlm)."""
    b, s = tokens.shape
    x = L.embed(params, tokens).to(cfg.dtype)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_out = None
    if cfg.is_encdec:
        if ctx is None:
            raise ValueError("an enc-dec model needs encoder input (ctx)")
        enc_out = encode(params, cfg, ctx)
    cross_ctx = (ctx.to(cfg.dtype) if ctx is not None and not cfg.is_encdec
                 else None)
    period, n_groups, tail = group_structure(cfg)
    moe_types = _moe_types(cfg)

    def layer(lp, x, ltype, mtype):
        x = x + _apply_mixer(lp, x, cfg, ltype, positions=positions,
                             ctx=cross_ctx)
        return _channel_mix(lp, x, cfg, mtype, positions=positions,
                            enc_out=enc_out)

    def group_body(gp, x):
        aux = torch.zeros((), device=x.device)
        for j in range(period):
            x, a = layer(gp[f"l{j}"], x, cfg.layer_types[j], moe_types[j])
            aux = aux + a
        return x, aux

    aux = torch.zeros((), device=x.device)
    for g in range(n_groups):
        if _remat_group(cfg, g, n_groups):
            x, a = checkpoint(group_body, params["groups"][g], x,
                              use_reentrant=False)
        else:
            x, a = group_body(params["groups"][g], x)
        aux = aux + a
    for t_i, ltype in enumerate(tail):
        x, a = layer(params[f"tail{t_i}"], x, ltype,
                     moe_types[period * n_groups + t_i])
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params, x, cfg), aux


def _remat_group(cfg: ModelConfig, g: int, n_groups: int) -> bool:
    """Whether group ``g`` runs under activation checkpointing: only where
    autograd records (inference paths never do), by the reference's
    ``cfg.remat``: "none" never; "half" with an even ``n_groups`` every
    other group (the first of each pair); any other value every group."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return False
    if cfg.remat == "half" and n_groups % 2 == 0:
        return g % 2 == 0
    return True


# ---------------------------------------------------------------------------
# decode (serving): preallocated caches, one token per step
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ModelConfig, ltype: str, batch: int,
                      max_len: int, dtype, device):
    if ltype in ("attn", "attn_local"):
        # local attention needs only `window` KV slots (a ring)
        ln = min(max_len, cfg.window) if ltype == "attn_local" else max_len
        return A.init_kv_cache(cfg, batch, ln, dtype, device)
    if ltype == "mla":
        return A.init_mla_cache(cfg, batch, max_len, dtype, device)
    if ltype == "rglru":
        return RG.init_rglru_cache(cfg, batch, dtype, device)
    if ltype == "ssd":
        return SSM.init_ssm_cache(cfg, batch, dtype, device)
    if ltype == "cross_attn":
        # the context K/V are recomputed every step, as in the reference
        return {"dummy": torch.zeros((1,), dtype=dtype, device=device)}
    raise ValueError(ltype)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                device="cuda"):
    """Zeroed decode caches in the parameters' structure, on ``device``
    (``"meta"`` allocates nothing)."""
    dtype = dtype or cfg.dtype
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    period, n_groups, tail = group_structure(cfg)
    caches = {}
    if n_groups > 0:
        caches["groups"] = [
            {f"l{j}": _init_layer_cache(cfg, cfg.layer_types[j], batch,
                                        max_len, dtype, dev)
             for j in range(period)} for _ in range(n_groups)]
    for t_i, ltype in enumerate(tail):
        caches[f"tail{t_i}"] = _init_layer_cache(cfg, ltype, batch, max_len,
                                                 dtype, dev)
    return caches


def _cache_slots(caches, cfg: ModelConfig):
    """(container, key) of every layer's cache, in layer order."""
    period, n_groups, tail = group_structure(cfg)
    for g in range(n_groups):
        for j in range(period):
            yield caches["groups"][g], f"l{j}"
    for t_i in range(len(tail)):
        yield caches, f"tail{t_i}"


def _decode_mixer(lp, x, cfg: ModelConfig, ltype: str, cache, pos, ctx):
    h = L.rmsnorm(lp["norm_mix"], x, cfg.norm_eps)
    if ltype == "attn":
        return A.attention_decode(lp["attn"], h, cfg, cache, pos)
    if ltype == "attn_local":
        return A.attention_decode(lp["attn"], h, cfg, cache, pos,
                                  window=cfg.window)
    if ltype == "mla":
        return A.mla_decode(lp["attn"], h, cfg, cache, pos)
    if ltype == "rglru":
        return RG.rglru_decode(lp["rglru"], h, cfg, cache)
    if ltype == "ssd":
        return SSM.ssd_decode(lp["ssd"], h, cfg, cache)
    if ltype == "cross_attn":
        out = A.attention_apply(lp["attn"], h, cfg, positions=pos[:, None],
                                kv_source=ctx, causal=False, use_rope=False)
        return out, cache
    raise ValueError(ltype)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, caches,
                ctx: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None):
    """One decode step.  tokens (B, 1) int, pos (B,) int (0-based index of
    this token), caches from init_caches -> (logits (B, 1, V) f32,
    caches).  The caches are updated in place and returned.

    For enc-dec archs pass ``enc_out`` (from ``encode``); for a VLM pass
    ``ctx`` (patch embeddings)."""
    x = L.embed(params, tokens).to(cfg.dtype)
    cross_ctx = ctx.to(cfg.dtype) if ctx is not None else None
    for (lp, ltype, mtype), (box, key) in zip(_layers(params, cfg),
                                               _cache_slots(caches, cfg)):
        y, box[key] = _decode_mixer(
            lp, x, cfg, ltype, box[key], pos,
            cross_ctx if ltype == "cross_attn" else None)
        x = x + y
        x, _ = _channel_mix(lp, x, cfg, mtype, positions=pos[:, None],
                            enc_out=enc_out)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params, x, cfg), caches
