"""Parameter, cache and input specs on the ``meta`` device: every tensor
of a config's parameter tree, decode caches or a cell's inputs with its
shape and dtype, and nothing allocated, so a full config is counted and
checked on any host."""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeCell
from repro_torch.models import ModelConfig, init_caches, init_params_and_axes
from repro_torch.models.common import count_params

_META = torch.device("meta")


def param_specs(cfg: ModelConfig) -> tuple:
    """-> (the parameter tree of ``cfg`` as meta tensors, its logical-axes
    twin tree), as the reference's ``param_specs`` returns them."""
    return init_params_and_axes(cfg, device="meta")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode caches of ``cfg`` as meta tensors."""
    return init_caches(cfg, batch, max_len, device="meta")


def count_params_analytic(cfg: ModelConfig) -> int:
    return count_params(param_specs(cfg)[0])


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _ctx_spec(cfg: ModelConfig, batch: int):
    if cfg.is_encdec:
        return _meta((batch, cfg.encoder_ctx, cfg.d_model), torch.float32)
    if "cross_attn" in cfg.layer_types:
        return _meta((batch, cfg.vision_ctx, cfg.d_model), torch.float32)
    return None


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The model inputs for one (arch x shape) cell, as meta tensors.

    train:   {tokens (B,S), labels (B,S), [ctx]}
    prefill: {tokens (B,S), [ctx]}
    decode:  {tokens (B,1), pos (B,), caches, [ctx | enc_out]}
    """
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, s), i32)}
        if cell.kind == "train":
            out["labels"] = _meta((b, s), i32)
        ctx = _ctx_spec(cfg, b)
        if ctx is not None:
            out["ctx"] = ctx
        return out
    if cell.kind == "decode":
        out = {"tokens": _meta((b, 1), i32), "pos": _meta((b,), i32),
               "caches": cache_specs(cfg, b, s)}
        if cfg.is_encdec:
            out["enc_out"] = _meta((b, cfg.encoder_ctx, cfg.d_model),
                                   cfg.dtype)
        else:
            ctx = _ctx_spec(cfg, b)
            if ctx is not None:
                out["ctx"] = ctx
        return out
    raise ValueError(cell.kind)
