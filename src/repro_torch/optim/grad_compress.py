"""Gradient compression for a slow all-reduce: int8 + error feedback.

The reference's transform (``src/repro/optim/grad_compress.py``): each
tensor becomes int8 with one f32 scale (``max_abs / 127``), 4x fewer
bytes than bf16 on the wire; the error-feedback residual carries the
quantization error into the next step (Karimireddy et al., 2019), so the
applied gradient stays unbiased over steps.

Rounding is half to even (``torch.round``, as ``jnp.round``).  The scale
divides by a tensor, not a literal: on CUDA ``x / 127.0`` is compiled to
a multiply by the reciprocal, which is not the reference's division.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_map


def _scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.to(torch.float32).abs().max(), 1e-12) \
        / torch.tensor(127.0, device=x.device)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127,
                       127).to(torch.int8)


def compress_int8(tree):
    """-> (int8 tree, f32 scale tree). scale = max_abs / 127."""
    scales = tree_map(_scale, tree)
    return _zip_map(_quantize, tree, scales), scales


def decompress_int8(qtree, scales):
    return _zip_map(lambda q, s: q.to(torch.float32) * s, qtree, scales)


def _zip_map(fn, a, b):
    """``fn`` over the paired tensors of two trees of one structure."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _zip_map(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_zip_map(fn, x, y) for x, y in zip(a, b)))
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    raise TypeError(f"unexpected leaf {type(a)}")


class ErrorFeedbackState(NamedTuple):
    residual: Any


def ef_init(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def ef_step(grads, state: ErrorFeedbackState):
    """Error-feedback compress/decompress round trip: returns the gradient
    actually applied this step plus the carried residual."""
    corrected = _zip_map(lambda g, r: g.to(torch.float32) + r, grads,
                         state.residual)
    q, s = compress_int8(corrected)
    deq = decompress_int8(q, s)
    new_res = _zip_map(lambda c, d: c - d, corrected, deq)
    return deq, ErrorFeedbackState(new_res)
