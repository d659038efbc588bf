"""Asymmetric distance computation (ADC): LUT construction + PQ code scan.

The plain PyTorch versions of the LC and DC phases.  The CUDA kernels in
``repro_torch.kernels`` compute the same functions and are checked
against these on the card; on CPU tensors ``kernels.ops`` runs these.

  RC  residual = query - centroid                      (per (q, probe) pair)
  LC  lut[m, cb] = || residual_m - codebook[m, cb] ||^2
  DC  dist[i]   = sum_m lut[m, codes[i, m]]

bf16 tables: each entry is widened to f32 and a row's terms are summed
in f32, then the sum is rounded once to bf16 (round to nearest even) and
widened back, the reference's ``jnp.sum`` over a bf16 gather.

Quantized-LUT path: :func:`quantize_lut` compresses each (M, CB) table
to uint8 with a per-subspace affine map ``lut ~ lut_q * scale_m +
bias_m``, so ``dist ~ sum_m scale_m * lut_q[m, code_m] + sum_m bias_m``.
The error per subspace is at most ``scale_m / 2``.

``strategy`` ("gather" | "onehot") picks a TPU dataflow in the JAX
package; both name the same function, so the port accepts either and
computes the gather form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.pq import PQCodebook
from repro_torch.util import ieee_f32_matmul

_STRATEGIES = ("gather", "onehot")


def check_strategy(strategy: str) -> None:
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")


def build_lut_batch(codebook: PQCodebook, residuals: torch.Tensor
                    ) -> torch.Tensor:
    """LC: (T, D) residuals -> (T, M, CB) LUTs of squared subvector
    distances, expansion form ||r||^2 + ||c||^2 - 2 r.c clamped at 0 (the
    form the LC kernel computes)."""
    ieee_f32_matmul()
    r = residuals.float().reshape(-1, codebook.m, codebook.dsub)
    cross = torch.einsum("tmd,mcd->tmc", r, codebook.codebooks)
    rsq = (r * r).sum(-1, keepdim=True)                       # (T, M, 1)
    return (rsq + codebook.sqnorms - 2.0 * cross).clamp_min_(0.0)


def build_lut(codebook: PQCodebook, residual: torch.Tensor) -> torch.Tensor:
    """LC for one (D,) residual -> (M, CB)."""
    return build_lut_batch(codebook, residual[None])[0]


def build_lut_direct(codebook: PQCodebook, residual: torch.Tensor
                     ) -> torch.Tensor:
    """Subtraction-form LC, ``sum_d (r_d - c_d)^2``: (..., D) residuals ->
    (..., M, CB).  No cancellation, so it is the oracle of the expansion
    form and the basis of the multiplier-less integer path."""
    r = residual.float().reshape(*residual.shape[:-1], codebook.m, 1,
                                 codebook.dsub)
    diff = r - codebook.codebooks                       # (..., M, CB, dsub)
    return (diff * diff).sum(-1)


def scan_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """DC via gather, batched: lut (T, M, CB), codes (T, C, M) -> (T, C)
    f32.  A bf16 table's terms are summed in f32 in order m = 0..M-1 (the
    kernels' order) and each row's sum is rounded once to bf16."""
    if lut.dtype == torch.bfloat16:
        g = torch.gather(lut, 2, codes.transpose(1, 2).long())   # (T, M, C)
        acc = g[:, 0].float()
        for m in range(1, g.shape[1]):
            acc = acc + g[:, m].float()
        return acc.to(torch.bfloat16).float()
    g = torch.gather(lut.float(), 2, codes.transpose(1, 2).long())  # (T, M, C)
    return g.sum(1)


def _onehot(codes: torch.Tensor, cb: int, dtype) -> torch.Tensor:
    """(T, C, M) codes -> (T, C, M, CB) one-hot in ``dtype``."""
    return torch.nn.functional.one_hot(codes.long(), cb).to(dtype)


def scan_codes_onehot(lut: torch.Tensor, codes: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """DC as a one-hot contraction, the JAX package's matrix-unit form of
    :func:`scan_codes`: ``onehot(codes) (C, M*CB) @ lut.flatten()``, per
    task.  (T, M, CB), (T, C, M) -> (T, C); the same sum as the gather
    (each row has exactly M nonzero terms) up to f32 order."""
    t, c, m = codes.shape
    flat = _onehot(codes, lut.shape[-1], compute_dtype).reshape(t, c, -1)
    return torch.bmm(flat, lut.reshape(t, -1, 1).to(compute_dtype))[..., 0]


def _mask_sizes(d: torch.Tensor, sizes: Optional[torch.Tensor]
                ) -> torch.Tensor:
    if sizes is None:
        return d
    valid = (torch.arange(d.shape[1], device=d.device)[None, :]
             < sizes[:, None])
    return d.masked_fill_(~valid, float("inf"))


def adc_distances(lut: torch.Tensor, codes: torch.Tensor,
                  sizes: Optional[torch.Tensor] = None,
                  strategy: str = "gather") -> torch.Tensor:
    """Batched DC over padded clusters.

    lut    (T, M, CB)   one LUT per task (= (query, probe) pair), f32 or
                        bf16 (:func:`scan_codes`)
    codes  (T, C, M)    padded cluster codes per task
    sizes  (T,)         valid row count per task (None = all valid)
    -> dists (T, C), padding rows set to +inf.
    """
    check_strategy(strategy)
    return _mask_sizes(scan_codes(lut, codes), sizes)


# --------------------------------------------------------------------------
# Quantized-LUT path (uint8 + per-(task, subspace) affine scales)
# --------------------------------------------------------------------------

class QuantizedLUT(NamedTuple):
    """A uint8 LUT with per-subspace affine dequantization parameters.

      lut_q  (..., M, CB)  uint8, quantized table entries
      scale  (..., M)      f32, per-subspace step (max - min) / 255
      bias   (..., M)      f32, per-subspace minimum

    A degenerate subspace (max == min) stores scale=1 with all-zero codes
    so the roundtrip is exact there.
    """
    lut_q: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def quantize_lut(lut: torch.Tensor) -> QuantizedLUT:
    """Affine uint8 quantization over the CB axis, per (task, subspace).

    Bit-for-bit the reference's arithmetic: true IEEE divisions and
    round-half-to-even.  Both divisors are tensors on purpose: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    can differ from the division in the last bit.
    """
    lut = lut.float()
    lo = lut.amin(-1)                                       # (..., M)
    hi = lut.amax(-1)
    step = (hi - lo) / torch.full_like(hi, 255.0)
    scale = torch.where(hi > lo, step, torch.ones_like(step))
    q = torch.round((lut - lo[..., None]) / scale[..., None])
    return QuantizedLUT(q.clamp_(0.0, 255.0).to(torch.uint8), scale, lo)


def dequantize_lut(qlut: QuantizedLUT) -> torch.Tensor:
    """(..., M, CB) f32 reconstruction (max error scale/2 per entry)."""
    return qlut.lut_q.float() * qlut.scale[..., None] + qlut.bias[..., None]


def scan_codes_quantized(qlut: QuantizedLUT, codes: torch.Tensor
                         ) -> torch.Tensor:
    """Quantized DC via gather, batched: per subspace gather the uint8
    entry and accumulate ``scale_m * entry``; one ``sum_m bias_m`` at the
    end.  (T, M, CB) u8 table, codes (T, C, M) -> (T, C)."""
    g = torch.gather(qlut.lut_q, 2, codes.transpose(1, 2).long())  # (T, M, C)
    acc = (g.float() * qlut.scale[:, :, None]).sum(1)
    return acc + qlut.bias.sum(-1, keepdim=True)


def scan_codes_onehot_quantized(qlut: QuantizedLUT, codes: torch.Tensor
                                ) -> torch.Tensor:
    """Quantized DC as a one-hot contraction, the uint8 mirror of
    :func:`scan_codes_onehot`: per-subspace sums of the one-hot against
    the uint8 table (0/1 and integers <= 255 are exact in f32), then one
    ``(M,) x (M, C)`` scale contraction and the bias sum.  (T, M, CB) u8
    table, codes (T, C, M) -> (T, C)."""
    onehot = _onehot(codes, qlut.lut_q.shape[-1], torch.float32)
    acc = torch.einsum("tcmk,tmk->tmc", onehot, qlut.lut_q.float())
    return (torch.einsum("tm,tmc->tc", qlut.scale, acc)
            + qlut.bias.sum(-1, keepdim=True))


def adc_distances_quantized(qlut: QuantizedLUT, codes: torch.Tensor,
                            sizes: Optional[torch.Tensor] = None,
                            strategy: str = "gather") -> torch.Tensor:
    """Batched quantized DC, a drop-in for :func:`adc_distances` with a
    (T,)-batched :class:`QuantizedLUT` instead of the f32 table."""
    check_strategy(strategy)
    return _mask_sizes(scan_codes_quantized(qlut, codes), sizes)
