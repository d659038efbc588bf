"""Asymmetric distance computation (ADC): LUT construction + PQ code scan.

The plain PyTorch versions of the LC and DC phases.  The CUDA kernels in
``repro_torch.kernels`` compute the same functions and are checked
against these on the card; on CPU tensors ``kernels.ops`` runs these.

  RC  residual = query - centroid                      (per (q, probe) pair)
  LC  lut[m, cb] = || residual_m - codebook[m, cb] ||^2
  DC  dist[i]   = sum_m lut[m, codes[i, m]]

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


def scan_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """DC via gather, batched: lut (T, M, CB), codes (T, C, M) -> (T, C)."""
    g = torch.gather(lut.float(), 2, codes.transpose(1, 2).long())  # (T, M, C)
    return g.sum(1)


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

    lut    (T, M, CB)   one LUT per task (= (query, probe) pair)
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


def adc_distances_quantized(qlut: QuantizedLUT, codes: torch.Tensor,
                            sizes: Optional[torch.Tensor] = None,
                            strategy: str = "gather") -> torch.Tensor:
    """Batched quantized DC, a drop-in for :func:`adc_distances` with a
    (T,)-batched :class:`QuantizedLUT` instead of the f32 table."""
    check_strategy(strategy)
    return _mask_sizes(scan_codes_quantized(qlut, codes), sizes)
