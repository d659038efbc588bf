"""Multiplier-less ANNS conversion (paper §III-A): the lossless square LUT.

UPMEM DPUs have no hardware multiplier: a 32-bit multiply costs ~32
cycles against 1 for an add or an (8-byte-aligned) WRAM load.  DRIM-ANN
therefore replaces every square in the L2 distance with a table lookup:

    (a - b)^2  ->  SQ[a - b],   SQ[v] = v^2 precomputed offline.

For B-bit operands the difference lies in [-(2^B - 1), 2^B - 1], so the
table has 2^(B+1) - 1 entries (511 for uint8 data).

This module is that conversion in plain torch integer arithmetic, int32
throughout as in the reference, so tests can assert losslessness, plus the
quantized LC and DC phases that use it.  Every function also takes leading
batch axes (what ``jax.vmap`` over the reference's one-residual function
computes); the one-residual call returns exactly the reference's result.

Overflow: at D=128, M=16 (dsub 8) and 8-bit operands the largest table
entry is 8 * 510^2 = 2,080,800 and a 16-term distance at most
33,292,800, well below 2^31 - 1, so int32 sums are exact.

GPU note: the H100's multiply is as cheap as an add and its gathers are
not, so on the card this path is a paper-faithful oracle, not a fast path
(the reference's TPU note says the same of the MXU); the float LC and DC
kernels serve search.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.pq import PQCodebook

# a padded row's distance: above any real one (see the overflow bound)
INT_PAD = torch.iinfo(torch.int32).max


def make_square_lut(bits: int = 8, device="cpu") -> torch.Tensor:
    """SQ table for B-bit unsigned operands: index (v + vmax) for v in
    [-vmax, vmax], vmax = 2^bits - 1.  int32 entries (exact to |v| < 2^15).
    """
    vmax = (1 << bits) - 1
    v = torch.arange(-vmax, vmax + 1, dtype=torch.int32, device=device)
    return v * v                                         # (2*vmax + 1,)


def square_via_lut(diff: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """Exact v^2 by lookup; ``diff`` int32 in [-vmax, vmax], any shape.
    The index is cast to int64: an integer tensor of another dtype (uint8
    above all) would index as a boolean mask, not gather."""
    vmax = (sq.shape[0] - 1) // 2
    return sq[(diff + vmax).long()]


class QuantizedCodebook(NamedTuple):
    """Integer-quantized PQ codebook for the multiplier-less path.

    Residual values are quantized to the same grid as the (uint8) corpus,
    q(x) = round(x / scale), so quantized differences stay within the SQ
    table's range and the LUT built here equals scale^2 times the integer
    LUT: lossless in the integer domain.
    """
    codebooks_q: torch.Tensor   # (M, CB, dsub) i32
    scale: torch.Tensor         # () f32, on the codebook's device
    sq: torch.Tensor            # (2*vmax + 1,) i32


def _quantize(x: torch.Tensor, scale, vmax: int) -> torch.Tensor:
    """clip(round(x / scale), -vmax, vmax) as int32, by a true IEEE
    division: the divisor is a tensor on x's device, because PyTorch's
    CUDA division by a Python or CPU scalar multiplies by its reciprocal,
    which can land a .5 boundary on the other integer.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x = x.float()
    s = torch.as_tensor(scale, dtype=torch.float32).to(x.device)
    q = torch.round(x / s.expand_as(x))
    return q.clamp_(-vmax, vmax).to(torch.int32)


def quantize_codebook(codebook: PQCodebook, scale, bits: int = 8
                      ) -> QuantizedCodebook:
    """Quantize codebook entries to the B-bit grid (values in [-vmax,
    vmax], vmax = 2^bits - 1, a uint8 corpus's residual range).  The
    square table is sized for the *difference* of two such values
    (+-2 vmax), the operand the DPU squares: the paper's 2^(B+1)-entry
    table."""
    cbs = codebook.codebooks
    vmax = (1 << bits) - 1
    return QuantizedCodebook(
        _quantize(cbs, scale, vmax),
        torch.as_tensor(scale, dtype=torch.float32).to(cbs.device),
        make_square_lut(bits + 1, device=cbs.device))


def quantize_residual(residual: torch.Tensor, scale, bits: int = 8
                      ) -> torch.Tensor:
    """(..., D) residuals -> (..., D) int32 on the codebook's grid."""
    return _quantize(residual, scale, (1 << bits) - 1)


def _clipped_diff(qcb: QuantizedCodebook, residual_q: torch.Tensor
                  ) -> torch.Tensor:
    """(..., D) int32 -> (..., M, CB, dsub) int32 clipped differences."""
    m, _, dsub = qcb.codebooks_q.shape
    r = residual_q.reshape(*residual_q.shape[:-1], m, 1, dsub)
    vmax = (qcb.sq.shape[0] - 1) // 2
    return (r - qcb.codebooks_q).clamp_(-vmax, vmax)


def build_lut_multiplierless(qcb: QuantizedCodebook,
                             residual_q: torch.Tensor) -> torch.Tensor:
    """LC without a single multiply (integer domain):

    lut_int[..., m, cb] = sum_d SQ[r_q[..., m, d] - c_q[m, cb, d]]  (int32)

    ``residual_q`` (..., D) int32, quantized with the codebook's scale.
    Returns the *integer* LUT (..., M, CB); a caller comparing with the
    float path scales it by scale^2 (ranking does not change under a
    positive scale)."""
    diff = _clipped_diff(qcb, residual_q)
    return square_via_lut(diff, qcb.sq).sum(-1, dtype=torch.int32)


def build_lut_int_reference(qcb: QuantizedCodebook,
                            residual_q: torch.Tensor) -> torch.Tensor:
    """The same integer LUT computed WITH multiplies: the losslessness
    oracle."""
    diff = _clipped_diff(qcb, residual_q)
    return (diff * diff).sum(-1, dtype=torch.int32)


def scan_codes_int(lut_int: torch.Tensor, codes: torch.Tensor
                   ) -> torch.Tensor:
    """Integer DC, adds only (the DPU loop): lut_int (..., M, CB) int32,
    codes (..., C, M) of any integer dtype -> (..., C) int32 distances.

    There is no ``sizes`` mask: on padded clusters the caller masks the
    rows at or past a cluster's size itself before any top-k, in int32
    with :data:`INT_PAD` (``torch.iinfo(torch.int32).max``), which no real
    distance reaches (module docstring)."""
    idx = codes.transpose(-1, -2).long()                 # (..., M, C)
    return torch.gather(lut_int, -1, idx).sum(-2, dtype=torch.int32)
