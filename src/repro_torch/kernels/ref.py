"""Plain PyTorch oracles for the kernels, independent of their math.

The LC oracle uses the direct subtraction form, not the kernel's
expansion form, so a test against it checks the algebra as well.
"""

from __future__ import annotations

import torch


def lut_build_ref(residuals: torch.Tensor, codebooks: torch.Tensor,
                  sqnorms: torch.Tensor) -> torch.Tensor:
    """residuals (T, M, dsub), codebooks (M, CB, dsub), sqnorms (M, CB)
    -> (T, M, CB), as sum_d (r_d - c_d)^2."""
    diff = residuals.float()[:, :, None, :] - codebooks.float()[None]
    return (diff * diff).sum(-1)


def pq_scan_dc_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (T, M, CB), codes (T, C, M) -> dists (T, C), one subspace at a
    time."""
    t, c, m = codes.shape
    rows = torch.arange(t, device=lut.device)[:, None]
    acc = torch.zeros((t, c), dtype=torch.float32, device=lut.device)
    for mm in range(m):
        acc += lut[:, mm].float()[rows, codes[:, :, mm].long()]
    return acc


def pq_scan_topk_ref(lut: torch.Tensor, codes: torch.Tensor,
                     ids: torch.Tensor, sizes: torch.Tensor, k_pad: int):
    """Oracle for the fused DC+TS kernels: full scan, sizes mask, top-k.
    Masked rows come out as (+inf, -1)."""
    d = pq_scan_dc_ref(lut, codes)
    valid = (torch.arange(d.shape[1], device=d.device)[None, :]
             < sizes[:, None])
    d = d.masked_fill(~valid, float("inf"))
    ids = ids.masked_fill(~valid, -1)
    bd, idx = torch.topk(d, k_pad, dim=-1, largest=False, sorted=True)
    return bd, torch.gather(ids, -1, idx)
