"""The yardstick of the kernels' roofline shares: the H100's peaks, the
bytes and operations that kernels A (LC, ``lut_build_kernel``) and C (DC,
``pq_scan_kernel``) need for the work of a window, and the harness's own
count of the index rows that work covers.

A frozen copy of ``chip_smoke.py``'s counts (``lut_bytes_ops`` and the
``pq_scan_dc`` row of ``main_shape_report``), f32 tables only, with C's
output cut to what the search needs: the distances of the real rows, not
the padding a layout adds.  Each input byte is counted once and each
output byte once, whatever a kernel reads again, so a share above 100%
means a count or a time is wrong.  Nothing here reads the program's
layout: the rows come from the drawn index's cluster sizes.

The bound of a window's launches is ``bound_s`` of their summed bytes and
operations.  It never exceeds the sum of the launches' own bounds, and
equals it where every launch is bound by the same term: C does under one
operation a byte, A about ``(2 * dsub + 4) / 4``, both under the peaks'
ratio of 20 at every ``dsub`` under 38, so both are bytes-bound.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, 700 W
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the work could take: bytes or operations at peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def lut_bytes_ops(t: int, m: int, cb: int, dsub: int, launches: int = 1):
    """A on ``t`` residual rows over ``launches`` launches: reads the
    (t, M*dsub) f32 residuals once, the (M, CB, dsub) f32 codebooks and
    their (M, CB) f32 norms once a launch, writes the (t, M, CB) f32 table
    once; per entry ``dsub`` FMAs, the combination and the clamp
    (``2 * dsub + 4``), per (row, subspace) ``|r|^2`` (``2 * dsub``)."""
    nbytes = (t * m * dsub * 4 + launches * (m * cb * dsub * 4 + m * cb * 4)
              + t * m * cb * 4)
    ops = t * m * cb * (2 * dsub + 4) + t * m * 2 * dsub
    return nbytes, ops


def dc_bytes_ops(t: int, m: int, cb: int, rows: int, code_bytes: int = 1):
    """C on ``t`` tasks (query, probed cluster) that hold ``rows`` index
    rows between them: reads each task's (M, CB) f32 table, the rows'
    codes and the (t,) i32 sizes once, writes the rows' f32 distances
    once; one add per row and subspace."""
    nbytes = t * m * cb * 4 + rows * m * code_bytes + t * 4 + rows * 4
    return nbytes, rows * m


def probed_rows(centroids: torch.Tensor, sizes: torch.Tensor,
                queries: torch.Tensor, nprobe: int,
                block: int = 4096):
    """(Q,) int64 numpy: the index rows each query's ``nprobe`` nearest
    clusters hold (float32 distances)."""
    cc = (centroids * centroids).sum(1)
    sizes = sizes.long()
    out = []
    for s in range(0, len(queries), block):
        q = queries[s:s + block]
        d = (q * q).sum(1, keepdim=True) + cc[None] - 2.0 * (q @ centroids.T)
        p = torch.topk(d, nprobe, dim=1, largest=False).indices
        out.append(sizes[p].sum(1).cpu())
    return torch.cat(out).numpy()
