"""The yardstick of the uint8 tables' roofline shares: the bytes and
operations that kernels B (LC into a uint8 table, ``lut_build_kernel``
with ``kOut`` 1) and D (DC over a uint8 table, ``pq_scan_kernel`` with
kind 1) need for the work of a window, at the peaks of
``annbench.roofline``.

As there, each input byte is counted once and each output byte once,
whatever a kernel reads again, and D's output is the real rows'
distances, not the padding a layout adds; a share above 100% means a
count or a time is wrong.  B is bound by its operations (about 23 an
entry against a byte), D by its bytes.
"""

from __future__ import annotations


def lut_u8_bytes_ops(t: int, m: int, cb: int, dsub: int, launches: int = 1):
    """B on ``t`` residual rows over ``launches`` launches: reads the (t,
    M*dsub) f32 residuals once, the (M, CB, dsub) f32 codebooks and their
    (M, CB) f32 norms once a launch, writes the (t, M, CB) u8 table and
    its (t, M) f32 scales and biases once; A's operations (per entry
    ``dsub`` FMAs, the combination and the clamp, per (row, subspace)
    ``|r|^2``) plus, per entry, the min, the max and one division."""
    nbytes = (t * m * dsub * 4 + launches * (m * cb * dsub * 4 + m * cb * 4)
              + t * m * cb + t * m * 8)
    ops = t * m * cb * (2 * dsub + 4 + 3) + t * m * 2 * dsub
    return nbytes, ops


def dc_u8_bytes_ops(t: int, m: int, cb: int, rows: int, code_bytes: int = 1):
    """D on ``t`` tasks (query, probed cluster) that hold ``rows`` index
    rows between them: reads each task's (M, CB) u8 table with its M f32
    scales and M f32 biases, the rows' codes and the (t,) i32 sizes once,
    writes the rows' f32 distances once; per row and subspace a multiply
    and an add, per task the biases' sum."""
    nbytes = t * (m * cb + 8 * m) + rows * m * code_bytes + t * 4 + rows * 4
    return nbytes, rows * m * 2 + t * m
