"""The plain reference of a search on uint8 ADC tables.

It is :class:`annbench.reference.Reference` (the same probes, probe-tie
band and candidate lists) with two steps replaced, for the semantics a
configuration with ``"lut_dtype": "uint8"`` states:

* the tables: each (query, probe) table in float64, subtraction form
  ``sum_d (r_d - c_d)^2``, rounded once to float32, then quantized per
  subspace as the configuration states: ``step = (max - min) / 255`` in
  float32 (1 where ``max == min``), ``bias = min``, ``q = clamp(round((v
  - min) / step), 0, 255)`` with IEEE divisions and round half to even;
* a row's distance: ``sum_m step_m * q_m + sum_m bias_m``, in float64.

``table`` names the controls of the check, a table of another precision
in the program's place:

* ``"f32"``: the float32 table unquantized (a higher precision than the
  configuration states: a different result);
* ``"u7"``: a 7-bit table, ``step = (max - min) / 127``.

Imports neither the program nor JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from annbench.reference import BAND, Reference

LEVELS = {"u8": 255.0, "u7": 127.0}
TABLES = ("u8", "f32", "u7")


class Table(NamedTuple):
    """Quantized tables of T tasks: ``q`` (T, M, CB) f32 holding integers
    (or the float32 entries, for ``"f32"``), ``step`` and ``bias`` (T, M)
    f32."""
    q: torch.Tensor
    step: torch.Tensor
    bias: torch.Tensor


def quantize(lut: torch.Tensor, levels: float) -> Table:
    """(..., M, CB) float32 tables -> their ``levels``-step affine form,
    per (task, subspace), in float32 with true divisions."""
    lo = lut.amin(-1)
    hi = lut.amax(-1)
    step = (hi - lo) / torch.full_like(hi, levels)
    step = torch.where(hi > lo, step, torch.ones_like(step))
    q = torch.round((lut - lo[..., None]) / step[..., None])
    return Table(q.clamp_(0.0, levels), step, lo)


class ReferenceU8(Reference):
    """Reference search on uint8 tables over one drawn index."""

    def __init__(self, index, nprobe: int, k: int, table: str = "u8",
                 band: float = BAND):
        if table not in TABLES:
            raise ValueError(f"unknown table {table!r}")
        super().__init__(index, nprobe, k, "f64", band)
        self.table = table

    def _tables(self, q: torch.Tensor, clusters: torch.Tensor) -> Table:
        lut = super()._tables(q, clusters).to(torch.float32)
        if self.table == "f32":
            return Table(lut, torch.ones_like(lut[..., 0]),
                         torch.zeros_like(lut[..., 0]))
        return quantize(lut, LEVELS[self.table])

    def _row_dist(self, lut: Table, task: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
        m, cb = lut.q.shape[1], lut.q.shape[2]
        flat = (task[:, None] * (m * cb)
                + torch.arange(m, device=lut.q.device)[None, :] * cb
                + self.codes[rows].long())
        q = lut.q.reshape(-1)[flat].to(torch.float64)
        return ((q * lut.step[task].to(torch.float64)).sum(1)
                + lut.bias[task].to(torch.float64).sum(1))

    def count(self, queries: torch.Tensor, clusters: torch.Tensor
              ) -> torch.Tensor:
        """One count of each (query, cluster) task: the largest step of
        its uint8 table.  ``queries`` (B, D), ``clusters`` (B, n) -> (B,
        n) f64; a cluster id outside the index reads 0."""
        b, n = clusters.shape
        nlist = self.centroids.shape[0]
        ok = (clusters >= 0) & (clusters < nlist)
        cl = clusters.clamp(0, nlist - 1).reshape(-1)
        qi = torch.arange(b, device=cl.device).repeat_interleave(n)
        lut = super()._tables(queries.to(self.dtype)[qi], cl)
        step = quantize(lut.to(torch.float32), LEVELS["u8"]).step
        top = step.amax(-1).to(torch.float64).view(b, n)
        return torch.where(ok, top, 0.0)

    def query_count(self, queries: torch.Tensor, allowed: list
                    ) -> torch.Tensor:
        """One count of each query: the largest of its admissible tasks'
        counts.  ``allowed``: per query, its admissible clusters (as
        ``RefResult.allowed``) -> (B,) f64."""
        width = max(len(a) for a in allowed)
        pad = torch.full((len(allowed), width), -1, dtype=torch.long,
                         device=queries.device)
        for j, a in enumerate(allowed):
            pad[j, :len(a)] = a
        return self.count(queries, pad).amax(1)
