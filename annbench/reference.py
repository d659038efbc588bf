"""The plain reference: IVF-PQ search over the harness's CSR arrays.

It works out the probes, the tables and every candidate's distance again
for itself, from the drawn index (``DrawnIndex`` of ``draws/ivfpq.py``)
and the queries, and needs no padded layout.  It imports neither the program nor JAX.

``precision="f64"`` is the reference proper: every step in float64, the
tables in the subtraction form ``sum_d (r_d - c_d)^2``.  The other
precisions are the controls of the correctness check, the reference put
in the program's place one step below what the configuration states
(float32 tables, TF32 off):

* ``"tf32"``: float32 with TF32 matrix products, CL and the tables in the
  expansion form ``|r|^2 + |c|^2 - 2 r.c`` as the program computes them;
  the products' inputs are rounded to TF32 (10 mantissa bits, to nearest
  even) here, so the control does not hang on whether cuBLAS picks a
  TF32 kernel for a shape (it does not for LC's 6-wide products at
  D=96);
* ``"bf16"``: float32 CL, tables rounded to bfloat16 and each row's sum
  rounded once more.

Probe ties.  A query's probes are its ``nprobe`` nearest centroids.
Centroids whose float64 distance lies within ``band`` (relative to
``|q|^2 + |c|^2``) of the ``nprobe``-th one could have fallen either way
in a float32 CL: those are the query's *band*, the nearer ones its
*certain* probes.  ``search`` returns two top-k lists: ``low`` over the
certain probes and the whole band, ``high`` over the certain probes
alone, plus as many band clusters as are needed where the band holds no
more than that (then ``low == high``).  A correct answer over any
admissible probe set lies between them, element by element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BAND = 3e-5            # float32 CL's rounding, with room (see module doc)
EXTRA = 64             # centroids looked at past the nprobe-th for the band


class RefResult(NamedTuple):
    low: torch.Tensor      # (B, k) f64: top-k over certain + band probes
    high: torch.Tensor     # (B, k) f64: top-k over the certain probes
    ids: torch.Tensor      # (B, k) i64: ids of ``low``
    allowed: list          # per query: tensor of admissible cluster ids
    exact: torch.Tensor    # (B,) bool: the probe set is unambiguous


def _sq(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(-1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (nearest even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _matmul_dist(q: torch.Tensor, c: torch.Tensor, cross=None
                 ) -> torch.Tensor:
    """(B, D) x (n, D) -> (B, n) squared distances, expansion form."""
    qc = q @ c.T if cross is None else cross
    return (_sq(q)[:, None] + _sq(c)[None, :] - 2.0 * qc).clamp_min(0)


class Reference:
    """Reference search over one drawn index, on the index's device."""

    def __init__(self, index, nprobe: int, k: int, precision: str = "f64",
                 band: float = BAND):
        if precision not in ("f64", "tf32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.nprobe, self.k, self.band = nprobe, k, band
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        torch.backends.cuda.matmul.allow_tf32 = False
        self.centroids = index.centroids.to(self.dtype)
        self.books = index.codebooks.to(self.dtype)       # (M, CB, dsub)
        self.codes = index.codes
        self.offsets = index.offsets.long()
        self.sizes = self.offsets[1:] - self.offsets[:-1]
        n = index.ids.shape[0]
        self.row_of = torch.empty(n, dtype=torch.int64,
                                  device=index.ids.device)
        self.row_of[index.ids.long()] = torch.arange(
            n, device=index.ids.device)
        self.ids = index.ids

    # -- the pipeline's steps, in the reference's precision ---------------
    def _round(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.precision == "tf32" else x

    def _centroid_dist(self, q: torch.Tensor) -> torch.Tensor:
        c = self.centroids
        return _matmul_dist(q, c, self._round(q) @ self._round(c).T)

    def _tables(self, q: torch.Tensor, clusters: torch.Tensor
                ) -> torch.Tensor:
        """(T,) query rows ``q`` (T, D) with their clusters -> (T, M, CB)."""
        m, cb, dsub = self.books.shape
        r = (q - self.centroids[clusters]).view(-1, m, 1, dsub)
        if self.precision == "f64":
            return _sq(r - self.books)
        cross = torch.einsum("tmd,mcd->tmc", self._round(r[:, :, 0]),
                             self._round(self.books))
        lut = (_sq(r) + _sq(self.books)[None] - 2.0 * cross).clamp_min(0)
        if self.precision == "bf16":
            lut = lut.to(torch.bfloat16).to(torch.float32)
        return lut

    def _row_dist(self, lut: torch.Tensor, task: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
        """Distances of index rows ``rows`` under the tables of ``task``."""
        m, cb = lut.shape[1], lut.shape[2]
        flat = (task[:, None] * (m * cb)
                + torch.arange(m, device=lut.device)[None, :] * cb
                + self.codes[rows].long())
        d = lut.reshape(-1)[flat].sum(1)
        if self.precision == "bf16":
            d = d.to(torch.bfloat16).to(torch.float32)
        return d

    # -- search -----------------------------------------------------------
    def probes(self, q: torch.Tensor):
        """Per query: (certain clusters, band clusters)."""
        dist = self._centroid_dist(q)
        extra = min(self.nprobe + EXTRA, dist.shape[1])
        v, idx = torch.topk(dist, extra, dim=1, largest=False, sorted=True)
        if self.precision != "f64":       # a control takes its own top
            return [(idx[b, :self.nprobe], idx[b, :0])
                    for b in range(q.shape[0])]
        t = v[:, self.nprobe - 1:self.nprobe]
        tol = self.band * (_sq(q)[:, None]
                           + _sq(self.centroids[idx[:, self.nprobe - 1]])
                           [:, None])
        certain = v < t - tol
        banded = (v - t).abs() <= tol
        if extra < dist.shape[1] and bool(banded[:, -1].any()):
            raise RuntimeError("probe band wider than the reference looks")
        return [(idx[b][certain[b]], idx[b][banded[b]])
                for b in range(q.shape[0])]

    def search(self, queries: torch.Tensor, block: int = 16) -> RefResult:
        """Top-k over ``queries`` (B, D), ``block`` queries at a time."""
        out = [self._search_block(queries[s:s + block])
               for s in range(0, queries.shape[0], block)]
        return RefResult(torch.cat([o.low for o in out]),
                         torch.cat([o.high for o in out]),
                         torch.cat([o.ids for o in out]),
                         [a for o in out for a in o.allowed],
                         torch.cat([o.exact for o in out]))

    def _search_block(self, queries: torch.Tensor) -> RefResult:
        q = queries.to(self.dtype)
        dev = q.device
        pr = self.probes(q)
        need = [self.nprobe - len(c) for c, _ in pr]
        exact = torch.tensor([len(b) == n for (_, b), n in zip(pr, need)])
        allowed = [torch.cat([c, b]) for c, b in pr]
        # one task per (query, admissible cluster), certain ones flagged
        qi = torch.cat([torch.full((len(a),), i, dtype=torch.long,
                                   device=dev)
                        for i, a in enumerate(allowed)])
        cl = torch.cat(allowed)
        is_certain = torch.cat([
            torch.arange(len(a), device=dev) < (len(c) + (len(b) if e else 0))
            for a, (c, b), e in zip(allowed, pr, exact.tolist())])
        lut = self._tables(q[qi], cl)
        size = self.sizes[cl]
        task = torch.repeat_interleave(torch.arange(len(cl), device=dev),
                                       size)
        start = torch.cumsum(size, 0) - size
        rows = (self.offsets[cl][task] + torch.arange(len(task), device=dev)
                - start[task])
        d = self._row_dist(lut, task, rows).to(torch.float64)
        owner = qi[task]
        # per query: a padded (B, width) block of its candidates
        count = torch.bincount(owner, minlength=len(pr))
        width = int(count.max())
        first = torch.cumsum(count, 0) - count
        col = torch.arange(len(task), device=dev) - first[owner]
        full = torch.full((len(pr), width), float("inf"),
                          dtype=torch.float64, device=dev)
        full[owner, col] = d
        low, pos = torch.topk(full, self.k, dim=1, largest=False)
        cand_rows = torch.full((len(pr), width), -1, dtype=torch.long,
                               device=dev)
        cand_rows[owner, col] = rows
        ids = self.ids[cand_rows.gather(1, pos)].long()
        full[owner[~is_certain[task]], col[~is_certain[task]]] = float("inf")
        high = torch.topk(full, self.k, dim=1, largest=False).values
        return RefResult(low, high, ids, allowed, exact)

    def true_dist(self, queries: torch.Tensor, ids: torch.Tensor):
        """The distance of each (query, id) pair, (B, k) ids -> (B, k)
        f64, and each id's cluster (-1 for an id that is no index row)."""
        q = queries.to(self.dtype)
        b, k = ids.shape
        flat = ids.reshape(-1).long()
        ok = (flat >= 0) & (flat < self.row_of.shape[0])
        rows = self.row_of[flat.clamp(0, self.row_of.shape[0] - 1)]
        cl = torch.searchsorted(self.offsets, rows, right=True) - 1
        qi = torch.arange(b, device=q.device).repeat_interleave(k)
        lut = self._tables(q[qi], cl)
        d = self._row_dist(lut, torch.arange(b * k, device=q.device), rows)
        d = torch.where(ok, d.to(torch.float64), float("nan"))
        return d.view(b, k), torch.where(ok, cl, -1).view(b, k)
