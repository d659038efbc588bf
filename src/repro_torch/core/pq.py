"""Product quantization: codebook training, encoding, decoding, OPQ.

The PQ codebooks are trained on residuals (point - assigned IVF
centroid), the standard IVF-ADC construction.  ``CB`` <= 256 keeps codes
in uint8; larger CB stores int32 codes (``torch.uint16`` has few CUDA
ops, so the port never uses it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kmeans import chunk_rows, kmeans_multi, l2_sq


class PQCodebook(NamedTuple):
    codebooks: torch.Tensor   # (M, CB, dsub) f32
    # squared norms of every codebook entry, reused by every LUT build
    sqnorms: torch.Tensor     # (M, CB) f32

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def cb(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def split_subvectors(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (N, M, D/M)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    return x.reshape(n, m, d // m)


def train_pq(residuals: torch.Tensor, m: int, cb: int, iters: int = 12, *,
             generator: torch.Generator) -> PQCodebook:
    """Train M sub-codebooks of CB entries each on (N, D) residuals."""
    sub = split_subvectors(residuals.float(), m).transpose(0, 1)  # (M, N, ds)
    cbs = kmeans_multi(sub, k=cb, iters=iters, generator=generator).centroids
    return PQCodebook(cbs, (cbs * cbs).sum(-1))


def code_dtype(cb: int) -> torch.dtype:
    return torch.uint8 if cb <= 256 else torch.int32


def encode_pq(codebook: PQCodebook, residuals: torch.Tensor) -> torch.Tensor:
    """Encode (N, D) residuals -> (N, M) codes (argmin per subspace)."""
    n = residuals.shape[0]
    sub = split_subvectors(residuals.float(), codebook.m).transpose(0, 1)
    out = torch.empty((n, codebook.m), dtype=code_dtype(codebook.cb),
                      device=residuals.device)
    chunk = chunk_rows(codebook.m, codebook.cb, n, residuals.device)
    for s in range(0, n, chunk):
        d = l2_sq(sub[:, s:s + chunk], codebook.codebooks)   # (M, c, CB)
        out[s:s + chunk] = d.argmin(dim=-1).T.to(out.dtype)
    return out


def decode_pq(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """(N, M) codes -> (N, D) reconstructed residuals."""
    sub = torch.arange(codebook.m, device=codes.device)[None, :]
    gathered = codebook.codebooks[sub, codes.long()]          # (N, M, dsub)
    return gathered.reshape(codes.shape[0], codebook.dim)


# ---------------------------------------------------------------------------
# OPQ (Ge et al., CVPR'13): learn an orthogonal rotation R minimising PQ
# reconstruction error, then PQ in the rotated space (alternating solver).
# ---------------------------------------------------------------------------

class OPQCodebook(NamedTuple):
    rotation: torch.Tensor     # (D, D) orthogonal
    pq: PQCodebook


def train_opq(residuals: torch.Tensor, m: int, cb: int, outer_iters: int = 4,
              pq_iters: int = 8, *, generator: torch.Generator
              ) -> OPQCodebook:
    """Alternating OPQ: fix R, train PQ; fix PQ, solve Procrustes for R."""
    d = residuals.shape[1]
    x = residuals.float()
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    pq = None
    for _ in range(outer_iters):
        xr = x @ r
        pq = train_pq(xr, m=m, cb=cb, iters=pq_iters, generator=generator)
        recon = decode_pq(pq, encode_pq(pq, xr))               # (N, D)
        # Procrustes: R = argmin ||XR - recon||  =>  R = U V^T of X^T recon
        u, _, vt = torch.linalg.svd(x.T @ recon, full_matrices=False)
        r = u @ vt
    return OPQCodebook(r, pq)
