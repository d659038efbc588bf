"""DPQ: differentiable product quantization (Klein & Wolf, CVPR'19).

The third index variant the paper's engine supports (§I: "IVF-PQ and its
variants, including OPQ [16] and DPQ [25]").  Codebooks are *learned* by
gradient descent on the reconstruction loss instead of per-subspace
k-means: the hard argmin assignment is relaxed with a temperature softmax
and straight-through gradients, so the quantizer trains end to end.

After training the result is an ordinary ``PQCodebook``: the whole search
stack (LC and DC kernels, the multiplier-less conversion, the sharded
engine) consumes it unchanged.  The gradient is plain autograd; Adam is
written out as the reference writes it (beta1 0.9, beta2 0.99, bias
correction from t = 1), not ``torch.optim.Adam`` (beta2 0.999 by default,
another float order).  Every GEMM runs in IEEE float32 (no TF32).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kmeans import _init_idx, l2_sq
from repro_torch.core.pq import PQCodebook, split_subvectors, train_pq
from repro_torch.util import ieee_f32_matmul


def _sub_dists(sub: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """sub (N, M, dsub), books (M, CB, dsub) -> (N, M, CB) squared L2,
    one IEEE-f32 GEMM per subspace (``kmeans.l2_sq``)."""
    return l2_sq(sub.transpose(0, 1), books).transpose(0, 1)


def _soft_assign(sub, books, temp):
    """sub (N, M, dsub), books (M, CB, dsub) -> soft codes (N, M, CB)."""
    return torch.softmax(-_sub_dists(sub, books) / temp, dim=-1)


def _st_reconstruct(sub, books, temp):
    """Straight-through reconstruction: hard argmin forward, soft
    gradients backward."""
    soft = _soft_assign(sub, books, temp)                 # (N, M, CB)
    hard = torch.zeros_like(soft).scatter_(-1, soft.argmax(-1, keepdim=True),
                                           1.0)
    assign = hard + soft - soft.detach()                  # ST trick
    ieee_f32_matmul()
    return torch.einsum("nmc,mcd->nmd", assign, books)


def _loss(books, sub, temp):
    recon = _st_reconstruct(sub, books, temp)
    return ((sub - recon) ** 2).sum(dim=(1, 2)).mean()


def _train(books0: torch.Tensor, sub: torch.Tensor, temp: torch.Tensor,
           lr: torch.Tensor, steps: int):
    """``steps`` Adam steps on the reconstruction loss from ``books0``
    -> (books, losses (steps,)); the loss of step i is taken before its
    update, as the reference's scan records it."""
    books = books0.detach().clone()
    m = torch.zeros_like(books)
    v = torch.zeros_like(books)
    t = torch.ones((), dtype=torch.float32, device=books.device)
    losses = torch.empty(steps, dtype=torch.float32, device=books.device)
    for i in range(steps):
        books.requires_grad_(True)
        loss = _loss(books, sub, temp)
        (g,) = torch.autograd.grad(loss, books)
        with torch.no_grad():
            losses[i] = loss
            books = books.detach()
            m = 0.9 * m + 0.1 * g
            v = 0.99 * v + 0.01 * g * g
            mh = m / (1 - 0.9 ** t)
            vh = v / (1 - 0.99 ** t)
            books = books - lr * mh / (torch.sqrt(vh) + 1e-8)
            t = t + 1
    return books, losses


def train_dpq(generator: torch.Generator, residuals: torch.Tensor, m: int,
              cb: int, *, steps: int = 300, lr: float = 0.5,
              temp: Optional[float] = None, kmeans_warmstart: bool = True
              ) -> tuple[PQCodebook, torch.Tensor]:
    """Learn DPQ codebooks on (N, D) residuals -> (PQCodebook, loss curve
    (steps,)), on the residuals' device.

    k-means warm start (``train_pq(iters=4)``, the usual recipe) or, cold,
    ``cb`` rows drawn with ``generator`` (a CPU generator, as for
    ``train_pq``); then straight-through Adam.  ``temp=None`` sets the
    softmax temperature to the mean squared subvector distance over the
    first 512 rows: at temp ~ distance scale the relaxation spreads
    gradient mass beyond the nearest codeword (at temp << scale the
    softmax is one-hot and training stalls at the k-means solution).
    The (N, M, CB) soft and hard tensors are full-batch, so N bounds the
    memory: about 4 N M CB bytes each.
    """
    x = residuals.float()
    sub = split_subvectors(x, m)                          # (N, M, dsub)
    if kmeans_warmstart:
        books0 = train_pq(x, m=m, cb=cb, iters=4,
                          generator=generator).codebooks
    else:
        idx = _init_idx(x.shape[0], cb, generator).to(x.device)
        books0 = sub[idx].transpose(0, 1).contiguous()
    if temp is None:
        with torch.no_grad():
            temp_t = _sub_dists(sub[:512], books0).mean()
    else:
        temp_t = torch.tensor(temp, dtype=torch.float32, device=x.device)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=x.device)
    books, losses = _train(books0, sub, temp_t, lr_t, steps)
    return PQCodebook(books, (books * books).sum(-1)), losses
