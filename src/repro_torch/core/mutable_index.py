"""The unified ``Index`` handle: the front door the service builds on.

The port of ``repro/core/mutable_index.py``'s static handle.  ``Index``
owns what the engines used to pass around as loose tuples (the CSR
``IVFPQIndex``, the padded ``PaddedClusters``, centroids / codebook /
rotation).  ``IndexSpec.build(points)`` and ``Index.build(generator,
points, ...)`` construct it; ``.ivf`` / ``.clusters`` expose the
engine-ready tensors; ``.search`` runs the five-phase pipeline directly.
Wrapping a prebuilt ``IVFPQIndex`` is free and identity-preserving
(``.ivf`` is the same object), so a one-replica local service searches
exactly what ``search_ivfpq`` searches.

Not ported yet: the mutable handle (``mutable=True``: upserts, deletes,
generation maintenance, the ``_Store``; ROADMAP item 6) and tiered
storage (``storage="tiered"``; ROADMAP item 7).  Both raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.ivf import (IVFPQIndex, PaddedClusters, build_ivfpq,
                                  pad_clusters)
from repro_torch.core.pq import PQCodebook


def _check_ported(mutable: bool, storage: str) -> None:
    if storage not in ("resident", "tiered"):
        raise ValueError(f"storage must be 'resident' or 'tiered', "
                         f"got {storage!r}")
    if mutable:
        raise NotImplementedError("a mutable Index (upsert / delete / "
                                  "generation maintenance) is not ported "
                                  "to repro_torch yet (ROADMAP item 6)")
    if storage == "tiered":
        raise NotImplementedError("storage='tiered' is not ported to "
                                  "repro_torch yet (ROADMAP item 7)")


class Index:
    """The one index handle: a zero-copy wrapper over a prebuilt
    :class:`IVFPQIndex` on its device.  ``.clusters`` is ``pad_clusters``
    of it, computed once and cached."""

    mutable = False
    storage = "resident"
    tiered_store = None
    # per-vector tenant / tag metadata (tenancy, ROADMAP item 8)
    meta = None

    def __init__(self, ivf: IVFPQIndex, *, mutable: bool = False,
                 storage: str = "resident"):
        _check_ported(mutable, storage)
        self._ivf = ivf
        self._clusters_cache: Optional[PaddedClusters] = None

    @classmethod
    def build(cls, generator: torch.Generator, points, *, nlist: int, m: int,
              cb: int = 256, kmeans_iters: int = 12, pq_iters: int = 12,
              opq: bool = False, train_sample: Optional[int] = None,
              mutable: bool = False, storage: str = "resident",
              device="cuda") -> "Index":
        """Build from raw (N, D) points (``core.ivf.build_ivfpq`` on
        ``device``, draws from ``generator``) and wrap in a handle."""
        _check_ported(mutable, storage)
        if isinstance(points, torch.Tensor):
            pts = points
        else:
            host = np.asarray(points)
            pts = torch.from_numpy(host if host.flags.writeable
                                   else host.copy())
        ivf = build_ivfpq(generator, pts, nlist=nlist, m=m, cb=cb,
                          kmeans_iters=kmeans_iters, pq_iters=pq_iters,
                          opq=opq, train_sample=train_sample, device=device)
        return cls(ivf)

    # -- read surface ------------------------------------------------------
    @property
    def ivf(self) -> IVFPQIndex:
        """The wrapped CSR index itself (identity-preserving)."""
        return self._ivf

    @property
    def clusters(self) -> PaddedClusters:
        """Engine-ready padded layout (padded once, then cached)."""
        if self._clusters_cache is None:
            self._clusters_cache = pad_clusters(self._ivf)
        return self._clusters_cache

    @property
    def search_view(self) -> IVFPQIndex:
        """The index the engines route with (static: the wrapped one)."""
        return self._ivf

    @property
    def device(self) -> torch.device:
        return self._ivf.centroids.device

    @property
    def centroids(self) -> torch.Tensor:
        return self._ivf.centroids

    @property
    def codebook(self) -> PQCodebook:
        return self._ivf.codebook

    @property
    def rotation(self) -> Optional[torch.Tensor]:
        return self._ivf.rotation

    @property
    def nlist(self) -> int:
        return self._ivf.nlist

    @property
    def dim(self) -> int:
        return self._ivf.dim

    @property
    def sizes(self) -> np.ndarray:
        """Per-cluster sizes on the host."""
        return self._ivf.sizes.cpu().numpy()

    def __len__(self) -> int:
        return int(self._ivf.ids.shape[0])

    def to_ivfpq(self) -> IVFPQIndex:
        """The CSR index the sharded engine materializes its shards from."""
        return self._ivf

    def search(self, queries, params=None, *, nprobe: int = 8, k: int = 10):
        """Front-door search: the five-phase pipeline over the handle.
        Returns ((Q, k) dists, (Q, k) ids) numpy."""
        from repro_torch.core.search import SearchParams, search_ivfpq
        if params is None:
            params = SearchParams(nprobe=nprobe, k=k, use_kernels=True)
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        d, i = search_ivfpq(self._ivf, self.clusters, q, params)
        return d.cpu().numpy(), i.cpu().numpy()
