"""Per-vector metadata: tenant namespaces + predicate filtering.

The port of ``repro/core/filter.py``.  Multi-tenant serving shares one
physical index (codebooks, centroids, clusters) across many logical
corpora.  Isolation is not a separate data structure: it is the masking
discipline the padding invariant already uses.  The scan masks rows past
``sizes`` to ``+inf`` before top-k, and a scoped scan masks rows outside
the query's scope the same way, so filtered top-k is exact over the
matching rows, never truncated after the fact.

Metadata is keyed by vector id.  :class:`VectorMeta` holds flat host
tables indexed by id:

  tenant_of  (N,) i32     owning tenant (-1 = unscoped / no tenant)
  tags       (N, F) u32   predicate tags (NO_TAG = empty slot)
  cluster_of (N,) i32     coarse cluster holding the vector (-1 unknown)

Every scan path already carries vector ids (``PaddedClusters.ids``, the
sharded tasks' ids, the tier's fetched ids), so the scope mask is a
gather, ``meta_tenant[ids]``, and no side arrays ride through mutation,
spill files or shard materialization.  Deleted ids leave stale rows
behind, which is harmless: a dead id appears in no scan.

Scope rides per query as plain data:

  q_tenant (Q,) i32      -1 = unscoped (matches every tenant)
  q_terms  (Q, W) u32    NO_TAG-padded term list; all-NO_TAG = no
                         predicate; else a row matches iff ANY of its
                         tags equals ANY valid term (OR semantics)

On the card torch's ``uint32`` has only basic support, so the device
tables hold tags, and the scans take terms, as their ``int32`` bit views
(``NO_TAG`` is -1 there).  Equality of the bits is all the mask asks.

:func:`scope_mask` combines liveness (id >= 0), tenant equality and the
term match into one (R, C) bool without building the reference's
(R, C, F, W) comparison: it ORs one (R, C) comparison per (tag field,
term) pair.  :func:`mask_scoped_distances` applies it as ``+inf``, and
the callers' ``isfinite`` epilogue turns those rows' ids into -1, so a
tenant with fewer than k matching rows gets an (inf, -1) tail exactly as
padding does.

The per-tenant cluster bitmap (:meth:`VectorMeta.bitmap`) marks which
clusters hold rows of each tenant; scoped CL (``core.search.
cluster_locate_masked``) ranks only those, which is what makes a
tenant-scoped result equal a dedicated single-tenant index over the same
rows (:func:`tenant_subindex` builds that view).  After deletes the
bitmap may be a superset (a wasted probe whose rows are masked anyway);
after a maintenance generation :meth:`VectorMeta.rebuild_clusters`
restores it from the new layout.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NO_TAG = 0xFFFFFFFF     # reserved u32: empty tag slot / term pad
NO_TENANT = -1          # unscoped row / unscoped query
NO_TAG_BITS = -1        # NO_TAG's int32 bit view (the device form)


def terms_bits(terms) -> np.ndarray:
    """(Q, W) u32 terms -> their int32 bit views (the device form)."""
    return np.ascontiguousarray(np.asarray(terms, np.uint32)).view(np.int32)


class VectorMeta:
    """Id-keyed per-vector metadata tables (host numpy, device-cached).

    Writers (the build's wiring, upserts) hold the lock; readers take
    version-consistent snapshots.  The device tables and the tenant
    bitmap are cached per version: a mutation bumps ``version`` and the
    next scoped batch uploads again.
    """

    def __init__(self, capacity: int = 0, tag_fields: int = 4):
        if tag_fields < 0:
            raise ValueError(f"tag_fields must be >= 0, got {tag_fields}")
        self.tag_fields = int(tag_fields)
        self._lock = threading.Lock()
        self.version = 0
        self.tenant_of = np.full(capacity, NO_TENANT, np.int32)
        self.tags = np.full((capacity, self.tag_fields), NO_TAG, np.uint32)
        self.cluster_of = np.full(capacity, -1, np.int32)
        # device -> (version, tenant_of, tags, fields holding any tag)
        self._device_cache: dict = {}
        self._bitmap_cache: Optional[tuple] = None   # (version, nlist, bm)
        self._bitmap_dev: dict = {}          # device -> (version, nlist, bm)

    # -- writers -----------------------------------------------------------
    def _grow(self, n: int) -> None:
        cur = self.tenant_of.shape[0]
        if n <= cur:
            return
        cap = max(n, 2 * cur, 64)
        t = np.full(cap, NO_TENANT, np.int32)
        g = np.full((cap, self.tag_fields), NO_TAG, np.uint32)
        c = np.full(cap, -1, np.int32)
        t[:cur], g[:cur], c[:cur] = self.tenant_of, self.tags, self.cluster_of
        self.tenant_of, self.tags, self.cluster_of = t, g, c

    def set(self, ids, *, tenant=None, tags=None, cluster=None) -> None:
        """Assign metadata for ``ids`` (array-like of vector ids).

        ``tenant`` is a scalar or (n,) array; ``tags`` is (n, <=F) u32
        (shorter rows are NO_TAG-padded); ``cluster`` is a scalar or (n,)
        array of coarse cluster ids.  Omitted fields keep their values.
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        if (ids < 0).any():
            raise ValueError("vector ids must be non-negative")
        with self._lock:
            self._grow(int(ids.max()) + 1)
            if tenant is not None:
                self.tenant_of[ids] = np.broadcast_to(
                    np.asarray(tenant, np.int32), ids.shape)
            if tags is not None:
                t = np.asarray(tags, np.uint32)
                if t.ndim == 1:
                    t = np.broadcast_to(t[None, :], (ids.size, t.shape[0]))
                if t.shape[1] > self.tag_fields:
                    raise ValueError(
                        f"tags have {t.shape[1]} fields; meta holds "
                        f"{self.tag_fields} (tag_fields at construction)")
                full = np.full((ids.size, self.tag_fields), NO_TAG,
                               np.uint32)
                full[:, :t.shape[1]] = t
                self.tags[ids] = full
            if cluster is not None:
                self.cluster_of[ids] = np.broadcast_to(
                    np.asarray(cluster, np.int32), ids.shape)
            self.version += 1

    def rebuild_clusters(self, ids_2d: np.ndarray,
                         sizes: np.ndarray) -> None:
        """Refresh ``cluster_of`` from a padded (nlist, cap) id layout,
        after a maintenance generation re-clustered the store (the old
        assignments then mean nothing).  One pass over the live rows."""
        ids_2d = np.asarray(ids_2d)
        sizes = np.asarray(sizes)
        cl, row = np.nonzero(np.arange(ids_2d.shape[1])[None, :]
                             < sizes[:, None])
        rid = ids_2d[cl, row]
        keep = rid >= 0
        cl, rid = cl[keep], rid[keep]
        top = int(ids_2d.max(initial=-1))
        with self._lock:
            if top >= 0:
                self._grow(top + 1)
            self.cluster_of[:] = -1
            self.cluster_of[rid] = cl
            self.version += 1

    # -- readers -----------------------------------------------------------
    @property
    def n_tenants(self) -> int:
        """1 + max assigned tenant id (0 when nothing is scoped)."""
        with self._lock:
            m = int(self.tenant_of.max()) if self.tenant_of.size else -1
        return max(m + 1, 0)

    @property
    def nbytes(self) -> int:
        """Host bytes of the three tables."""
        return (self.tenant_of.nbytes + self.tags.nbytes
                + self.cluster_of.nbytes)

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tenant_of (N,) i32, tags (N, F) i32 bit views) on ``device``,
        cached per version and device."""
        return self.scope_tables(device)[:2]

    def scope_tables(self, device):
        """:meth:`device_tables` plus the tag fields that hold any tag in
        the same snapshot (a field that is NO_TAG everywhere can match no
        term, so the mask skips it)."""
        dev = torch.device(device)
        with self._lock:
            version = self.version
            cached = self._device_cache.get(dev)
            if cached is not None and cached[0] == version:
                return cached[1:]
            t = self.tenant_of.copy()
            g = self.tags.copy()
        fields = tuple(j for j in range(g.shape[1])
                       if (g[:, j] != NO_TAG).any())
        jt = torch.from_numpy(t).to(dev)
        jg = torch.from_numpy(g.view(np.int32)).to(dev)
        with self._lock:
            cur = self._device_cache.get(dev)
            if cur is None or cur[0] < version:
                self._device_cache[dev] = (version, jt, jg, fields)
        return jt, jg, fields

    def bitmap(self, nlist: int) -> np.ndarray:
        """(n_tenants, nlist) bool: cluster c may hold rows of tenant t.

        Derived from (tenant_of, cluster_of) alone; exact after builds
        and upserts, a superset after deletes (see the module docstring).
        """
        with self._lock:
            version = self.version
            cached = self._bitmap_cache
            if (cached is not None and cached[0] == version
                    and cached[1] == nlist):
                return cached[2]
            tenant = self.tenant_of.copy()
            cluster = self.cluster_of.copy()
        n_t = max(int(tenant.max()) + 1, 0) if tenant.size else 0
        bm = np.zeros((n_t, nlist), bool)
        ok = (tenant >= 0) & (cluster >= 0) & (cluster < nlist)
        if ok.any():
            bm[tenant[ok], cluster[ok]] = True
        with self._lock:
            self._bitmap_cache = (version, nlist, bm)
        return bm

    def allowed_for(self, tenants, nlist: int) -> np.ndarray:
        """(Q, nlist) bool CL mask for a batch of query tenants.

        Tenant -1 (unscoped) allows every cluster; a tenant id with no
        rows allows none (its scan yields the inf/-1 tail).
        """
        tenants = np.asarray(tenants, np.int64).reshape(-1)
        bm = self.bitmap(nlist)
        out = np.ones((tenants.size, nlist), bool)
        scoped = tenants >= 0
        if scoped.any():
            t = tenants[scoped]
            known = t < bm.shape[0]
            rows = np.zeros((t.size, nlist), bool)
            if known.any():
                rows[known] = bm[t[known]]
            out[scoped] = rows
        return out

    def allowed_on(self, tenants, nlist: int, device) -> torch.Tensor:
        """:meth:`allowed_for` built on ``device``: the bitmap goes up
        once per version (two extra rows, all-False for tenants without
        rows and all-True for unscoped queries) and each batch gathers
        its rows there, so no (Q, nlist) host array crosses per batch."""
        dev = torch.device(device)
        with self._lock:
            cached = self._bitmap_dev.get(dev)
            version = self.version
        if cached is None or cached[0] != version or cached[1] != nlist:
            bm = self.bitmap(nlist)
            ext = np.concatenate([bm, np.zeros((1, nlist), bool),
                                  np.ones((1, nlist), bool)])
            cached = (version, nlist, torch.from_numpy(ext).to(dev))
            with self._lock:
                self._bitmap_dev[dev] = cached
        ext = cached[2]
        n_t = ext.shape[0] - 2
        t = np.asarray(tenants, np.int64).reshape(-1)
        row = np.where(t < 0, n_t + 1, np.where(t >= n_t, n_t, t))
        return ext.index_select(0, torch.from_numpy(row).to(dev))

    def match_host(self, ids, tenant: int = NO_TENANT,
                   terms: Sequence[int] = ()) -> np.ndarray:
        """Host-side reference mask over raw vector ids (tests, brute
        force): the semantics of :func:`scope_mask`."""
        ids = np.asarray(ids, np.int64)
        terms = [int(x) for x in terms if int(x) != NO_TAG]
        with self._lock:
            t = self.tenant_of.copy()
            g = self.tags.copy() if terms else None
        live = (ids >= 0) & (ids < t.shape[0])
        rid = np.clip(ids, 0, max(t.shape[0] - 1, 0))
        rt = np.where(live, t[rid], NO_TENANT)
        ok = live & ((tenant < 0) | (rt == tenant))
        if terms:
            tg = g[rid]                                    # (..., F)
            m = np.zeros(ids.shape, bool)
            for term in terms:
                m |= (tg == np.uint32(term)).any(axis=-1)
            ok &= live & m
        return ok


# ---------------------------------------------------------------------------
# The device-side mask, shared by every scoped scan.
# ---------------------------------------------------------------------------

def scope_mask(row_ids: torch.Tensor, meta_tenant: torch.Tensor,
               meta_tags: torch.Tensor, q_tenant: torch.Tensor,
               q_terms: torch.Tensor,
               fields: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(R, C) bool: which candidate rows are in scope.

    row_ids (R, C) i32 (-1 = padding); meta_tenant (N,) i32; meta_tags
    (N, F) i32 bit views; q_tenant (R,) i32 (-1 = unscoped); q_terms
    (R, W) i32 bit views (NO_TAG_BITS pad; all-pad = no predicate).  Ids
    >= N (mutated after the tables were taken) are unscoped rows with no
    tags: visible only to unscoped, predicate-free queries.  ``fields``
    (default all): the tag fields to compare, which may leave out fields
    that hold no tag at all.

    The term match ORs one (R, C) comparison per (tag field, term) pair,
    the same boolean as the reference's (R, C, F, W) grid.  A valid term
    never equals NO_TAG, so a row beyond the tables (tags NO_TAG in the
    reference) never matches one."""
    n = meta_tenant.shape[0]
    live = row_ids >= 0
    oob = row_ids >= n
    rid = row_ids.clamp(0, max(n - 1, 0)).long()
    if n:
        rt = meta_tenant[rid].masked_fill(oob, NO_TENANT)      # (R, C)
    else:
        rt = torch.full_like(row_ids, NO_TENANT)
    qt = q_tenant.to(rt.dtype)[:, None]
    ok = live & ((qt < 0) | (rt == qt))
    term_valid = q_terms != NO_TAG_BITS                        # (R, W)
    has_pred = term_valid.any(dim=-1)                          # (R,)
    if fields is None:
        fields = range(meta_tags.shape[1])
    w = q_terms.shape[1]
    match = torch.zeros_like(live)
    if n and w and len(fields):
        for j in fields:
            tg = meta_tags[:, j][rid]                          # (R, C)
            for v in range(w):
                match |= (tg == q_terms[:, v:v + 1]) & term_valid[:, v:v + 1]
        match &= ~oob
    return ok & (match | ~has_pred[:, None])


def mask_scoped_distances(d: torch.Tensor, row_ids: torch.Tensor,
                          meta_tenant: torch.Tensor, meta_tags: torch.Tensor,
                          q_tenant: torch.Tensor, q_terms: torch.Tensor,
                          fields: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
    """Apply the scope mask the way the padding invariant does: rows out
    of scope get ``+inf`` (and id -1 in the callers' isfinite epilogue),
    so they can never displace a matching row from top-k."""
    ok = scope_mask(row_ids, meta_tenant, meta_tags, q_tenant, q_terms,
                    fields)
    return d.masked_fill(~ok, float("inf"))


class Scope:
    """One batch's scope on the device: the meta tables (taken once per
    batch) and the per-query tenants and terms.

    ``tables`` is ``(meta_tenant, meta_tags)`` from
    :meth:`VectorMeta.scope_tables`, ``fields`` the tag fields holding any
    tag; ``tenants`` (Q,) i32 and ``terms`` (Q, W) u32 stay on the host;
    :meth:`rows` uploads the rows a scan needs (a query chunk, or one
    query per task)."""

    def __init__(self, meta: VectorMeta, tenants, terms, device):
        self.meta = meta
        self.device = torch.device(device)
        mt, mg, self.fields = meta.scope_tables(self.device)
        self.tables = (mt, mg)
        self.tenants = np.asarray(tenants, np.int32).reshape(-1)
        self.terms = np.asarray(terms, np.uint32)
        if self.terms.ndim != 2 or len(self.terms) != len(self.tenants):
            raise ValueError(f"terms {self.terms.shape} do not match "
                             f"{len(self.tenants)} tenants")

    @classmethod
    def make(cls, meta: Optional[VectorMeta], tenants, terms, n: int,
             device) -> Optional["Scope"]:
        """None when the batch carries no scope at all (unscoped traffic
        stays on the unscoped paths); raises without ``meta``.  A missing
        half defaults to unscoped (-1) or no predicate (all-NO_TAG)."""
        if tenants is None and terms is None:
            return None
        if meta is None:
            raise ValueError(
                "tenant/filtered search needs an engine built with "
                "per-vector metadata (ServiceSpec tenants / tagged "
                "upserts); this engine has meta=None")
        if tenants is None:
            tenants = np.full(n, NO_TENANT, np.int32)
        if terms is None:
            terms = np.full((len(tenants), meta.tag_fields), NO_TAG,
                            np.uint32)
        return cls(meta, tenants, terms, device)

    def allowed(self, rows, nlist: int) -> torch.Tensor:
        """(len(rows), nlist) CL mask of the given query rows."""
        return self.meta.allowed_on(self.tenants[rows], nlist, self.device)

    def rows(self, rows) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q_tenant, q_terms) of the given query rows on the device;
        ``rows`` is a slice or an index array (one query per task).  Term
        columns that are NO_TAG on every one of these rows are dropped
        (they match nothing and state no predicate)."""
        t = np.ascontiguousarray(self.tenants[rows])
        g = self.terms[rows]
        g = terms_bits(g[:, (g != NO_TAG).any(axis=0)])
        return (torch.from_numpy(t).to(self.device),
                torch.from_numpy(g).to(self.device))

    def masker(self, rows):
        """The ``mask`` function ``core.search.dc_ts_tasks`` takes, for
        (R, C) candidates whose R rows are the queries ``rows``:
        :func:`mask_scoped_distances` with those rows' scope."""
        qt, qg = self.rows(rows)
        return lambda d, row_ids: mask_scoped_distances(
            d, row_ids, *self.tables, qt, qg, self.fields)


def pad_terms(terms_rows: Sequence[Sequence[int]], width: int) -> np.ndarray:
    """Pack per-query term lists into the (Q, W) NO_TAG-padded u32 array
    the scoped scans take.  Raises if any list exceeds ``width``."""
    out = np.full((len(terms_rows), width), NO_TAG, np.uint32)
    for i, row in enumerate(terms_rows):
        row = list(row)
        if len(row) > width:
            raise ValueError(f"query {i} carries {len(row)} terms; "
                             f"filter_width is {width}")
        for j, term in enumerate(row):
            out[i, j] = np.uint32(term)
    return out


# ---------------------------------------------------------------------------
# Dedicated single-tenant view (isolation checks / migration).
# ---------------------------------------------------------------------------

def tenant_subindex(index, meta: VectorMeta, tenant: int):
    """Build a dedicated single-tenant :class:`IVFPQIndex` from the shared
    one.

    Keeps only the clusters holding the tenant's rows (centroid subset,
    relative cluster order kept) and only that tenant's rows inside them
    (relative row order kept), with the same codebook and rotation and
    the original global ids.  CL over the surviving centroids and the
    residual encoding then equal the shared index's bitmap-masked scoped
    path, which is what the isolation invariant asserts.  One snapshot of
    the tables matches every id at once; the CSR order (rows sorted by
    cluster) makes the ascending selection the per-cluster one.  Returns
    ``(sub_index, member_clusters)``; the sub-index lives on the index's
    device."""
    from repro_torch.core.ivf import IVFPQIndex
    ids_np = index.ids.cpu().numpy()
    offsets = index.offsets.cpu().numpy().astype(np.int64)
    sel = meta.match_host(ids_np, tenant=tenant)
    rows = np.nonzero(sel)[0]
    if rows.size == 0:
        raise ValueError(f"tenant {tenant} has no rows")
    cl = np.repeat(np.arange(index.nlist), np.diff(offsets))[rows]
    member, counts = np.unique(cl, return_counts=True)
    new_offsets = np.zeros(len(member) + 1, np.int64)
    new_offsets[1:] = np.cumsum(counts)
    dev = index.centroids.device
    rows_t = torch.from_numpy(rows).to(dev)
    sub = IVFPQIndex(
        index.centroids.index_select(0, torch.from_numpy(member).to(dev)),
        index.codebook,
        index.codes.index_select(0, rows_t),
        index.ids.index_select(0, rows_t),
        torch.from_numpy(new_offsets).to(dev, index.offsets.dtype),
        index.rotation)
    return sub, member
