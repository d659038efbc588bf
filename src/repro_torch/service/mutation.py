"""MutationCoordinator: replicate live-index mutations across the fleet.

The port of ``repro/service/mutation.py``.  The :class:`~repro_torch.core.
mutable_index.Index` handle owns the data; this coordinator owns
*consistency*: after every ``upsert`` / ``delete`` it pushes the handle's
fresh cluster tensors to every replica (built *and* parked: an autoscaler
grow must never resurrect a stale replica), and after a maintenance
generation it drives each engine's install plus the per-generation
invalidation sweep (LUT caches cleared, heat estimators reset in place,
router affinity voided).

Install paths per engine:

  * local   -- ``LocalEngine.install``: one atomic view swap.  Plain
    mutations swap only the padded cluster tensors (LUTs depend on
    (query, centroid, codebook), all unchanged, so the cache is kept);
    generation swaps also install the new generation's lean
    ``search_view`` and bump the engine's view generation, which salts
    LUT-cache keys so a batch in flight across the swap cannot poison the
    cache for the new generation.
  * sharded -- ``DistributedEngine.stage_index``: the new CSR index is
    materialized into a pending placement and installed at the next batch
    start; the engine clears its LUT cache and reseeds its heat estimator
    at the swap itself.

Maintenance runs the expensive part -- :meth:`Index.build_generation`
(split / merge / retrain / re-encode) -- on a daemon thread, which makes
the index's device current first (it launches device work, as a replica's
executor worker does); searches and further mutations proceed meanwhile,
and ``install_generation`` reconciles whatever landed after the snapshot.
A non-blocking lock makes maintenance single-flight; errors are stashed
and re-raised on the next mutation-API call rather than dying silently on
the thread.  ``faults`` (a :class:`~repro_torch.runtime.faults.
FaultInjector`, None by default) arms the ``maintenance.death`` site at
the top of the maintenance worker: a firing kills the cycle and surfaces
on the next API call, as a real error does.

One departure from the reference: ``install_generation`` and the
generation fan-out run under the service's ``_scale_lock`` together, as
the data fan-out does.  In the reference a data fan-out can land between
the two and install the new generation's clusters on engines still
routing with the old centroids.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.runtime.faults import InjectedFault


class MutationCoordinator:
    """Fleet-wide mutation fan-out for one :class:`AnnService`."""

    def __init__(self, service):
        self.svc = service
        self.index = service.index
        spec = service.spec
        band = tuple(spec.mutation_size_band)
        self.size_band = None if band == (0, 0) else band
        self.maintenance_interval = int(spec.mutation_maintenance_interval)
        self.index.compact_threshold = float(
            spec.mutation_compact_threshold)
        self._mutations_since_check = 0
        self._maint_busy = threading.Lock()   # single-flight maintenance
        self._maint_thread: Optional[threading.Thread] = None
        self._maint_error: Optional[BaseException] = None
        self._last_maintenance: Optional[dict] = None
        self.maintenance_runs = 0
        self.propagations = 0
        self.faults = None                    # FaultInjector | None

    # -- mutation fan-out --------------------------------------------------
    def upsert(self, ids, vectors, tenant=None, tags=None) -> dict:
        self._raise_pending_error()
        info = self.index.upsert(ids, vectors, tenant=tenant, tags=tags)
        self._after_mutation()
        return info

    def delete(self, ids) -> int:
        self._raise_pending_error()
        removed = self.index.delete(ids)
        self._after_mutation()
        return removed

    def _after_mutation(self) -> None:
        self._propagate_data()
        self._mutations_since_check += 1
        if (self.maintenance_interval
                and self._mutations_since_check
                >= self.maintenance_interval):
            self._mutations_since_check = 0
            self.run_maintenance(wait=False)

    def _propagate_data(self) -> None:
        """Install the handle's current cluster tensors on every replica
        (parked ones included, so an autoscale grow stays consistent).
        Centroids and codebooks did not move, so LUT-cache entries stay
        valid.  ``_scale_lock`` serializes against scale events building
        replicas from the same handle."""
        svc = self.svc
        with svc._scale_lock:
            if svc.spec.engine == "local":
                clusters = self.index.clusters
                for rep in svc.replicas:
                    rep.core.install(clusters=clusters)
            else:
                csr = self.index.to_ivfpq()
                for rep in svc.replicas:
                    rep.core.stage_index(csr)
            self.propagations += 1

    def _install_generation(self, gen) -> dict:
        """Install a built generation on the handle and fan it out to the
        fleet, invalidating every piece of per-generation state -- one
        step under ``_scale_lock``, so no data fan-out lands between."""
        from repro_torch.core.sharded_search import locate_probes
        svc = self.svc
        handle = self.index
        with svc._scale_lock:
            info = handle.install_generation(gen)
            if svc.spec.engine == "local":
                view = handle.search_view
                clusters = handle.clusters
                for rep in svc.replicas:
                    # install first (bumps the view generation that salts
                    # cache keys), then clear: entries a stale in-flight
                    # batch might still insert carry the old salt and can
                    # never be hit by the new generation
                    rep.core.install(index=view, clusters=clusters)
                    if rep.cache is not None:
                        rep.cache.clear()
            else:
                csr = handle.to_ivfpq()
                for rep in svc.replicas:
                    # the engine clears its cache and reseeds its
                    # estimator at the swap itself (next batch start)
                    rep.core.stage_index(csr)
            svc.router.invalidate_clusters(handle.nlist)
            if (svc.spec.engine == "sharded"
                    and svc._sample_queries is not None):
                # re-derive the scale-out heat seed against the new
                # centroids (cluster count / ids changed meaning)
                svc._sample_probes = locate_probes(
                    svc._sample_queries, handle.centroids, svc.spec.nprobe)
            self.propagations += 1
        return info

    # -- maintenance -------------------------------------------------------
    def run_maintenance(self, force: bool = False,
                        wait: bool = True) -> dict:
        """One maintenance cycle (see AnnService.run_maintenance).

        The generation build runs on a daemon thread; ``wait=True`` joins
        it (returning the install info), ``wait=False`` returns at once
        (``{"ran": True, "async": True}``) and the install + fleet fan-out
        happen in the background.  When a cycle is already in flight this
        call does not start another (``{"busy": True}``; with
        ``wait=True`` it joins the in-flight one first)."""
        self._raise_pending_error()
        plan = self.index.maintenance_plan(self.size_band)
        if not force and not plan["split"] and not plan["merge"]:
            return {"ran": False, "plan": plan}
        if not self._maint_busy.acquire(blocking=False):
            if wait:
                t = self._maint_thread
                if t is not None:
                    t.join()
                self._raise_pending_error()
                return {"ran": False, "busy": True,
                        **(self._last_maintenance or {})}
            return {"ran": False, "busy": True}
        run_seed = self.maintenance_runs       # deterministic per run
        device = self.index.device

        def work():
            try:
                if self.faults is not None \
                        and self.faults.fire("maintenance.death"):
                    raise InjectedFault("maintenance.death",
                                        "maintenance thread killed")
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                gen = self.index.build_generation(
                    band=self.size_band, seed=run_seed)
                self._last_maintenance = self._install_generation(gen)
                self.maintenance_runs += 1
            except Exception as e:             # surfaced on next API call
                self._maint_error = e
            finally:
                self._maint_busy.release()

        t = threading.Thread(target=work, name="ann-maintenance",
                             daemon=True)
        self._maint_thread = t
        t.start()
        if wait:
            t.join()
            self._maint_thread = None
            self._raise_pending_error()
            return {"ran": True, "plan": plan,
                    **(self._last_maintenance or {})}
        return {"ran": True, "plan": plan, "async": True}

    def close(self) -> None:
        """Join an in-flight maintenance thread (service shutdown).
        Errors are not raised here -- shutdown must complete -- but stay
        visible in ``stats()['error']``."""
        t = self._maint_thread
        if t is not None:
            t.join()
            self._maint_thread = None

    def _raise_pending_error(self) -> None:
        if self._maint_error is not None:
            err, self._maint_error = self._maint_error, None
            raise RuntimeError("background index maintenance failed"
                               ) from err

    # -- metrics -----------------------------------------------------------
    def stats(self) -> dict:
        out = self.index.stats.as_dict()
        out.update(generation=self.index.generation,
                   n_live=len(self.index),
                   nlist=self.index.nlist,
                   maintenance_runs=self.maintenance_runs,
                   propagations=self.propagations)
        if self._last_maintenance is not None:
            out["last_maintenance"] = dict(self._last_maintenance)
        if self._maint_error is not None:
            out["error"] = repr(self._maint_error)
        return out
