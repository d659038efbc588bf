"""repro_torch.service: the service-layer API over the port's engines.

One validated config (:class:`ServiceSpec`, also the durable deploy
artifact: ``to_dict``/``from_dict`` + ``save``/``load``, the same schema
as ``repro.service``), one facade (:class:`AnnService`) owning the whole
lifecycle (build -> warmup -> submit/search/stream -> stats -> shutdown),
an async request lifecycle (``submit_async`` -> :class:`SearchFuture`)
over executor-backed replicas (:class:`ReplicaExecutor`), a
multi-replica :class:`Router` with round-robin, least-queue and
cache-aware policies, and an :class:`Autoscaler` that moves the live
fleet inside ``[replicas, replicas_max]`` from queue-depth/p99 signals.

``python -m repro_torch.service --selftest`` runs an end-to-end smoke on
both stream clocks; ``--spec deploy.json`` boots a fleet from a file.
The live index (``mutable=True``) and tiered storage (``storage=
"tiered"``) are served; tenancy, fault injection and the auto-tuner are
not ported yet.
"""

from repro_torch.service.autoscale import Autoscaler, ScaleEvent, ScaleSignals
from repro_torch.service.executor import ReplicaExecutor, SearchFuture
from repro_torch.service.router import (CacheAwarePolicy, LeastQueuePolicy,
                                        RoundRobinPolicy, Router,
                                        RoutingPolicy, make_policy)
from repro_torch.service.service import AnnService, Replica, ServiceOverloaded
from repro_torch.service.spec import SPEC_VERSION, IndexSpec, ServiceSpec

__all__ = ["AnnService", "Autoscaler", "CacheAwarePolicy", "IndexSpec",
           "LeastQueuePolicy", "Replica", "ReplicaExecutor",
           "RoundRobinPolicy", "Router", "RoutingPolicy", "SPEC_VERSION",
           "ScaleEvent", "ScaleSignals", "SearchFuture", "ServiceOverloaded",
           "ServiceSpec", "make_policy"]
