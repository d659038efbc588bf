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
The live index (``mutable=True``), tiered storage (``storage=
"tiered"``) and multi-tenant serving are served: per-tenant namespaces
and predicate filters (:mod:`repro_torch.core.filter`) under per-tenant
QoS (:class:`TenantRegistry` token buckets and :class:`WFQScheduler`
weighted fair queueing; an over-quota submit raises
:class:`TenantThrottled`); ``--selftest-tenants`` runs the multi-tenant
smoke.  ``--selftest-chaos`` runs the fault-injection chaos smoke
(:mod:`repro_torch.service.chaos`); ``--autotune`` searches
configurations against the perf model (:func:`~repro_torch.core.
autotune.autotune`) and emits a spec meeting a declared
:class:`~repro_torch.core.autotune.SLO`.
"""

from repro_torch.core.autotune import (SLO, AutotuneResult, SLOInfeasible,
                                       TuneSpace, autotune, autotune_service)
from repro_torch.service.autoscale import Autoscaler, ScaleEvent, ScaleSignals
from repro_torch.service.executor import ReplicaExecutor, SearchFuture
from repro_torch.service.router import (CacheAwarePolicy, LeastQueuePolicy,
                                        RoundRobinPolicy, Router,
                                        RoutingPolicy, make_policy)
from repro_torch.service.service import (AnnService, Replica,
                                         ServiceOverloaded, TenantThrottled)
from repro_torch.service.spec import SPEC_VERSION, IndexSpec, ServiceSpec
from repro_torch.service.tenancy import (TenantRegistry, TokenBucket,
                                         WFQScheduler)

__all__ = ["AnnService", "Autoscaler", "CacheAwarePolicy", "IndexSpec",
           "LeastQueuePolicy", "Replica", "ReplicaExecutor",
           "RoundRobinPolicy", "Router", "RoutingPolicy", "SPEC_VERSION",
           "ScaleEvent", "ScaleSignals", "SearchFuture", "ServiceOverloaded",
           "ServiceSpec", "TenantRegistry", "TenantThrottled", "TokenBucket",
           "WFQScheduler", "make_policy",
           "SLO", "TuneSpace", "AutotuneResult", "SLOInfeasible",
           "autotune", "autotune_service"]
