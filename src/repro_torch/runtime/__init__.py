"""Serving runtime: micro-batching, the LUT cache, the local and sharded
engines, PIM pacing, per-replica health and fault injection; and the
training control plane (heartbeats, elastic mesh plans, stragglers, the
restart supervisor)."""

from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request,
                                          TasksPerShardController)
from repro_torch.runtime.cache import (AdmissionPolicy, CacheStats,
                                       HeatAwareAdmission, HotClusterLUTCache,
                                       LRUCache, OnlineHeatEstimator,
                                       entry_nbytes, query_hash_bucket,
                                       stack_lut_bank)
from repro_torch.runtime.fault_tolerance import (ElasticPlan,
                                                 HeartbeatRegistry,
                                                 HostState, ReplicaHealth,
                                                 RunSupervisor,
                                                 StragglerPolicy,
                                                 plan_elastic_mesh)
from repro_torch.runtime.faults import (SITES, FaultInjector, FaultPlan,
                                        FaultRule, InjectedFault)
from repro_torch.runtime.serving import (BatchServeError, LocalEngine,
                                         PimPacedEngine, SearchEngine,
                                         ServingConfig, ServingRuntime,
                                         ServingStats, ShardedEngine,
                                         service_construction)

__all__ = ["BucketPolicy", "MicroBatch", "MicroBatcher", "Request",
           "TasksPerShardController",
           "AdmissionPolicy", "CacheStats", "HeatAwareAdmission",
           "HotClusterLUTCache", "LRUCache", "OnlineHeatEstimator",
           "entry_nbytes", "query_hash_bucket", "stack_lut_bank",
           "HeartbeatRegistry", "HostState", "ElasticPlan",
           "plan_elastic_mesh", "ReplicaHealth", "StragglerPolicy",
           "RunSupervisor",
           "SITES", "FaultPlan", "FaultRule", "FaultInjector",
           "InjectedFault",
           "BatchServeError", "LocalEngine", "PimPacedEngine", "SearchEngine",
           "ServingConfig", "ServingRuntime", "ServingStats", "ShardedEngine",
           "service_construction"]
