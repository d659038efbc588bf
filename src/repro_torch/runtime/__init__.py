"""Serving runtime: micro-batching, the LUT cache, the local and sharded
engines, PIM pacing, per-replica health and fault injection."""

from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request,
                                          TasksPerShardController)
from repro_torch.runtime.cache import (AdmissionPolicy, CacheStats,
                                       HeatAwareAdmission, HotClusterLUTCache,
                                       LRUCache, OnlineHeatEstimator,
                                       entry_nbytes, query_hash_bucket,
                                       stack_lut_bank)
from repro_torch.runtime.fault_tolerance import ReplicaHealth
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
           "ReplicaHealth",
           "SITES", "FaultPlan", "FaultRule", "FaultInjector",
           "InjectedFault",
           "BatchServeError", "LocalEngine", "PimPacedEngine", "SearchEngine",
           "ServingConfig", "ServingRuntime", "ServingStats", "ShardedEngine",
           "service_construction"]
