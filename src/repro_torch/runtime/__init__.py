"""Serving runtime: micro-batching, the LUT cache, the local and sharded
engines."""

from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request,
                                          TasksPerShardController)
from repro_torch.runtime.cache import (AdmissionPolicy, CacheStats,
                                       HeatAwareAdmission, HotClusterLUTCache,
                                       LRUCache, OnlineHeatEstimator,
                                       query_hash_bucket)
from repro_torch.runtime.serving import (BatchServeError, LocalEngine,
                                         SearchEngine, ServingConfig,
                                         ServingRuntime, ServingStats,
                                         ShardedEngine)

__all__ = ["BucketPolicy", "MicroBatch", "MicroBatcher", "Request",
           "TasksPerShardController",
           "AdmissionPolicy", "CacheStats", "HeatAwareAdmission",
           "HotClusterLUTCache", "LRUCache", "OnlineHeatEstimator",
           "query_hash_bucket",
           "BatchServeError", "LocalEngine", "SearchEngine", "ServingConfig",
           "ServingRuntime", "ServingStats", "ShardedEngine"]
