"""Serving runtime: micro-batching and the local engine."""

from repro_torch.runtime.batching import (BucketPolicy, MicroBatch,
                                          MicroBatcher, Request)
from repro_torch.runtime.serving import (BatchServeError, LocalEngine,
                                         SearchEngine, ServingConfig,
                                         ServingRuntime, ServingStats)

__all__ = ["BucketPolicy", "MicroBatch", "MicroBatcher", "Request",
           "BatchServeError", "LocalEngine", "SearchEngine", "ServingConfig",
           "ServingRuntime", "ServingStats"]
