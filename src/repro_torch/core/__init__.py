"""IVF-PQ core: k-means, PQ/OPQ, index build, ADC, the search pipeline,
and the sharded engine (perf model, layout, scheduler, sharded search).
The design-space exploration and the SLO-driven auto-tuner live in
``core.dse`` and ``core.autotune``; the tuner's names are exported by
``repro_torch.service`` (a function ``autotune`` here would hide the
``core.autotune`` module)."""

from repro_torch.core.kmeans import (kmeans, kmeans_multi, l2_sq,
                                     assign_chunked)
from repro_torch.core.pq import (PQCodebook, OPQCodebook, train_pq,
                                 train_opq, encode_pq, decode_pq, code_dtype)
from repro_torch.core.ivf import (IVFPQIndex, PaddedClusters, build_ivfpq,
                                  pad_clusters, reconstruct)
from repro_torch.core.adc import (build_lut, build_lut_batch, scan_codes,
                                  adc_distances, QuantizedLUT, quantize_lut,
                                  dequantize_lut, scan_codes_quantized,
                                  adc_distances_quantized)
from repro_torch.core.topk import topk_smallest, merge_topk
from repro_torch.core.search import (SearchParams, search_ivfpq,
                                     exact_search, recall_at_k,
                                     cluster_locate, cluster_locate_masked)
from repro_torch.core.perf_model import (IndexParams, HardwareProfile,
                                         UPMEM_PROFILE, TaskLatencyModel,
                                         make_task_latency_model)
from repro_torch.core.layout import Layout, build_layout, estimate_heat
from repro_torch.core.scheduler import ShardSchedule, schedule_batch
from repro_torch.core.sharded_search import (DistributedEngine, EngineConfig,
                                             ShardedIndex, materialize_shards,
                                             merge_host)

__all__ = [
    "kmeans", "kmeans_multi", "l2_sq", "assign_chunked",
    "PQCodebook", "OPQCodebook", "train_pq", "train_opq", "encode_pq",
    "decode_pq", "code_dtype",
    "IVFPQIndex", "PaddedClusters", "build_ivfpq", "pad_clusters",
    "reconstruct",
    "build_lut", "build_lut_batch", "scan_codes", "adc_distances",
    "QuantizedLUT", "quantize_lut", "dequantize_lut",
    "scan_codes_quantized", "adc_distances_quantized",
    "topk_smallest", "merge_topk",
    "SearchParams", "search_ivfpq", "exact_search", "recall_at_k",
    "cluster_locate", "cluster_locate_masked",
    "IndexParams", "HardwareProfile", "UPMEM_PROFILE", "TaskLatencyModel",
    "make_task_latency_model",
    "Layout", "build_layout", "estimate_heat",
    "ShardSchedule", "schedule_batch",
    "DistributedEngine", "EngineConfig", "ShardedIndex",
    "materialize_shards", "merge_host",
]
