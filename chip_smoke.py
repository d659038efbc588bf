#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (logging each kernel instance's registers and spills; an LC
instance that spills fails the run), holds each kernel against its plain
PyTorch version (ragged shapes first, LC at every instance of its
launcher, then each path's own inputs), and drives the port's two main
paths once at the configuration below:

    local:   corpus (make_clustered_corpus) -> build_ivfpq + pad_clusters
             on the card -> search_ivfpq(use_kernels=True), f32 and uint8
             LUTs -> LocalEngine behind ServingRuntime answering a
             Poisson query stream, on the virtual clock (run_stream) and
             on the wall clock (one caller thread submitting and
             stepping);
    sharded: the same index -> DistributedEngine (64 shards, clusters
             split at 1,024 rows, the hottest duplicated within 10% of
             the index's bytes, heat from CL of the 10,000 queries) ->
             the 10,000 queries in 10 batches of 1,000, f32 and uint8
             (RC, LC and the fused DC+TS kernel once a step over 65,536
             tasks, the kernel reading each task's codes by slot) ->
             ShardedEngine behind ServingRuntime, first on the
             local run's Poisson trace, then with the LUT cache and the
             online heat estimator on a Zipf trace;
    mesh:    the same index -> DistributedEngine(mesh=make_shard_mesh(64,
             devices=[cuda:0] * 64)): one program per shard, each on its
             own CUDA stream of the one card (64 concurrent programs), at
             f32 and uint8 beside the sharded path's flat engines (same
             config, same sample probes, so the same layout; the mesh
             entries' shards are views of the engine's): 2 batches of
             1,000 with the LUT cache off, the first batch twice and the
             second with a fresh cache on each engine, then a batch at
             256 tasks a shard (flush rounds); every result == the flat
             engine's bit for bit, LC (cache off) and E/F launched once
             per entry and step, each on its entry's stream, in entry
             order; A, B, E and F held to plain at one entry's shape
             (T = 1,024; E/F by slot over one shard's slots) and timed;
             one step, mesh and flat, by CUDA events with its busy share;
    service: the same index behind repro_torch.service.AnnService:
             S1 one local replica (search == search_ivfpq bit for bit),
             S5 one local replica, no cache, on the local path's Poisson
             trace (both clocks; the direct serving runs' twin, so the
             front door's own cost reads beside them), S2 two local
             replicas behind the cache-aware router with the LUT cache on
             the Zipf trace (virtual and wall clock; S2-off the same
             with no cache), S3 the same at uint8, S4 two sharded
             replicas behind the least-queue router on the Poisson trace
             (wall clock, f32 and uint8); then the service selftest on
             the card, both clocks (its 4th phase is the live index);
    mutation: a live Index(mutable=True) over the same index and points:
             M1 32 rounds of upsert 1,024 new ids / re-upsert 256 /
             delete 1,024 installed on a LocalEngine at f32 and uint8
             (each round == search_ivfpq over the snapshot bit for bit,
             no deleted id, upserted survivors in their own top-10 at
             >= 0.9, recall before the generation within 0.01 of the
             static index's), then a forced generation (auto band, PQ
             retrained), timed build and install; S6 two mutable cached
             local replicas on S2's Zipf trace on the wall clock while a
             thread upserts, deletes and runs a generation (no request
             sees an id deleted before it was submitted; after each
             stream a served batch == the uncached search_ivfpq; the
             mutation counts == the operations issued); S7 one mutable
             sharded replica, f32 (upsert, delete, forced generation)
             then uint8 (delete), on the Poisson trace, == the local
             engine on the same snapshot.  The checks read the smoke's
             own LiveSet model of the live ids, not the code under test;
             A-D are held to their plain versions once more on the live
             snapshot's first chunk, whose padded width is its own;
    tiered:  beyond-memory serving over the same index, a quarter of the
             padded clusters on the card and the rest in a CRC-checked
             spill under build/tier (free space checked first, removed
             at the end): T1 TieredStore.from_clusters, open + full
             verify, LocalEngine over the tier, the 10,000 queries at
             f32 and uint8, then 5 churn passes (each 4,096 queries
             drawn Zipf(1.1) under its own permutation, with promotions
             and demotions of its own; every pass == search_ivfpq bit
             for bit, resident bytes within the budget after each),
             one chunk's parts timed alone, a budget_s=0 batch (degraded,
             == search_ivfpq over the clusters with the cold ones
             emptied); T2 the two-level CL (128 groups): at full fan-out
             the queries whose probe set differs from flat CL's, each
             checked to be a near-tie, and recall and CL time at nprobe1
             = 8; T3 the tiered DistributedEngine over the reopened spill
             (2 batches of 1,000 at f32, 1 at uint8, == T1 at rtol 1e-4 /
             atol 1e-3 with k-th-place ties); the CRC checks (a rotten
             resident cluster rebuilt on demotion, verify() clean, a
             rotten cold one raising CorruptClusterError by its id and
             dropped by gather_degraded); S8 one tiered AnnService replica
             on S2's Zipf trace, wall clock, == search_ivfpq bit for bit,
             beside S5;
    tenancy: multi-tenant serving on the same index: 8 tenants (a
             vector's mixture component mod 8, redrawn from the seed)
             and a ninth with 5 rows, one tag column (id % 16) in 4
             fields, a query's tenant the majority tenant of its nearest
             centroid (one in 8 unscoped): N1 the scoped LocalEngine over
             the 10,000 queries at f32 and uint8, tenant only, tenant +
             term (3) and tenant + terms (1, 5, 9, 13) (no id outside its
             scope; every tenant == search_ivfpq over its tenant_subindex,
             near-tie probe sets counted and checked; the post-filter
             oracle on 256 queries; the unscoped rows == search_ivfpq bit
             for bit; the 5-row tenant's (inf, -1) tail; the mask timed
             alone); N2 one scoped DistributedEngine (64 shards), 1,000
             queries at f32 and at uint8, == N1 at the sharded tolerance,
             the reference's names of its step on raw scope arrays
             (run_shards_vmap_scoped, f32 and uint8;
             run_shards_vmap_lut_scoped on a bank of the step's tables)
             == run_shards_scoped with the batch's Scope bit for bit,
             and C/D against their plain versions at the scoped step's
             shape; N3 the tier (a quarter resident), two scoped passes
             == N1 bit for bit; N4 a live Index with 1,024 upserts tagged
             to tenant 2 (self-retrieved under tenant 2, never under
             another, == the snapshot's sub-index); S9 one tenant-aware
             local replica (t0 weight 4, t7 at 100 QPS burst 4, WFQ) on
             the Poisson trace on both clocks (every served result == the
             direct scoped search, only t7 shed, on the virtual clock as
             many as the smoke's own token-bucket model says);
    chaos:   the chaos harness's canonical experiment
             (service/chaos.py::chaos_experiment) on the same index: X two
             tiered local replicas with a quarter of the padded clusters
             on the card, the harness's spec (nprobe 8, buckets 1..8,
             deadline 50 ms, 2 retries with 1 ms backoff, breaker at 3,
             checksums) armed with default_plan(seed) (2% batch failures,
             5% cold-read IOErrors, 5% stragglers of 5 ms, one spill
             corruption after 4 consultations), 1,000 Zipf(1.1) draws
             from the 10,000 queries offered on the wall clock at 200 QPS,
             f32 then uint8, then f32 on 1,000 uniform draws over a
             sixteenth resident at a promote margin of 1e6 (a hot set
             past the budget, read from the host: cold reads must fire,
             the tier drop probes and answers come back degraded), each
             held to its own fault-free fleet (the
             reference's floors: availability >= 0.95, every non-degraded
             answer bit for bit the fault-free one, engine.batch fired,
             the one rotted cluster healed; and every failed batch an
             injected one); then A-D against their plain versions at one
             served batch's shape (8 queries x nprobe 8);
    autotune: the SLO autotuner (autotune_service) on its own corpus at
             the main path's width, U: N = 1M, D = 128, 64 components,
             256 queries, nlist 4,096, CB 256, TuneSpace m (16, 32, 64) x
             nprobe (8, 32, 96) x LUT (uint8, f32) x cache (0, 16 MiB),
             SLO recall@10 >= 0.8 and p99 <= 50 ms, 8 candidates measured
             on 400 calibration requests at 2,000 QPS (skew 1.1); either
             outcome is a result: a winner's spec validated, saved and
             loaded equal, meeting the SLO, its service == search_ivfpq
             over the tuned index bit for bit; or SLOInfeasible with a
             frontier of 8 measured entries, none meeting it, and then a
             second run under recall@10 >= 0.15 (p99 unbounded), which
             the frontier meets, so the winner's checks run too.  The
             shortlist (36 modeled, 18 survivors, 18 pruned) is the one
             tests/test_torch_autotune.py pins against the reference.
             After each run, A-D against their plain versions on every
             index it built (32 queries at the largest nprobe measured;
             dsub 8, 4 and 2).  Its latencies are PIM-paced: modeled
             UPMEM time, not the card's;
    variants: the paper-side variants and the entry points on the main
             path's index: V1 a DPQ codebook (core/dpq.py) trained on the
             card with train_dpq's defaults (300 steps, k-means warm
             start) on the residuals of 131,072 index rows drawn from the
             seed, every row re-encoded with it (IVFPQIndex._replace,
             pad_clusters), the 10,000 queries searched through A-D at
             f32 and uint8 (recall@10 beside the k-means index's, the
             uint8 drop <= 0.01, the loss falling, the reconstruction MSE
             beside k-means' on the training rows), then A-D against
             their plain versions on its first chunk; V2 the
             multiplier-less LC and DC (core/multiplierless.py) on the
             first chunk's 8,192 tasks: at scales 1.0 (the uint8 grid),
             0.5 and 0.25 every integer LUT built without multiplies
             equals the multiplied one bit for bit, the quantized
             integers equal the CPU's (at 1.0 the tables too), the
             integer DC's top-10 is read against the f32 search's and its
             top-1 against the float DC's (the reference's 0.8 floor,
             held at the coarsest scale meeting it), and the integer LC
             and DC are timed against A and C; L1 the entry points in
             this process: ``repro_torch.launch.serve --ann`` on both
             clocks, with ``--spec`` (a sharded uint8 spec saved here)
             and with ``--autotune``, each exiting 0 with served ==
             svc.search, then examples/torch_quickstart.py (>= 0.8 on
             its three searches) and examples/torch_distributed_anns.py;
    lm:      the LM stack (repro_torch/models) and the RAG path, after the
             ANN phases' index is freed: LM1 all ten archs at their smoke
             configs on weights drawn once on the CPU, the card's forward
             and 16 decode steps == the CPU port's (rtol 1e-4, atol 1e-3
             or 1e-4 of the logits' scale where that is larger), decode ==
             forward on the card (5e-3,
             MoE at capacity
             factor 8), and S = 2,048 through the chunked attention path
             (causal skip; the local window) == the dense masked path;
             LM2 llama32_vision_11b (the RAG model: 40 layers, 8 of them
             cross-attention, 9.777 B parameters in bf16) and whisper_base
             at their full configs, drawn on the card tensor by tensor and
             counted against count_params_analytic, generate at B = 4,
             prompt 16, gen 16, one decode step timed against its bound,
             peak memory, then decode == forward over the 16-token prompt
             in bf16 within 5e-2 of the logits' scale with every wq
             scaled by 2^-6 (at the reference's draw attention is a hard
             argmax whose ties flip under rounding; logged there), then
             the same weights in f32: decode == forward at 5e-3 with wq
             scaled, and logged at the draw; LM3 the RAG path through
             ``launch.serve`` (serve_ann, then rag_decode: ``--ann --engine
             sharded --arch llama32_vision_11b`` at the full config and
             ``--ann --arch whisper_base --smoke``, each served ==
             svc.search) and examples/torch_rag_serving.py, every kernel
             they launched held to its plain version at the shapes it was
             given;
    train:   the LM stack's training half, after the lm phase freed its
             weights: TR1 all ten archs at their smoke configs (f32) on
             weights drawn once on the CPU, one make_train_step on the
             card == on the CPU (loss and grad_norm at LM1's tolerance),
             and on the card the remat "full" and "half" gradients ==
             "none"'s at 1e-5 of each leaf's scale; TR2 minitron_4b at its
             full published config (32 layers, d_model 3,072, GQA 24/8,
             d_ff 9,216, vocab 256,000: 5,096,279,040 parameters in bf16,
             f32 AdamW moments, remat "full"), one backward logged at the
             reference's draw (its gradient grows ~4.5x a layer backward,
             to ~7e18; not held), then the attention projections rescaled
             to their contracted fan-in and 8 steps at train_loop's AdamW
             settings, B = 1, S = 4,096 (train_4k's length; its batch of
             256 cut to what one card holds beside 61 GB of state) on the
             Zipf pipeline: every loss and grad_norm finite, grad_norm > 0,
             the loss falling, the peak within the card; the step by CUDA
             events against its bound, tokens/s, MFU, one step under
             torch.profiler; TR3 ``python -m repro_torch.launch.train
             --arch qwen3_14b --smoke --steps 10 --ckpt-dir
             build/train_ckpt`` in process after a run of the same
             settings crashed at step 6: it resumes there, its losses ==
             an uninterrupted run's at rtol 1e-5, its last checkpoint read
             by a numpy reader of the reference's format; then
             examples/torch_train_lm.py --steps 60 with the loss falling.
             No full-size checkpoint is written (61 GB of host disk).

The launch counters of the six kernels are reset just before each path
and read just after it; every kernel of the path must have risen (the
mesh path's count is its mesh searches' alone, A, B, E and F; the
service, mutation and tiered paths run all six; the tenancy path runs
A-D: the fused E/F cannot take the scope mask; the chaos path A-D, A and
C on its f32 runs and B and D on its uint8 run; the autotune path the LC
and DC kernels of the LUT dtypes it measured; the variants path all six:
A-D in V1 and the local entry points, E by the distributed example, F by
the sharded uint8 spec; the lm path A, C and E in LM3, LM1 and LM2
launching none of the six; the train path none; the dryrun path A, B,
E and F, and the bf16-table kernels A-bf16, C-bf16 and E-bf16).
Phase 15, the dry-run (``launch/dryrun.py``), runs this process as rank 0
of a fake world of 256 on the (16, 16) production mesh: D1 the drim cell
at rank 0's shard of the 100M shape (512 slots of 4,096 codes, 8,192
tasks), fused, f32, uint8 then bf16 (the reference's
``_shard_tasks_fn(lut_dtype=bf16)``: A-bf16 then E-bf16), then bf16
unfused (A-bf16, C-bf16, ``torch.topk``), its launches held to plain
afterwards (``at_dryrun_cell`` in A, B, E, F and the bf16 rows), E-bf16
timed alone on its captured launch beside its bound, with the instance
the wrapper picked (key bits, threads), the bf16
step's ms logged beside f32's and uint8's (the records' median of five
steps, and each fused step's device time by CUDA events) with its
``hbm_bytes`` and the top-10 overlap of the bf16 and f32 winners; D2
``qwen3_14b``
``train_4k`` and D3 ``decode_32k`` (tp + FSDP, parameters and moments
drawn on the card), one warm step counting FLOPs on local shards and
collective bytes, one timed step, each held to ``fits`` (80 GB) and its
record printed; D4 a smoke checkpoint restored onto the mesh, rank 0's
slices equal to numpy's.  The world is destroyed at the end.
Recall@10 is taken against the port's exact_search; the sharded results
are held to the local path's on the same queries, and served results to
a direct search: every local service cell bit for bit to the uncached
search_ivfpq of the same queries at its LUT dtype.  The last lines printed are one ``{"kernels": [...]}``
JSON line and ``{"ok": true, "device": {...}}``; A's and B's rows carry
their times at the sharded step's first LC launches too, and A, B, E
and F's rows their times at a mesh entry (``at_mesh_entry``); ``launches``
sums the local and sharded paths, as before the service existed, and
``launches_by_path`` gives each path's own count, the mesh's, the
service's, the mutation's, the tiered, the tenancy, the chaos, the autotune, the
variants, the lm, the train and the dryrun path's included.  The bf16
rows (``lut_build_bf16``, ``pq_scan_dc_bf16``, ``pq_scan_topk_bf16``) are
checked, timed and bounded at the first chunk's shape and the sharded
step's (the table at 2 B an entry; E-bf16's instance logged); their
``launches`` are D1's, the one path that runs them.  E's and F's
first sharded launches, with their LC inputs and those of the local
path's first chunk, are written to ``build/sharded_launch.pt``, which
``tools/torch_fused_topk_bench.py`` and ``tools/torch_lut_build_bench.py``
replay.
Any failed check raises, so the exit code is non-zero and the ``ok`` line
is never printed; so is a run without CUDA or outside a checkout.

Configuration: the repo's DRIM-ANN shape (D, M, CB, k and the query
batch read from repro_torch/configs/drim_ann.py, the paper's SV-A setup:
D=128 uint8 points, M=16, CB=256, k=10, 10,000 queries a batch), with N
cut from 100M to 10M so one run can generate and build the index; nlist
= 4 sqrt(N) rounded up to a power of two (16,384 at 10M; the config's
65,536), train_sample = 40 nlist, nprobe = 32 (the config's 96),
query_chunk 256
(8,192 LC/DC tasks a launch).  ``--n-points`` cuts N further for a quick
run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import resource
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.drim_ann import config as drim_ann_config  # noqa: E402

LAUNCH_FILE = ROOT / "build" / "sharded_launch.pt"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
RTOL, ATOL = 1e-4, 1e-3        # the reference's kernel tolerance

# the paper's shape (configs/drim_ann.py); N, nlist and nprobe are cut
CFG = drim_ann_config()
D, M, CB, K = CFG.dim, CFG.m, CFG.cb, CFG.k
N_QUERIES, QUERY_CHUNK, NPROBE = CFG.queries_per_batch, 256, 32
N_RECALL, N_SERVE = 1_000, 400
N_SHARDS, SPLIT_MAX, SHARD_BATCH, TASKS_PER_SHARD = 64, 1024, 1_000, 1024

KERNELS = {   # wrapper counter -> (route source, TPU kernel it replaces)
    "lut_build": ("src/repro_torch/kernels/csrc/lut_build.cu",
                  "src/repro/kernels/lut_build.py:49"),
    "lut_build_q": ("src/repro_torch/kernels/csrc/lut_build.cu",
                    "src/repro/kernels/lut_build.py:100"),
    "pq_scan_dc": ("src/repro_torch/kernels/csrc/pq_scan.cu",
                   "src/repro/kernels/pq_scan.py:118"),
    "pq_scan_dc_q": ("src/repro_torch/kernels/csrc/pq_scan.cu",
                     "src/repro/kernels/pq_scan.py:151"),
    "pq_scan_topk": ("src/repro_torch/kernels/csrc/pq_scan_topk.cu",
                     "src/repro/kernels/pq_scan.py:214"),
    "pq_scan_topk_q": ("src/repro_torch/kernels/csrc/pq_scan_topk.cu",
                       "src/repro/kernels/pq_scan.py:290"),
}
LOCAL_KERNELS = ("lut_build", "lut_build_q", "pq_scan_dc", "pq_scan_dc_q")
SHARDED_KERNELS = ("lut_build", "lut_build_q", "pq_scan_topk",
                   "pq_scan_topk_q")
# The bf16-table variants of A, C and E: the counter -> (route source, the
# TPU kernel it is a variant of).  They compute the reference's bf16 step,
# which the reference runs through XLA (BF16_COMPUTES), and run in D1.
BF16_KERNELS = {
    "lut_build_bf16": ("src/repro_torch/kernels/csrc/lut_build.cu",
                       "src/repro/kernels/lut_build.py:49"),
    "pq_scan_dc_bf16": ("src/repro_torch/kernels/csrc/pq_scan.cu",
                        "src/repro/kernels/pq_scan.py:118"),
    "pq_scan_topk_bf16": ("src/repro_torch/kernels/csrc/pq_scan_topk.cu",
                          "src/repro/kernels/pq_scan.py:214"),
}
BF16_COMPUTES = "src/repro/core/sharded_search.py:201"   # lut_dtype=bf16
# TS by slot: the counter -> (route source, what it replaces: no Pallas
# kernel; the reference's TS is jax.lax.top_k, which XLA runs).
TS_KERNEL = {"ts_topk": ("src/repro_torch/kernels/csrc/ts_topk.cu",
                         "none (jax.lax.top_k in topk_smallest, "
                         "src/repro/core/topk.py:19)")}
# The benchmark's chunk (annbench's cells): 256 queries x 96 probes of
# C = 6,200 rows over 65,536 clusters holding 1e8 rows, sizes log-normal
# of spread 0.337.
TS_CELL = {"qc": 256, "p": 96, "c": 6200, "nslots": 65536, "n": 10 ** 8,
           "spread": 0.337}
# The kernels a phase's launch counts cover (TS by slot runs wherever a
# local engine searches unscoped, but on no path's every phase).
COUNTED = (*KERNELS, *TS_KERNEL)
BF16_RTOL = 2.0 ** -8          # the bf16 rule: within 2^-8 of the value
SERVICE_BUCKETS = (1, 2, 4, 8, 16, 32)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, warm: int = 2, queued: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` warm calls by CUDA events.
    ``queued``: the calls are enqueued behind a device-side sleep that
    outlasts their host dispatch (1.5x the warm calls' host time, at
    most 0.2 s at an assumed 2 GHz), so the events time the device's work
    alone; otherwise a kernel shorter than its wrapper's host overhead is
    timed by the host."""
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t0) / max(warm, 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(0.2, 1.5 * reps * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lut_bytes_ops(t: int, m: int, cb: int, dsub: int, quant: bool,
                  bf16: bool = False):
    """LC's bound inputs: bytes (residuals, codebooks and norms read once,
    the f32 table, the bf16 table, or the u8 table with scale and bias,
    written once) and operations (per entry dsub FMAs, the combination and
    the clamp; per row ||r||^2; B adds the min, max, subtraction,
    division, rounding and clamp of each entry, the bf16 table the
    rounding)."""
    nbytes = t * m * dsub * 4 + m * cb * dsub * 4 + m * cb * 4
    nbytes += (t * m * cb + 2 * t * m * 4 if quant else
               t * m * cb * (2 if bf16 else 4))
    nops = t * m * cb * (2 * dsub + 4) + t * m * 2 * dsub
    if quant:
        nops += t * m * cb * 6
    elif bf16:
        nops += t * m * cb
    return nbytes, nops


def ptxas_instances(text: str) -> list:
    """(kernel, registers, stack frame bytes, spill store bytes, spill
    load bytes) for each entry function in nvcc's ``-Xptxas -v`` output;
    a template instance reads e.g. ``lut_build_kernel<8, 0, 0>``."""
    out, name, frame = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            k = re.search(r"([a-z_]+_kernel)I((?:L[a-z]+\d+E|[a-z])+)E",
                          name)
            if k:
                args = [a or {"h": "u8", "i": "i32"}.get(t, t) for a, t in
                        re.findall(r"L[a-z]+(\d+)E|([a-z])", k.group(2))]
                name = f"{k.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *frame))
            name = None
    return out


def same_neighbours(kd, ki, pd, pi, rtol, atol):
    """Count queries whose id sets differ beyond a tie at the k-th place.
    (kd, ki): k columns; (pd, pi): the other path with k+1 columns."""
    bad = 0
    for q in range(ki.shape[0]):
        got, want = set(ki[q].tolist()), set(pi[q, :K].tolist())
        if got == want:
            continue
        kth, nxt = pd[q, K - 1], pd[q, K]
        sure = {i for i, d in zip(pi[q, :K], pd[q, :K])
                if d < kth - (atol + rtol * abs(kth))}
        if not (np.isclose(kth, nxt, rtol=rtol, atol=atol) and sure <= got):
            bad += 1
    return bad


def tie_diff_rows(d1, i1, d2, i2, rtol, atol):
    """Count rows whose id sets differ beyond ties at the k-th place: an
    id found on one side only must sit at that side's k-th distance, and
    the two k-th distances must agree.  (d, i): (Q, k) numpy arrays."""
    bad = 0
    k = i1.shape[1]
    differ = np.nonzero((np.sort(i1, 1) != np.sort(i2, 1)).any(1))[0]
    for q in differ:
        a, b = set(i1[q].tolist()), set(i2[q].tolist())
        ok = np.isclose(d1[q, k - 1], d2[q, k - 1], rtol=rtol, atol=atol)
        for ids, d, only in ((i1[q], d1[q], a - b), (i2[q], d2[q], b - a)):
            for j in np.nonzero(np.isin(ids, list(only)))[0]:
                ok &= np.isclose(d[j], d[k - 1], rtol=rtol, atol=atol)
        bad += int(not ok)
    return bad


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def check_lut(ops, ref, adc, res, books, sqn, where: str,
              chunk: int = 0):
    """A against its plain version (the same expansion form) and the
    subtraction-form oracle; B against quantize_lut of A's output (the
    reference's contract: <= 1 count) and of the plain f32 table.  One
    launch each over all rows, compared ``chunk`` rows at a time (0: all
    at once; the oracle holds a (rows, M, CB, dsub) difference tensor).
    Returns (A, B, A's max |err| vs plain, B's max count diff vs plain)."""
    from repro_torch.core.pq import PQCodebook
    t = res.shape[0]
    chunk = chunk or t
    lut = ops.lut_build(res, books, sqn)
    q = ops.lut_build_q(res, books, sqn)
    cbk = PQCodebook(books, sqn)
    err, err_oracle = 0.0, 0.0
    counts = [[0, 0], [0, 0]]       # (max diff, entries off by one count)
    for a in range(0, t, chunk):
        r, got = res[a:a + chunk], lut[a:a + chunk]
        got_q = adc.QuantizedLUT(*(x[a:a + chunk] for x in q))
        plain = adc.build_lut_batch(cbk, r)
        oracle = ref.lut_build_ref(r.view(r.shape[0], books.shape[0], -1),
                                   books, sqn)
        torch.cuda.synchronize()
        err = max(err, float((got - plain).abs().max()))
        err_oracle = max(err_oracle, float((got - oracle).abs().max()))
        check(torch.allclose(got, plain, rtol=RTOL, atol=ATOL)
              and torch.allclose(got, oracle, rtol=RTOL, atol=ATOL),
              f"lut_build {where}, rows {a}+: max |err| {err} vs plain, "
              f"{err_oracle} vs oracle")
        for j, (name, table) in enumerate((("A's output", got),
                                           ("the plain table", plain))):
            hq = adc.quantize_lut(table)
            diff = (got_q.lut_q.int() - hq.lut_q.int()).abs()
            check(int(diff.max()) <= 1 and torch.allclose(
                      got_q.scale, hq.scale, rtol=RTOL, atol=ATOL)
                  and torch.allclose(got_q.bias, hq.bias, rtol=RTOL,
                                     atol=ATOL),
                  f"lut_build_q {where}, rows {a}+: differs from "
                  f"quantize_lut({name})")
            counts[j][0] = max(counts[j][0], int(diff.max()))
            counts[j][1] += int((diff != 0).sum())
    log(f"  {where}: lut_build max|err| {err:.3e} vs plain; lut_build_q "
        f"differs by 1 count on {counts[0][1]} of {q.lut_q.numel()} entries "
        f"vs quantize_lut(A), on {counts[1][1]} vs the plain version")
    return lut, q, err, counts[1][0]


def tol_of(ops, lut):
    """(rtol, atol) of a scan on ``lut`` against its plain version: the
    kernel tolerance, or on a bf16 table the bf16 rule (within 2^-8 of
    the value; the plain version sums in the kernels' order and rounds
    once, so the two are expected bit-equal)."""
    return (BF16_RTOL, 0.0) if ops.table_kind(lut) == "bf16" else (RTOL, ATOL)


def bf16_ulps(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp of each value: 2^(e - 7) for |x| in [2^e, 2^(e+1))."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_lut_bf16(ops, adc, res, books, sqn, where: str, chunk: int = 0):
    """A-bf16 against A's table cast to bf16 (bit for bit) and against its
    plain version, ``build_lut_batch`` cast to bf16 (within one bf16 ulp:
    A's f32 entries and plain's may round to neighbouring bf16 values),
    ``chunk`` rows at a time.  Returns (A-bf16's table, max |err| vs
    plain)."""
    from repro_torch.core.pq import PQCodebook
    t = res.shape[0]
    chunk = chunk or t
    got = ops.lut_build_bf16(res, books, sqn)
    cbk = PQCodebook(books, sqn)
    err, same = 0.0, 0
    for a in range(0, t, chunk):
        r = res[a:a + chunk]
        a_cast = ops.lut_build(r, books, sqn).to(torch.bfloat16)
        plain = adc.build_lut_batch(cbk, r).to(torch.bfloat16).float()
        g = got[a:a + chunk]
        torch.cuda.synchronize()
        check(torch.equal(g, a_cast), f"lut_build_bf16 {where}, rows {a}+: "
                                      f"differs from lut_build's table cast "
                                      f"to bf16")
        d = (g.float() - plain).abs()
        err = max(err, float(d.max()))
        same += int((d == 0).sum())
        check(bool((d <= bf16_ulps(plain)).all()),
              f"lut_build_bf16 {where}, rows {a}+: more than one bf16 ulp "
              f"from its plain version (max |err| {err})")
    log(f"  {where}: lut_build_bf16 == lut_build cast to bf16 bit for bit; "
        f"max|err| {err:.3e} vs plain, bit-equal on {same} of "
        f"{got.numel()} entries")
    return got, err


def check_scan(ops, plain_f32, plain_u8, lut, q, codes, sizes, where: str,
               slots=None):
    """C on the f32 table ``lut`` (C-bf16 on a bf16 one) and D on the
    QuantizedLUT ``q`` (either may be None) against their plain versions,
    with and without sizes; a bf16 table by the bf16 rule, at least 99%
    of the distances bit-equal.  With ``slots`` the kernels run by slot
    (codes and sizes are P slots, sizes required) and are held to the
    plain version on ``gather_slots``' copy, and bit for bit to their
    dense launch on that copy."""
    errs = {}
    if slots is not None:
        gcodes, _, gsizes = ops.gather_slots(codes, None, sizes, slots)
    for table, plain in ((lut, plain_f32), (q, plain_u8)):
        if table is None:
            continue
        name = "pq_scan_dc" + ops.KIND_SUFFIX[ops.table_kind(table)]
        rtol, atol = tol_of(ops, table)
        for sz in ((sizes, None) if slots is None else (sizes,)):
            if slots is None:
                got = ops.pq_scan_dc(table, codes, sz)
                want = plain(table, codes, sz)
            else:
                got = ops.pq_scan_dc(table, codes, sz, slots=slots)
                want = plain(table, gcodes, gsizes)
                check(torch.equal(got, ops.pq_scan_dc(table, gcodes, gsizes)),
                      f"{name} {where}: by slot differs from the dense "
                      f"launch on the gathered copy")
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)),
                  f"{name} {where}: +inf mask differs")
            e = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
            check(torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol),
                  f"{name} {where}: max |err| {e}")
            if name.endswith("_bf16") and fin.any():
                eq = float((got[fin] == want[fin]).float().mean())
                check(eq >= 0.99, f"{name} {where}: only {eq:.4f} of the "
                                  f"distances bit-equal to plain")
            errs[name] = max(errs.get(name, 0.0), e)
    log(f"  {where}{'' if slots is None else ' (slots)'}: " + ", ".join(
        f"{name} max|err| {e:.3e}" for name, e in errs.items()))
    return errs


def check_topk(ops, lut, codes, ids, sizes, k: int, where: str,
               slots=None) -> float:
    """E, F or E-bf16 against its plain version (DC, then top-k_pad):
    distances allclose (bf16: by the bf16 rule, ``tol_of``) with equal
    +inf masks, -1 ids exactly at +inf, per-task id sets equal apart from
    ties at the k-th place.  Then, bit for bit, the first k entries of the
    (distance, row) sort of C's, D's or C-bf16's output on the same
    (gathered) inputs and, with ``slots``, the dense launch on the
    gathered inputs.  Returns max |err| against the plain version."""
    from repro_torch.util import next_pow2
    k_pad = next_pow2(max(k, 8))
    gd, gi = ops.pq_scan_topk(lut, codes, ids, sizes, k, slots=slots)
    pd, pi = ops.pq_scan_topk_plain(lut, codes, ids, sizes, k_pad,
                                    slots=slots)
    dense = ((codes, ids, sizes) if slots is None
             else ops.gather_slots(codes, ids, sizes, slots))
    dc = ops.pq_scan_dc(lut, dense[0], dense[2])
    sd, row = torch.sort(dc, dim=1, stable=True)
    sd, row = sd[:, :k], row[:, :k]
    si = torch.where(torch.isinf(sd), -1, dense[1].gather(1, row))
    torch.cuda.synchronize()
    name = "pq_scan_topk" + ops.KIND_SUFFIX[ops.table_kind(lut)]
    rtol, atol = tol_of(ops, lut)
    what = f"{name} {where} k={k}" + ("" if slots is None else " (slots)")
    n = sd.shape[1]
    check(torch.equal(gd[:, :n], sd) and torch.equal(gi[:, :n], si)
          and bool(torch.isinf(gd[:, n:]).all())
          and bool((gi[:, n:] == -1).all()),
          f"{what}: differs from the (distance, row) sort of the DC "
          f"kernel's output")
    if slots is not None:
        dd, di = ops.pq_scan_topk(lut, *dense, k)
        check(torch.equal(gd, dd) and torch.equal(gi, di),
              f"{what}: differs from the dense launch on gathered inputs")
    gd, gi, pd, pi = (x.cpu().numpy() for x in (gd, gi, pd, pi))
    inf = np.isinf(pd[:, :k])
    check(np.array_equal(np.isinf(gd), inf), f"{what}: +inf mask differs")
    check(bool((gi[inf] == -1).all() and (gi[~inf] >= 0).all()),
          f"{what}: -1 ids not exactly at +inf")
    err = float(np.abs(gd[~inf] - pd[:, :k][~inf]).max()) if (~inf).any() \
        else 0.0
    check(np.allclose(gd[~inf], pd[:, :k][~inf], rtol=rtol, atol=atol),
          f"{what}: max |err| {err}")
    bad = tie_diff_rows(gd, gi, pd[:, :k], pi[:, :k], rtol, atol)
    check(bad == 0, f"{what}: ids differ on {bad} tasks beyond k-th-place "
                    f"ties")
    return err


def ts_by_position(dists, slots, ids, qc: int, k: int):
    """TS's exact answer: each query's rows sorted stably by distance (ties
    by the lower position probe * C + row), the first k with their ids;
    a padded row's id is -1, as is every row of a slot outside [0,
    nslots)."""
    nslots, c = ids.shape
    d, pos = torch.sort(dists.reshape(qc, -1), dim=-1, stable=True)
    d, pos = d[:, :k], pos[:, :k]
    s = slots.long().reshape(qc, -1).gather(1, pos // c)
    valid = (s >= 0) & (s < nslots)
    i = torch.take(ids, torch.where(valid, s, 0) * c + pos % c)
    return d, i.masked_fill(~valid, -1)


def check_ts(ops, dists, slots, sizes, ids, qc: int, k: int,
             where: str) -> int:
    """TS by slot against its plain route (``torch.topk`` and the id
    lookup): distances bit for bit, ids equal beyond ties at the k-th
    place; bit for bit the stable (distance, position) sort's first k;
    and the same answers with every padded entry of ``dists`` (+inf from
    DC) at -1.0, so no padded row is read.  Returns the queries whose ids
    differ from the plain route's in the order of equal distances
    alone."""
    gd, gi = ops.ts_topk(dists, slots, sizes, ids, qc, k)
    pd, pi = ops.ts_topk_plain(dists, slots, ids, qc, k)
    sd, si = ts_by_position(dists, slots, ids, qc, k)
    xd, xi = ops.ts_topk(dists.masked_fill(torch.isinf(dists), -1.0), slots,
                         sizes, ids, qc, k)
    torch.cuda.synchronize()
    what = f"ts_topk {where} k={k}"
    check(torch.equal(gd, sd) and torch.equal(gi, si),
          f"{what}: differs from the (distance, position) sort")
    check(torch.equal(gd, pd), f"{what}: distances differ from the plain "
                               f"route's")
    check(torch.equal(xd, gd) and torch.equal(xi, gi),
          f"{what}: the answers move when the padded rows are poisoned")
    gd, gi, pi = (x.cpu().numpy() for x in (gd, gi, pi))
    bad = tie_diff_rows(gd, gi, gd, pi, 0.0, 0.0)
    check(bad == 0, f"{what}: ids differ from the plain route's on {bad} "
                    f"queries beyond k-th-place ties")
    return int((gi != pi).any(axis=1).sum())


def ts_inputs_at_cell(seed: int):
    """TS by slot's inputs at the benchmark's chunk (TS_CELL): DC's
    output over random probes, real rows uniform, +inf past each size;
    sizes log-normal around n / nslots rows, clamped to C."""
    qc, p, c, nslots = (TS_CELL[x] for x in ("qc", "p", "c", "nslots"))
    spread = TS_CELL["spread"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(nslots, device="cuda", generator=g)
    sizes = (TS_CELL["n"] / nslots * torch.exp(spread * z - spread ** 2 / 2)
             ).clamp(max=c).int()
    row = torch.arange(c, device="cuda")
    ids = (torch.arange(nslots, device="cuda")[:, None] * c + row).int()
    ids.masked_fill_(row[None, :] >= sizes[:, None], -1)
    slots = torch.randint(0, nslots, (qc * p,), device="cuda", generator=g,
                          dtype=torch.int32)
    dists = torch.rand((qc * p, c), device="cuda", generator=g) * 1e5
    dists.masked_fill_(row[None, :] >= sizes[slots.long()][:, None],
                       float("inf"))
    return dists, slots, sizes, ids, qc


def ts_row(ops, dists, slots, sizes, ids, qc: int, k: int, where: str,
           launches: int) -> dict:
    """Check TS by slot on these inputs (check_ts), then time it (mean of
    20 warm launches), its plain route and ``torch.topk`` with the id
    lookup (the code the kernel replaced: ``library_ms``), beside its
    bytes bound: the real rows' distances once, a slot and a size a task,
    the winners' ids, the (qc, k) distances and ids out."""
    t, c = dists.shape
    p = t // qc
    tie_rows = check_ts(ops, dists, slots, sizes, ids, qc, k, where)
    s = slots.long()
    valid = (s >= 0) & (s < sizes.shape[0])
    real = int(torch.where(valid, sizes[s.clamp(0, sizes.shape[0] - 1)],
                           0).clamp(0, c).sum())
    nbytes = real * 4 + t * 8 + qc * k * 12
    probes = s.reshape(qc, p)

    def library():
        d, pos = torch.topk(dists.reshape(qc, -1), k, dim=-1, largest=False,
                            sorted=True)
        return d, torch.take(ids, probes.gather(1, pos // c) * c + pos % c)

    ms = event_ms(lambda: ops.ts_topk(dists, slots, sizes, ids, qc, k),
                  reps=20, queued=True)
    plain_ms = event_ms(lambda: ops.ts_topk_plain(dists, slots, ids, qc, k),
                        reps=5, warm=1, queued=True)
    lib_ms = event_ms(library, reps=20, queued=True)
    b_ms, b_by = bound_ms(nbytes, real)
    log(f"  ts_topk {where}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
        f"{ms / b_ms:.2f}x; plain {plain_ms:.4f} ms, library (torch.topk + "
        f"the lookup) {lib_ms:.4f} ms); qc={qc} P={p} C={c} k={k}, "
        f"{real} real rows, ids in tie order apart on {tie_rows} queries")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes,
            "ops": real, "max_abs_err": 0.0, "tie_order_rows": tie_rows,
            "launches": launches,
            "shape": {"qc": qc, "P": p, "C": c, "k": k, "real_rows": real}}


def ts_report(ops, lut, slot_codes, slot_sizes, slot_ids, slots, qc: int,
              launches: int, seed: int) -> dict:
    """TS by slot's row of the kernel table: at the main path's first
    chunk (C by slot's output on ``lut``) and at the benchmark's chunk
    (ts_inputs_at_cell), k = K; k = 1 and 256 checked at the first."""
    dists = ops.pq_scan_dc(lut, slot_codes, slot_sizes, slots=slots)
    for k in (1, 256):
        check_ts(ops, dists, slots, slot_sizes, slot_ids, qc, k,
                 "main path first chunk")
    src, replaces = TS_KERNEL["ts_topk"]
    row = {"name": "ts_topk", "route": "cuda", "source": src,
           "replaces": replaces}
    row.update(ts_row(ops, dists, slots, slot_sizes, slot_ids, qc, K,
                      "main path first chunk", launches))
    del dists
    cell = ts_inputs_at_cell(seed)
    row["at_benchmark_chunk"] = ts_row(ops, *cell[:4], cell[4], K,
                                       "at the benchmark's chunk", 0)
    del cell
    torch.cuda.empty_cache()
    return row


def dc_inputs_at_cell(ops, seed: int, code_dtype=torch.uint8):
    """C / D by slot's inputs at the benchmark's chunk (TS_CELL): the
    cells' cluster sizes (``annbench/draws/ivfpq.py``'s multiset over
    nslots clusters, dealt in a seeded order), uniform codes in (nslots,
    C, M) slots, each query's distinct random probes, and A's and B's
    tables for random residuals.  Returns (lut, q, codes, sizes, slots).
    int32 codes (four times the bytes) fill only the probed slots, the
    others left zero."""
    from annbench.draws.ivfpq import size_multiset
    qc, p, c, nslots = (TS_CELL[x] for x in ("qc", "p", "c", "nslots"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    sizes = size_multiset(TS_CELL["n"], nslots, TS_CELL["spread"]).cuda()
    sizes = sizes[torch.randperm(nslots, device="cuda", generator=g)].int()
    slots = torch.rand(qc, nslots, device="cuda", generator=g).argsort(
        dim=1)[:, :p].reshape(-1).int()
    if code_dtype == torch.uint8:
        codes = torch.randint(0, CB, (nslots, c, M), dtype=torch.uint8,
                              device="cuda", generator=g)
    else:
        codes = torch.zeros((nslots, c, M), dtype=code_dtype, device="cuda")
        used = slots.long().unique()
        codes[used] = torch.randint(0, CB, (len(used), c, M),
                                    dtype=code_dtype, device="cuda",
                                    generator=g)
    res = torch.randn(qc * p, D, device="cuda", generator=g) * 8
    books = torch.randn(M, CB, D // M, device="cuda", generator=g) * 6
    sqn = (books * books).sum(-1)
    return (ops.lut_build(res, books, sqn), ops.lut_build_q(res, books, sqn),
            codes, sizes, slots)


def dc_cell_report(ops, adc, seed: int) -> dict:
    """C and D by slot at the benchmark's chunk (dc_inputs_at_cell):
    checked (check_scan on the first 512 tasks: by slot against plain and
    bit for bit against the dense launch; on every task, bit for bit the
    dense launch on ``gather_slots``' copy, +inf exactly at the rows at or
    past each size), then timed (mean of 20 warm launches) beside the
    bound the benchmark's DC roofline metrics take
    (``annbench/roofline.py::dc_bytes_ops``, ``roofline_u8.py::
    dc_u8_bytes_ops``: each task's table, the real rows' codes and
    distances, the sizes).  Returns {counter: row} for C and D."""
    from annbench import roofline, roofline_u8
    lut, q, codes, sizes, slots = dc_inputs_at_cell(ops, seed)
    t, c = slots.shape[0], codes.shape[1]
    gcodes, _, gsizes = ops.gather_slots(codes, None, sizes, slots)
    real = int(gsizes.sum())
    n = 512
    check_scan(ops, adc.adc_distances, adc.adc_distances_quantized, lut[:n],
               type(q)(*(x[:n] for x in q)), codes, sizes,
               f"the benchmark's chunk, first {n} tasks", slots[:n])
    padding = torch.arange(c, device="cuda")[None, :] >= gsizes[:, None]
    out = {}
    for name, table, count in (("pq_scan_dc", lut, roofline.dc_bytes_ops),
                               ("pq_scan_dc_q", q,
                                roofline_u8.dc_u8_bytes_ops)):
        def call():
            return ops.pq_scan_dc(table, codes, sizes, slots=slots)
        got = call()
        check(torch.equal(got, ops.pq_scan_dc(table, gcodes, gsizes)),
              f"{name} at the benchmark's chunk: by slot differs from the "
              f"dense launch on the gathered copy")
        check(torch.equal(torch.isinf(got), padding),
              f"{name} at the benchmark's chunk: +inf not exactly at the "
              f"rows past each size")
        del got
        ms = event_ms(call, reps=20, queued=True)
        nbytes, nops = count(t, M, CB, real)
        b_ms, b_by = bound_ms(nbytes, nops)
        out[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "roofline_pct": 100.0 * b_ms / ms, "bytes": nbytes,
                     "ops": nops, "shape": {"qc": TS_CELL["qc"],
                                            "P": TS_CELL["p"], "C": c,
                                            "T": t, "real_rows": real}}
        log(f"  {name} by slot at the benchmark's chunk: {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of "
            f"it); T={t} over {codes.shape[0]} slots, C={c}, {real} real "
            f"rows")
    del lut, q, codes, gcodes
    torch.cuda.empty_cache()
    return out


def ragged_topk_checks(ops, lut, q, codes, where: str, g) -> None:
    """E and F at k = 1, 10, 100 on one ragged shape (sizes < C, a task
    with sizes = 0), dense and in the slot form (the T tasks read code
    slots that repeat, -1 and one past the last among them), then with
    every row of a task scoring the same."""
    t, c = codes.shape[0], codes.shape[1]
    sizes = torch.randint(0, c, (t,), device="cuda", generator=g,
                          dtype=torch.int32)
    sizes[0] = 0
    ids = torch.randperm(t * c, device="cuda", generator=g).int().view(t, c)
    slots = torch.randint(-1, t, (t,), device="cuda", generator=g,
                          dtype=torch.int32)
    slots[0] = -1
    slots[-1] = slots[t // 2]
    if t > 2:
        slots[1] = t                                # out of range: no task
    errs = {}
    for k in (1, 10, 100):
        for table in (lut, q):
            key = "pq_scan_topk_q" if isinstance(table, tuple) \
                else "pq_scan_topk"
            for sl in (None, slots):
                e = check_topk(ops, table, codes, ids, sizes, k, where, sl)
                errs[key] = max(errs.get(key, 0.0), e)
    same = codes[:, :1].expand_as(codes).contiguous()
    for table in (lut, q):
        for sl in (None, slots):
            check_topk(ops, table, same, ids, sizes, 10, where + " equal rows",
                       sl)
    log(f"  {where}: pq_scan_topk max|err| {errs['pq_scan_topk']:.3e}, "
        f"pq_scan_topk_q max|err| {errs['pq_scan_topk_q']:.3e} "
        f"(k = 1, 10, 100, dense and by slot; all-equal rows too; equal "
        f"to the sorted DC output bit for bit)")


# (T, M, CB, dsub) for LC: every instance of csrc/lut_build.cu's launcher
# (dsub 1, 2, 4, 8: the codebook slice in registers; 16: staged in shared
# memory; 3, CB 20 and CB 512: the generic instance), CB 32 / 64 / 256,
# T = 1 and T not a multiple of a block's warps
LUT_RAGGED = ((1, 16, 256, 8), (9, 16, 32, 8), (37, 8, 64, 4),
              (300, 32, 256, 2), (1000, 16, 256, 1), (129, 8, 256, 16),
              (50, 4, 64, 16), (77, 5, 32, 3), (1, 3, 256, 3),
              (33, 4, 20, 8), (40, 4, 512, 8))


def ragged_lut_checks(ops, ref, adc, g) -> None:
    """A and B at LUT_RAGGED, then on residuals that start off a 16-byte
    boundary (a flat offset of one float, and a slice at an odd row of a
    (T, 10) tensor), which must give the same bits as an aligned copy."""
    def inputs(t, m, cb, dsub):
        books = torch.randn(m, cb, dsub, device="cuda", generator=g) * 6
        return books, (books * books).sum(-1)

    for t, m, cb, dsub in LUT_RAGGED:
        res = torch.randn(t, m * dsub, device="cuda", generator=g) * 8
        check_lut(ops, ref, adc, res, *inputs(t, m, cb, dsub),
                  f"LC T={t} M={m} CB={cb} dsub={dsub}")
    for t, m, cb, dsub, how in ((200, 16, 256, 8, "flat offset 1"),
                                (61, 5, 64, 2, "rows 1:")):
        if how == "rows 1:":
            res = (torch.randn(t + 1, m * dsub, device="cuda",
                               generator=g) * 8)[1:]
        else:
            flat = torch.randn(t * m * dsub + 1, device="cuda", generator=g)
            res = (flat * 8)[1:].view(t, m * dsub)
        books, sqn = inputs(t, m, cb, dsub)
        where = (f"LC T={t} M={m} CB={cb} dsub={dsub}, residuals {how} "
                 f"(data_ptr % 16 = {res.data_ptr() % 16})")
        lut, q, _, _ = check_lut(ops, ref, adc, res, books, sqn, where)
        copy = res.clone()
        q2 = ops.lut_build_q(copy, books, sqn)
        check(torch.equal(lut, ops.lut_build(copy, books, sqn))
              and all(torch.equal(a, b) for a, b in zip(q, q2)),
              f"{where}: differs from an aligned copy's output")


def ragged_checks(ops, ref, adc):
    """Shapes that are not multiples of the blocks, a task with sizes=0,
    sizes < C, u8 and i32 codes; LC at every instance of its launcher."""
    g = torch.Generator(device="cuda").manual_seed(1)
    ragged_lut_checks(ops, ref, adc, g)
    for t, c, code_dtype in ((1, 1, torch.uint8), (37, 1029, torch.uint8),
                             (300, 77, torch.int32), (5000, 2050,
                                                      torch.uint8)):
        res = torch.randn(t, D, device="cuda", generator=g) * 8
        books = torch.randn(M, CB, D // M, device="cuda", generator=g) * 6
        sqn = (books * books).sum(-1)
        codes = torch.randint(0, CB, (t, c, M), device="cuda", generator=g,
                              dtype=torch.int32).to(code_dtype)
        sizes = torch.randint(0, c + 1, (t,), device="cuda", generator=g,
                              dtype=torch.int32)
        sizes[0] = 0
        where = f"T={t} C={c} {str(code_dtype).split('.')[-1]}"
        lut, q, _, _ = check_lut(ops, ref, adc, res, books, sqn, where)
        check_scan(ops, adc.adc_distances, adc.adc_distances_quantized, lut,
                   q, codes, sizes, where)
        ragged_topk_checks(ops, lut, q, codes, where, g)


def main_shape_report(ops, ref, adc, res, books, sqn, slot_codes,
                      slot_sizes, slots, launches, slot_launches):
    """The main path's first chunk: check, time and bound each kernel.
    C and D run there by slot (task t scans cluster ``slots[t]`` of the
    padded clusters ``slot_codes``, ``slot_sizes`` in place): their rows
    time the dense form on ``gather_slots``' copy and, under ``by_slot``,
    the form the main path launches, with its ``slot_launches``."""
    codes, _, sizes = ops.gather_slots(slot_codes, None, slot_sizes, slots)
    t, c = codes.shape[0], codes.shape[1]
    dsub = books.shape[2]
    lut, q, err_a, err_b = check_lut(ops, ref, adc, res, books, sqn,
                                     f"main path T={t} C={c}")
    errs = check_scan(ops, adc.adc_distances, adc.adc_distances_quantized,
                      lut, q, codes, sizes, f"main path T={t} C={c}")
    slot_errs = check_scan(ops, adc.adc_distances,
                           adc.adc_distances_quantized, lut, q, slot_codes,
                           slot_sizes, f"main path T={t} "
                           f"P={slot_codes.shape[0]} C={c}", slots)
    valid = int(sizes.clamp(max=c).sum())
    from repro_torch.core.pq import PQCodebook
    cbk = PQCodebook(books, sqn)
    res3 = res.view(t, M, dsub)

    a_bytes, a_ops = lut_bytes_ops(t, M, CB, dsub, False)
    b_bytes, b_ops = lut_bytes_ops(t, M, CB, dsub, True)
    rows = {
        "lut_build": dict(
            fn=lambda: ops.lut_build(res, books, sqn),
            plain=lambda: adc.build_lut_batch(cbk, res),
            lib=lambda: torch.cdist(res3.transpose(0, 1), books).square_(),
            nbytes=a_bytes, nops=a_ops, err=err_a),
        "lut_build_q": dict(
            fn=lambda: ops.lut_build_q(res, books, sqn),
            plain=lambda: adc.quantize_lut(adc.build_lut_batch(cbk, res)),
            lib=None, nbytes=b_bytes, nops=b_ops, err=err_b),
        "pq_scan_dc": dict(
            fn=lambda: ops.pq_scan_dc(lut, codes, sizes),
            plain=lambda: adc.adc_distances(lut, codes, sizes),
            lib=None,
            nbytes=t * M * CB * 4 + valid * M * codes.element_size()
            + t * 4 + t * c * 4,
            nops=valid * M, err=errs["pq_scan_dc"]),
        "pq_scan_dc_q": dict(
            fn=lambda: ops.pq_scan_dc(q, codes, sizes),
            plain=lambda: adc.adc_distances_quantized(q, codes, sizes),
            lib=None,
            nbytes=t * M * CB + 2 * t * M * 4
            + valid * M * codes.element_size() + t * 4 + t * c * 4,
            nops=valid * M * 2 + t * M, err=errs["pq_scan_dc_q"]),
    }
    by_slot = {
        "pq_scan_dc": (lambda: ops.pq_scan_dc(lut, slot_codes, slot_sizes,
                                              slots=slots),
                       lambda: adc.adc_distances(lut, *ops.gather_slots(
                           slot_codes, None, slot_sizes, slots)[::2])),
        "pq_scan_dc_q": (lambda: ops.pq_scan_dc(q, slot_codes, slot_sizes,
                                                slots=slots),
                         lambda: adc.adc_distances_quantized(
                             q, *ops.gather_slots(slot_codes, None,
                                                  slot_sizes, slots)[::2])),
    }
    out = []
    for name, r in rows.items():
        ms = event_ms(r["fn"], reps=20, queued=True)
        plain_ms = event_ms(r["plain"], reps=5, warm=1, queued=True)
        lib_ms = (event_ms(r["lib"], reps=20, queued=True) if r["lib"]
                  else None)
        b_ms, b_by = bound_ms(r["nbytes"], r["nops"])
        src, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["err"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "bytes": r["nbytes"], "ops": r["nops"],
                    "shape": {"T": t, "M": M, "CB": CB, "dsub": dsub, "C": c,
                              "valid_rows": valid}})
        log(f"  {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'})")
        if name not in by_slot:
            continue
        fn, plain = by_slot[name]
        # the dense row's bytes, and the slots
        nbytes = r["nbytes"] + t * 4
        ms = event_ms(fn, reps=20, queued=True)
        plain_ms = event_ms(plain, reps=5, warm=1, queued=True)
        b_ms, b_by = bound_ms(nbytes, r["nops"])
        out[-1]["by_slot"] = {
            "launches": slot_launches[name], "max_abs_err": slot_errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "bytes": nbytes,
            "ops": r["nops"],
            "shape": {"T": t, "P": slot_codes.shape[0], "M": M, "CB": CB,
                      "dsub": dsub, "C": c, "valid_rows": valid}}
        log(f"  {name} by slot: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{ms / b_ms:.2f}x; plain on the copy {plain_ms:.4f} ms); "
            f"T={t} over P={slot_codes.shape[0]} slots, "
            f"{slot_launches[name]} launches on the local path")
    return out


def lut_at_sharded_step(ops, ref, adc, captured) -> dict:
    """A and B, each on the inputs of its first launch in the sharded path
    (the step's S x T residuals): check (both kernels on those residuals,
    B against quantize_lut of A), time, bound, plain time and, for A,
    torch.cdist.  Returns {name: entry for that kernel's row}."""
    from repro_torch.core.pq import PQCodebook
    out = {}
    for name in ("lut_build", "lut_build_q"):
        res, books, sqn = captured[name]
        t, dsub = res.shape[0], books.shape[2]
        quant = name == "lut_build_q"
        _, _, err_a, err_b = check_lut(ops, ref, adc, res, books, sqn,
                                       f"sharded step ({name}'s) T={t}",
                                       chunk=QUERY_CHUNK * NPROBE)
        cbk = PQCodebook(books, sqn)
        res3 = res.view(t, M, dsub)
        nbytes, nops = lut_bytes_ops(t, M, CB, dsub, quant)
        if quant:
            fn, plain, lib = (
                lambda: ops.lut_build_q(res, books, sqn),
                lambda: adc.quantize_lut(adc.build_lut_batch(cbk, res)),
                None)
        else:
            fn, plain, lib = (
                lambda: ops.lut_build(res, books, sqn),
                lambda: adc.build_lut_batch(cbk, res),
                lambda: torch.cdist(res3.transpose(0, 1), books).square_())
        ms = event_ms(fn, reps=20, queued=True)
        plain_ms = event_ms(plain, reps=5, warm=1, queued=True)
        lib_ms = event_ms(lib, reps=20, queued=True) if lib else None
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"  {name} at the sharded step: {ms:.4f} ms (bound {b_ms:.4f} "
            f"ms by {b_by}, {ms / b_ms:.2f}x; plain {plain_ms:.4f} ms, "
            f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'});"
            f" T={t}")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "max_abs_err": err_b if quant else err_a,
                     "bytes": nbytes, "ops": nops,
                     "shape": {"T": t, "M": M, "CB": CB, "dsub": dsub}}
    return out


def phase_breakdown(ops, index, clusters, q, dt: str) -> dict:
    """Device time of each phase of one query chunk, each phase timed
    alone with CUDA events on the chunk's own intermediates (the steps of
    ``core.search._search_chunk``: DC by slot, no gather)."""
    from repro_torch.core.search import cluster_locate
    qc = q.shape[0]
    probes = cluster_locate(q, index.centroids, NPROBE, block=QUERY_CHUNK)[0]
    flat = probes.reshape(-1)
    res = (q[:, None, :] - index.centroids[probes]).reshape(qc * NPROBE, -1)
    cb = index.codebook
    lc = ops.lut_build_q if dt == "uint8" else ops.lut_build
    lut = lc(res, cb.codebooks, cb.sqnorms)
    slots = flat.int()
    dists = ops.pq_scan_dc(lut, clusters.codes, clusters.sizes, slots=slots)
    cmax = clusters.cmax

    def ts():
        # dc_ts's TS: top-k over the chunk's distances, then each
        # winner's id by (probe, row) from the padded clusters
        d, pos = torch.topk(dists.reshape(qc, -1), K, dim=-1,
                            largest=False, sorted=True)
        row = probes.gather(1, pos // cmax) * cmax + pos % cmax
        return d, torch.take(clusters.ids, row)

    phases = {
        "CL (GEMM + top-nprobe)": lambda: cluster_locate(
            q, index.centroids, NPROBE, block=QUERY_CHUNK),
        "RC (residuals)": lambda: (q[:, None, :]
                                   - index.centroids[probes]).reshape(
                                       qc * NPROBE, -1),
        "LC kernel": lambda: lc(res, cb.codebooks, cb.sqnorms),
        "DC kernel (by slot)": lambda: ops.pq_scan_dc(
            lut, clusters.codes, clusters.sizes, slots=slots),
        "TS (torch.topk + ids)": ts,
    }
    return {name: event_ms(fn, reps=10, queued=True)
            for name, fn in phases.items()}


# ---------------------------------------------------------------------------
# The sharded path
# ---------------------------------------------------------------------------

def sharded_path(ops, index, queries, local, rec_local, gt, pool, trace,
                 n: int, seed: int):
    """Drive DistributedEngine (f32 and uint8) over the 10,000 queries and
    ShardedEngine behind ServingRuntime, cache off and on.  Checks every
    result against the local path or a direct search.  Returns the two
    engines, the inputs of each fused kernel's first launch, each
    engine's (wall s, steps, host s per phase) over the 10,000 queries,
    the sample probes the engines' heat came from, and each engine's
    (dists, ids, steps) of its first MESH_BATCHES batches."""
    from repro_torch.core.adc import QuantizedLUT
    from repro_torch.core.search import cluster_locate, recall_at_k
    from repro_torch.core.sharded_search import (CL_BLOCK, DistributedEngine,
                                                 EngineConfig)
    from repro_torch.data import make_query_stream
    from repro_torch.runtime import (HeatAwareAdmission, HotClusterLUTCache,
                                     OnlineHeatEstimator, ServingConfig,
                                     ServingRuntime, ShardedEngine)

    captured = {}
    launch, lc_launch, lcq_launch = (ops.pq_scan_topk, ops.lut_build,
                                     ops.lut_build_q)

    def capture(lut, codes, ids, sizes, k, **kw):
        name = ("pq_scan_topk_q" if isinstance(lut, QuantizedLUT)
                else "pq_scan_topk")
        captured.setdefault(name, (lut, codes, ids, sizes, k,
                                   kw.get("slots")))
        return launch(lut, codes, ids, sizes, k, **kw)

    def capture_lc(residuals, codebooks, sqnorms):
        captured.setdefault("lut_build", (residuals, codebooks, sqnorms))
        return lc_launch(residuals, codebooks, sqnorms)

    def capture_lcq(residuals, codebooks, sqnorms):
        captured.setdefault("lut_build_q", (residuals, codebooks, sqnorms))
        return lcq_launch(residuals, codebooks, sqnorms)

    # record each kernel's first inputs; the wrapped launches count as ever
    ops.pq_scan_topk, ops.lut_build, ops.lut_build_q = (capture, capture_lc,
                                                        capture_lcq)
    try:
        t0 = time.perf_counter()
        sample = torch.cat([
            cluster_locate(queries[s:s + CL_BLOCK], index.centroids, NPROBE,
                           block=CL_BLOCK)[0]
            for s in range(0, len(queries), CL_BLOCK)]).cpu().numpy()
        log(f"  heat: CL of the {len(queries)} queries, "
            f"{time.perf_counter() - t0:.2f} s")
        dup = int(CFG.dup_budget_frac * n * (M + 4))
        engines = {}
        for dt in ("f32", "uint8"):
            cfg = EngineConfig(n_shards=N_SHARDS, nprobe=NPROBE, k=K,
                               split_max=SPLIT_MAX, dup_budget_bytes=dup,
                               tasks_per_shard=TASKS_PER_SHARD,
                               lut_dtype=dt)
            eng, secs = sync_time(lambda: DistributedEngine(index, cfg,
                                                            sample))
            lay, sx = eng.layout, eng.sindex
            reps = sum(i.replica > 0 for i in lay.instances)
            nbytes = sum(x.numel() * x.element_size()
                         for x in (sx.codes, sx.ids, sx.sizes))
            log(f"  DistributedEngine lut={dt}: {secs:.2f} s (host layout "
                f"{eng.phase_s['layout']:.2f} s, materialize_shards "
                f"{eng.phase_s['materialize']:.2f} s); {len(lay.instances)} "
                f"instances ({reps} duplicates, budget {dup} B) on "
                f"{N_SHARDS} shards x {sx.slots} slots x cpart {sx.cpart}, "
                f"{nbytes / 2**20:.1f} MiB; predicted imbalance "
                f"{lay.stats(eng.latency)['imbalance']:.4f}")
            engines[dt] = eng

        runs, firsts = {}, {}
        for dt, eng in engines.items():
            eng.phase_s.clear()
            outs, wall, rounds = [], 0.0, 0
            for b in range(0, len(queries), SHARD_BATCH):
                (d, i, info), secs = sync_time(
                    lambda: eng.search(queries[b:b + SHARD_BATCH]))
                outs.append((d, i, info["rounds"]))
                wall += secs
                rounds += info["rounds"]
            d = np.concatenate([o[0] for o in outs])
            i = np.concatenate([o[1] for o in outs])
            check(d.shape == (len(queries), K) and np.isfinite(d).all()
                  and (i >= 0).all(), f"sharded {dt}: bad results")
            ld, li = (x.cpu().numpy() for x in local[dt])
            check(np.allclose(d, ld, rtol=RTOL, atol=ATOL),
                  f"sharded {dt}: distances differ from the local path")
            bad = tie_diff_rows(d, i, ld, li, RTOL, ATOL)
            check(bad == 0, f"sharded {dt}: ids differ from the local path "
                            f"on {bad} queries beyond k-th-place ties")
            rec = recall_at_k(torch.from_numpy(i[:N_RECALL]).cuda(), gt)
            check(abs(rec - rec_local[dt]) <= 0.001,
                  f"sharded {dt}: recall {rec} vs local {rec_local[dt]}")
            ph = eng.phase_s
            log(f"  sharded lut={dt}: {len(queries)} queries in "
                f"{len(outs)} batches of {SHARD_BATCH}, {wall:.2f} s "
                f"({len(queries) / wall:.1f} QPS), {rounds} steps; host s: "
                + ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
                + f"; distances equal to the local path's on "
                f"{float(np.mean(d == ld)):.4f} of entries, ids agree "
                f"(ties allowed), recall@{K} {rec:.4f} (local "
                f"{rec_local[dt]:.4f})")
            runs[dt] = (wall, rounds, dict(ph))
            firsts[dt] = outs[:MESH_BATCHES]

        eng = engines["f32"]
        eng.tasks_controller = eng.make_tasks_controller()
        zipf = make_query_stream(pool, N_SERVE, qps=2000.0, skew=1.1,
                                 seed=seed + 1)
        for label, tr in (("no cache, Poisson trace", trace),
                          ("LUT cache + heat, Zipf 1.1 trace", zipf)):
            cache = None
            if tr is zipf:
                est = OnlineHeatEstimator(index.nlist, seed=eng.heat)
                cache = HotClusterLUTCache(capacity=8192, lut_dtype="f32",
                                           admission=HeatAwareAdmission(est))
                eng.heat_estimator, eng.lut_cache = est, cache
            rt = ServingRuntime(ShardedEngine(eng), ServingConfig(
                buckets=(1, 2, 4, 8, 16, 32)))
            rt.warmup(D)
            eng.phase_s.clear()
            reqs = rt.run_stream(tr)
            served_s = dict(eng.phase_s)
            # the stream's own cache counts, before the direct searches
            # below look up (and hit) every key again
            hit = (f", LUT cache hit rate {cache.stats.hit_rate:.4f} "
                   f"({cache.stats.hits} hits, {len(cache)} entries)"
                   if cache is not None else "")
            check(all(r.done for r in reqs), f"sharded serving ({label}): "
                                             f"unserved requests")
            qs = np.stack([r.query for r in reqs])
            sd = np.stack([r.dists for r in reqs])
            si = np.stack([r.ids for r in reqs])
            outs = {"on" if cache else "off": eng.search(qs)}
            if cache is not None:
                eng.lut_cache = None
                outs["off"] = eng.search(qs)
                eng.lut_cache = cache
            for key, (dd, di, _) in outs.items():
                check(np.array_equal(sd, dd), f"sharded serving ({label}): "
                      f"served distances differ from a direct search with "
                      f"the cache {key}")
                bad = tie_diff_rows(sd, si, dd, di, 0.0, 0.0)
                check(bad == 0, f"sharded serving ({label}): ids differ on "
                                f"{bad} requests from a direct search with "
                                f"the cache {key}")
            m = rt.metrics()
            log(f"  ShardedEngine serving ({label}): {m['requests']} "
                f"requests in {m['batches']} batches: p50 "
                f"{m['p50_ms']:.3f} ms, p99 {m['p99_ms']:.3f} ms, QPS "
                f"{m['qps']:.1f}, occupancy {m['avg_batch_occupancy']:.3f}"
                f"{hit}; served == direct search, cache "
                + ("on and off" if cache is not None else "off")
                + "; engine host s over the stream: "
                + ", ".join(f"{k} {v:.3f}" for k, v in served_s.items()))
        eng.lut_cache = eng.heat_estimator = eng.tasks_controller = None
    finally:
        ops.pq_scan_topk, ops.lut_build, ops.lut_build_q = (launch, lc_launch,
                                                            lcq_launch)
    return engines, captured, runs, sample, firsts


def sharded_step_time(engines, runs, queries) -> None:
    """Time of one step of the first 1,000-query batch (RC, LC and the
    fused kernel reading the codes by slot), CUDA events, as the step runs
    (host dispatch included) and queued (the device's work alone), beside
    the host seconds the same batch's phases took."""
    from repro_torch.core.sharded_search import run_shards_vmap
    for dt, eng in engines.items():
        qb = queries[:SHARD_BATCH]
        sched = eng.schedule(eng.locate(qb))
        eng.carry = []
        qidx = torch.from_numpy(sched.query_idx).cuda()
        sidx = torch.from_numpy(sched.slot_idx).cuda()
        def step():
            return run_shards_vmap(eng.sindex, qidx, sidx, qb, k=K,
                                   quantize=dt == "uint8")
        step_ms = event_ms(step, reps=5)
        device_ms = event_ms(step, reps=5, queued=True)
        wall, rounds, _ = runs[dt]
        busy = rounds * step_ms / 1e3
        log(f"  sharded lut={dt}: one step ({int(sched.n_tasks.sum())} "
            f"tasks of {sched.query_idx.size}) {step_ms:.3f} ms (CUDA "
            f"events), {device_ms:.3f} ms of device work (queued); "
            f"{rounds} steps ~{busy:.3f} s of the {wall:.2f} s run, idle "
            f"share ~{max(0.0, 1 - busy / wall):.3f}")


# ---------------------------------------------------------------------------
# The shard mesh: one program per shard
# ---------------------------------------------------------------------------

MESH_BATCHES = 2               # of the 10 batches of 1,000, per engine, mode
MESH_FLUSH_TASKS = 256         # the flush batch's task-table width


def count_dc_forms(ops, forms: dict):
    """Wrap DC (C, D, C-bf16) so that ``forms["dense"]`` and
    ``forms["slots"]`` count each kernel's launches by form.  The wrapped
    calls launch and count as before.  Returns a function that restores
    the wrapper."""
    orig = ops.pq_scan_dc
    for form in ("dense", "slots"):
        forms[form] = {"pq_scan_dc" + sfx: 0
                       for sfx in ops.KIND_SUFFIX.values()}

    def wrapped(lut, codes, sizes=None, **kw):
        name = "pq_scan_dc" + ops.KIND_SUFFIX[ops.table_kind(lut)]
        forms["dense" if kw.get("slots") is None else "slots"][name] += 1
        return orig(lut, codes, sizes, **kw)

    ops.pq_scan_dc = wrapped

    def restore():
        ops.pq_scan_dc = orig
    return restore


def record_streams(ops, seen: list):
    """Wrap LC (A, B) and the fused DC+TS (E, F) so that each call appends
    (kernel, the CUDA stream current where it was called) to ``seen``.
    The wrapped calls launch and count as before.  Returns a function
    that restores the wrappers."""
    from repro_torch.core.adc import QuantizedLUT
    names = ("lut_build", "lut_build_q", "pq_scan_topk")
    orig = {n: getattr(ops, n) for n in names}

    def wrap(name):
        def wrapped(*args, **kw):
            q = name == "pq_scan_topk" and isinstance(args[0], QuantizedLUT)
            seen.append((name + ("_q" if q else ""),
                         torch.cuda.current_stream().cuda_stream))
            return orig[name](*args, **kw)
        return wrapped

    for name in names:
        setattr(ops, name, wrap(name))

    def restore():
        for name, fn in orig.items():
            setattr(ops, name, fn)
    return restore


def mesh_path(ops, index, queries, engines, sample, firsts) -> tuple:
    """5b: DistributedEngine(mesh=make_shard_mesh(64, devices=[cuda:0] *
    64)) at f32 and uint8 beside the sharded path's flat engines (the same
    config and sample probes, so the same layout): MESH_BATCHES batches
    of 1,000 queries with the LUT cache off, the same batches with a
    cache on the mesh engine (holding one batch's LUTs), the first twice
    (the second time all hits), each held to the flat engine's uncached
    results of the same batch in the sharded path (``firsts``), then a
    batch at MESH_FLUSH_TASKS tasks a shard (flush rounds) held to the
    flat engine's; every mesh result == the flat engine's bit for bit.
    Each mesh search launches LC (cache off) and E/F once per entry and
    step, each on its entry's stream, in entry order.  Then one step of
    the first batch, mesh and flat, timed by CUDA events.  Returns (run
    record, the mesh searches' launch counts, the per-entry launches
    captured by capture_launches in the cache-off searches)."""
    from repro_torch.core.sharded_search import (DistributedEngine,
                                                 run_shards_vmap)
    from repro_torch.launch import make_shard_mesh
    from repro_torch.runtime import (HotClusterLUTCache,
                                     TasksPerShardController)
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_shard_mesh(N_SHARDS, devices=[card] * N_SHARDS)
    streams = [s.cuda_stream for s in mesh.streams]
    check(len(set(streams)) == N_SHARDS
          and torch.cuda.current_stream(card).cuda_stream not in streams,
          "mesh: the entries do not own a stream each")
    log(f"  mesh: {mesh.size} entries, all on {card} (the smoke's contract "
        f"is one card), one CUDA stream each")
    launches = {name: 0 for name in KERNELS}
    seen, label = {}, ["mesh"]
    run = {"entries": mesh.size, "device": str(card), "runs": [],
           "step": {}}
    for dt in ("f32", "uint8"):
        flat = engines[dt]
        lc, ef = (("lut_build_q", "pq_scan_topk_q") if dt == "uint8"
                  else ("lut_build", "pq_scan_topk"))
        eng, secs = sync_time(lambda: DistributedEngine(index, flat.cfg,
                                                        sample, mesh=mesh))
        check([dataclasses.astuple(i) for i in eng.layout.instances]
              == [dataclasses.astuple(i) for i in flat.layout.instances]
              and np.array_equal(eng.layout.shard_of, flat.layout.shard_of)
              and torch.equal(eng.sindex.codes, flat.sindex.codes),
              f"mesh {dt}: the layout differs from the flat engine's")
        check(all(p.data_ptr() == eng.sindex.codes[s].data_ptr()
                  for s, p in enumerate(eng._shards[0])),
              f"mesh {dt}: entries on the engine's card hold copies")
        log(f"  mesh engine lut={dt}: built in {secs:.2f} s, the same "
            f"layout as the flat engine's, entries' shards are views")
        # the cache keys on the exact query and holds one batch's LUTs, so
        # only the repeat of batch 0, right after it, hits (all of it)
        modes = [("cache off", False, None, b) for b in range(MESH_BATCHES)]
        modes += [("cache on", True, None, b)
                  for b in (0, *range(MESH_BATCHES))]
        modes += [("flush", False, MESH_FLUSH_TASKS, MESH_BATCHES)]
        rec: list = []
        cached_batches: set = set()
        for mode, cached, tps, b in modes:
            if cached and eng.lut_cache is None:
                eng.lut_cache = HotClusterLUTCache(
                    capacity=SHARD_BATCH * NPROBE, lut_dtype=dt)
            elif not cached:
                eng.lut_cache = None
            flat.tasks_controller = eng.tasks_controller = None
            if tps is not None:
                flat.tasks_controller, eng.tasks_controller = (
                    TasksPerShardController(N_SHARDS, NPROBE, cap=tps)
                    for _ in range(2))
            qb = queries[b * SHARD_BATCH:(b + 1) * SHARD_BATCH]
            if tps is None:     # the flat engine's, from the sharded path
                (fd, fi, f_rounds), f_s = firsts[dt][b], None
            else:
                (fd, fi, finfo), f_s = sync_time(lambda: flat.search(qb))
                f_rounds = finfo["rounds"]
            misses = eng.lut_cache.stats.misses if cached else 0
            rec.clear()
            restore_streams = record_streams(ops, rec)
            restore = (capture_launches(ops, seen, label)
                       if not cached and tps is None else (lambda: None))
            eng.phase_s.clear()
            try:
                before = dict(ops.launches)
                (md, mi, minfo), m_s = sync_time(lambda: eng.search(qb))
                delta = {k: ops.launches[k] - before[k] for k in KERNELS}
            finally:
                restore()
                restore_streams()
            for k, v in delta.items():
                launches[k] += v
            rounds = minfo["rounds"]
            where = f"mesh {dt} {mode} batch {b}"
            check(np.array_equal(md, fd) and np.array_equal(mi, fi)
                  and rounds == f_rounds,
                  f"{where}: results differ from the flat engine's")
            check(rounds > 1 if tps else True,
                  f"{where}: no deferred tasks at {tps} tasks a shard")
            want = streams * rounds
            check(delta[ef] == N_SHARDS * rounds
                  and [st for n, st in rec if n == ef] == want,
                  f"{where}: {ef} launched {delta[ef]} times for "
                  f"{N_SHARDS} entries x {rounds} steps, or not on the "
                  f"entries' streams")
            if cached:
                # one bank build a search, for its misses; a repeat has none
                misses = eng.lut_cache.stats.misses - misses
                check((misses == 0) == (b in cached_batches)
                      and delta[lc] == (1 if misses else 0),
                      f"{where}: {misses} cache misses, {lc} launched "
                      f"{delta[lc]} times")
                cached_batches.add(b)
            else:
                check(delta[lc] == N_SHARDS * rounds
                      and [st for n, st in rec if n == lc] == want,
                      f"{where}: {lc} launched {delta[lc]} times for "
                      f"{N_SHARDS} x {rounds}, or not on the entries' "
                      f"streams")
            hit = (f", hit rate {eng.lut_cache.stats.hit_rate:.4f}"
                   if cached else "")
            flat_s = ("the sharded path's" if f_s is None
                      else f"{f_s:.3f} s")
            log(f"  {where}: == flat bit for bit, {rounds} steps, {lc} "
                f"{delta[lc]} / {ef} {delta[ef]} launches on the entries' "
                f"streams; {m_s:.3f} s (flat {flat_s}), mesh step host "
                f"s {eng.phase_s.get('step', 0.0):.3f}{hit}")
            run["runs"].append({"lut": dt, "mode": mode, "batch": b,
                                "rounds": rounds, "mesh_s": m_s,
                                "flat_s": f_s, "launches": delta})
        eng.lut_cache = None
        flat.tasks_controller = eng.tasks_controller = None
        # one step of the first batch, mesh and flat, after the counts
        qb = queries[:SHARD_BATCH]
        sched = flat.schedule(flat.locate(qb))
        flat.carry = []
        qidx = torch.from_numpy(sched.query_idx).to(card)
        sidx = torch.from_numpy(sched.slot_idx).to(card)
        steps = {
            "flat": lambda: run_shards_vmap(flat.sindex, qidx, sidx, qb, k=K,
                                            quantize=dt == "uint8"),
            "mesh": lambda: eng._step(*eng._shards, qidx, sidx, qb,
                                      eng.sindex.centroids)}
        a, c = steps["flat"](), steps["mesh"]()
        check(all(torch.equal(x, y) for x, y in zip(a, c)),
              f"mesh {dt}: one step differs from the flat step")
        timed = {}
        for name in ("flat", "mesh", "mesh", "flat"):
            ms = event_ms(steps[name], reps=3)
            dev = event_ms(steps[name], reps=3, queued=True)
            timed.setdefault(name, []).append((ms, dev))
        for name, pairs in timed.items():
            ms = float(np.mean([p[0] for p in pairs]))
            dev = float(np.mean([p[1] for p in pairs]))
            run["step"][f"{dt} {name}"] = {"ms": ms, "device_ms": dev,
                                           "busy_share": dev / ms}
            log(f"  one step lut={dt} {name}: {ms:.3f} ms (CUDA events), "
                f"{dev:.3f} ms of device work (queued), busy share "
                f"~{dev / ms:.3f}; {int(sched.n_tasks.sum())} tasks")
        del eng, a, c, steps
        torch.cuda.empty_cache()
    mesh.close()
    run["launches"] = launches
    return run, launches, seen


def mesh_entry_report(ops, ref, adc, seen: dict) -> dict:
    """A, B, E and F on the inputs of their last captured launch in the
    mesh searches (one entry's: T = the task table's width, E/F by slot
    over one shard's slots): held to plain (check_captured), timed by
    CUDA events beside the bound and the plain time."""
    from repro_torch.core.pq import PQCodebook
    from repro_torch.util import next_pow2
    out = {}
    for key, (label, args) in sorted(seen.items(), key=str):
        name = key[0]
        err = next(iter(check_captured(ops, ref, adc, {key: (label, args)},
                                       phase="mesh entry").values()))
        if name in ("lut_build", "lut_build_q"):
            res, books, sqn = args
            t, dsub = res.shape[0], books.shape[2]
            quant = name == "lut_build_q"
            nbytes, nops = lut_bytes_ops(t, M, CB, dsub, quant)
            cbk = PQCodebook(books, sqn)
            fn = lambda: getattr(ops, name)(res, books, sqn)  # noqa: E731
            plain = ((lambda: adc.quantize_lut(adc.build_lut_batch(cbk, res)))
                     if quant else (lambda: adc.build_lut_batch(cbk, res)))
            shape = {"T": t, "M": M, "CB": CB, "dsub": dsub}
            max_err = err["lut_build_q_counts" if quant else "lut_build"]
        else:
            lut, codes, ids, sizes, slots = args
            k = key[4]
            k_pad = next_pow2(max(k, 8))
            nbytes, nops, shape = fused_bytes_ops(
                codes, sizes, k_pad, name.endswith("_q"), slots)
            fn = lambda: ops.pq_scan_topk(lut, codes, ids, sizes, k,  # noqa
                                          slots=slots)
            plain = lambda: ops.pq_scan_topk_plain(  # noqa: E731
                lut, codes, ids, sizes, k_pad, slots=slots)
            max_err = err[name]
        ms = event_ms(fn, reps=20, queued=True)
        plain_ms = event_ms(plain, reps=3, warm=1, queued=True)
        b_ms, b_by = bound_ms(nbytes, nops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": max_err,
                     "bytes": nbytes, "ops": nops, "shape": shape}
        log(f"  {name} at a mesh entry: {ms:.4f} ms (bound {b_ms:.4f} ms "
            f"by {b_by}, {ms / b_ms:.2f}x; plain {plain_ms:.4f} ms); "
            f"{shape}")
    return out


def save_launch(ops, captured, local_lc) -> None:
    """Write E's and F's first sharded launches to LAUNCH_FILE, for
    tools/torch_fused_topk_bench.py to replay: the residuals of the LC
    launch of the same step (the tool rebuilds the tables from them; here
    they are checked to come out bit for bit as the step's), the slots,
    and the rows of the slots the tasks read (the shard tensors are ~7
    GiB, mostly slots no task of this step reads).  ``local_lc``, the LC
    inputs of the local path's first chunk, goes in as ``lut_local`` for
    tools/torch_lut_build_bench.py."""
    res, books, sqn = local_lc
    out = {"lut_local": {"residuals": res.cpu(), "books": books.cpu(),
                         "sqn": sqn.cpu()}}
    for name, lc_name, lc in (("pq_scan_topk", "lut_build", ops.lut_build),
                              ("pq_scan_topk_q", "lut_build_q",
                               ops.lut_build_q)):
        lut, codes, ids, sizes, k, slots = captured[name]
        res, books, sqn = captured[lc_name]
        again = lc(res, books, sqn)
        pairs = zip(lut, again) if isinstance(lut, tuple) else [(lut, again)]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{lc_name}: the step's tables do not come back from its "
              f"residuals bit for bit")
        s = slots.long()
        used = torch.unique(s[(s >= 0) & (s < codes.shape[0])])
        out[name] = {"k": k, "P": codes.shape[0], "slots": slots.cpu(),
                     "residuals": res.cpu(), "books": books.cpu(),
                     "sqn": sqn.cpu(), "used": used.cpu(),
                     "codes": codes[used].cpu(), "ids": ids[used].cpu(),
                     "sizes": sizes[used].cpu()}
    LAUNCH_FILE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, LAUNCH_FILE)
    log(f"  E's and F's launches saved to {LAUNCH_FILE.relative_to(ROOT)} "
        f"({LAUNCH_FILE.stat().st_size / 2**20:.1f} MiB)")


def fused_bytes_ops(codes, sizes, k_pad: int, quant: bool, slots=None,
                    bf16: bool = False):
    """E/F's bound inputs (E-bf16's with ``bf16``: the table at 2 B an
    entry, one rounding a row): bytes (non-empty tasks' tables, the codes of
    the valid rows, winners' ids, slots, sizes and outputs) and
    operations, with the shape counts they come from.  Dense form (no
    ``slots``): every task's rows are read.  Slot form: tasks that share a
    slot read its rows in place, so each distinct slot's valid rows and
    size count once; tables, winners and outputs stay per task."""
    p, c = codes.shape[0], codes.shape[1]
    if slots is None:
        rows = sizes.clamp(0, c)
        read, index_bytes = rows, 4 * p
    else:
        s = slots.long()
        ok = (s >= 0) & (s < p)
        rows = torch.where(ok, sizes[s.clamp(0, p - 1)], 0).clamp(0, c)
        read = sizes[torch.unique(s[ok])].clamp(0, c)
        index_bytes = 4 * s.shape[0] + 4 * read.shape[0]
    t = rows.shape[0]
    nonempty = int((rows > 0).sum())
    valid = int(rows.sum())
    code_rows = int(read.sum())
    # only the winners' ids are read: min(valid rows, k_pad) per task
    winners = int(rows.clamp(max=k_pad).sum())
    table = (M * CB + 8 * M if quant else M * CB * 2 if bf16
             else M * CB * 4)
    nbytes = (nonempty * table + code_rows * M * codes.element_size()
              + winners * 4 + index_bytes + t * 8 * k_pad)
    nops = (valid * M * (2 if quant else 1) + (nonempty * M if quant else 0)
            + (valid if bf16 else 0))
    return nbytes, nops, {"T": t, "M": M, "CB": CB, "C": c, "k_pad": k_pad,
                          "nonempty_tasks": nonempty, "valid_rows": valid,
                          "code_rows_read": code_rows,
                          "slots_read": int(read.shape[0]),
                          "winner_rows": winners}


def fused_report(ops, captured, launches) -> list:
    """E and F on the inputs of their first launch in the sharded path,
    in both forms: by slot, as the step launches them, and dense on the
    gathered inputs (the form of the TPU kernel and of the earlier
    measurements), each beside its own bound.  Check, time, bound, plain
    time, the gather the step no longer makes, and the unfused pair (C or
    D, then torch.topk, on the gathered inputs) as the yardstick; no
    single library call computes them."""
    from repro_torch.core.topk import topk_smallest
    from repro_torch.util import next_pow2
    rows = []
    for name in ("pq_scan_topk", "pq_scan_topk_q"):
        lut, codes, ids, sizes, k, slots = captured[name]
        check(slots is not None, f"{name}: the step did not pass slots")
        t, c = slots.shape[0], codes.shape[1]
        k_pad = next_pow2(max(k, 8))
        where = f"sharded step T={t} C={c}"
        err = check_topk(ops, lut, codes, ids, sizes, k, where, slots)
        gathered = ops.gather_slots(codes, ids, sizes, slots)
        err = max(err, check_topk(ops, lut, *gathered, k, where))
        quant = name.endswith("_q")
        nbytes, nops, shape = fused_bytes_ops(codes, sizes, k_pad, quant,
                                              slots)
        dense_bytes, _, _ = fused_bytes_ops(gathered[0], gathered[2], k_pad,
                                            quant)
        ms = event_ms(lambda: ops.pq_scan_topk(lut, codes, ids, sizes, k,
                                               slots=slots), reps=20,
                      queued=True)
        dense_ms = event_ms(lambda: ops.pq_scan_topk(lut, *gathered, k),
                            reps=20, queued=True)
        gather_ms = event_ms(lambda: ops.gather_slots(codes, ids, sizes,
                                                      slots), reps=5,
                             queued=True)
        plain_ms = event_ms(lambda: ops.pq_scan_topk_plain(
            lut, codes, ids, sizes, k_pad, slots=slots), reps=3, warm=1,
            queued=True)
        pair_ms = event_ms(lambda: topk_smallest(
            ops.pq_scan_dc(lut, gathered[0], gathered[2]), gathered[1],
            k_pad), reps=20, queued=True)
        b_ms, b_by = bound_ms(nbytes, nops)
        dense_b_ms, _ = bound_ms(dense_bytes, nops)
        src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "dense_ms": dense_ms, "dense_bound_ms": dense_b_ms,
                     "gather_ms": gather_ms, "unfused_pair_ms": pair_ms,
                     "bytes": nbytes, "dense_bytes": dense_bytes,
                     "ops": nops, "shape": shape})
        log(f"  {name}: {ms:.4f} ms by slot (bound {b_ms:.4f} ms by {b_by}, "
            f"{ms / b_ms:.2f}x), {dense_ms:.4f} ms dense on gathered inputs "
            f"(bound {dense_b_ms:.4f} ms, {dense_ms / dense_b_ms:.2f}x); "
            f"plain {plain_ms:.4f} ms, unfused pair {pair_ms:.4f} ms, the "
            f"gather {gather_ms:.4f} ms, library none; T={t} "
            f"({shape['nonempty_tasks']} non-empty) C={c} k_pad={k_pad}, "
            f"{shape['valid_rows']} valid rows, {shape['code_rows_read']} "
            f"of them in {shape['slots_read']} distinct slots")
    return rows


def bf16_report(ops, adc, res, books, sqn, codes, ids, sizes,
                captured, by_slot) -> list:
    """The bf16-table kernels at fixed shapes, held to their plain
    versions, timed and bounded (the table at 2 B an entry): A-bf16 and
    C-bf16 on the main path's first chunk (E-bf16 checked there too, dense),
    A-bf16 on the sharded step's first LC residuals and E-bf16 on its first
    fused launch, by slot as the step launches it and dense on the
    gathered inputs, on that launch's table cast to bf16 (= A-bf16 of its
    residuals).  Library: ``torch.cdist`` squared, cast, for A-bf16; no one
    call computes C-bf16 or E-bf16.  ``launches`` are D1's, filled in by
    the caller.  ``by_slot`` (the padded clusters' codes and sizes, and the
    chunk's probes as slots): C-bf16 by slot is held to its plain version
    and to its dense launch on the copy."""
    from repro_torch.core.pq import PQCodebook
    from repro_torch.core.topk import topk_smallest
    from repro_torch.util import next_pow2
    t, c = codes.shape[0], codes.shape[1]
    dsub = books.shape[2]
    where = f"main path T={t} C={c}"
    lut, err_a = check_lut_bf16(ops, adc, res, books, sqn, where)
    err_c = check_scan(ops, adc.adc_distances, None, lut, None, codes, sizes,
                       where)["pq_scan_dc_bf16"]
    check_scan(ops, adc.adc_distances, None, lut, None, *by_slot[:2],
               f"{where} P={by_slot[0].shape[0]}", by_slot[2])
    check_topk(ops, lut, codes, ids, sizes, K, where)
    cbk = PQCodebook(books, sqn)
    valid = int(sizes.clamp(max=c).sum())

    def lc_row(r, b, q, err, chunk_where):
        n = r.shape[0]
        r3 = r.view(n, M, dsub)
        nbytes, nops = lut_bytes_ops(n, M, CB, dsub, False, bf16=True)
        ms = event_ms(lambda: ops.lut_build_bf16(r, b, q), reps=20,
                      queued=True)
        plain_ms = event_ms(lambda: adc.build_lut_batch(
            PQCodebook(b, q), r).to(torch.bfloat16), reps=5, warm=1,
            queued=True)
        lib_ms = event_ms(lambda: torch.cdist(r3.transpose(0, 1), b)
                          .square_().to(torch.bfloat16), reps=20, queued=True)
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"  lut_build_bf16 {chunk_where}: {ms:.4f} ms (bound {b_ms:.4f} "
            f"ms by {b_by}, {ms / b_ms:.2f}x; plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms); T={n}")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err,
                "bytes": nbytes, "ops": nops,
                "shape": {"T": n, "M": M, "CB": CB, "dsub": dsub}}

    rows = []
    a_row = lc_row(res, books, sqn, err_a, where)
    step_res, step_books, step_sqn = captured["lut_build"]
    _, err_step = check_lut_bf16(ops, adc, step_res, step_books, step_sqn,
                                 f"sharded step T={step_res.shape[0]}",
                                 chunk=QUERY_CHUNK * NPROBE)
    a_row["at_sharded_step"] = lc_row(step_res, step_books, step_sqn,
                                      err_step, "at the sharded step")
    rows.append(dict(name="lut_build_bf16", **a_row))

    c_bytes = (t * M * CB * 2 + valid * M * codes.element_size() + t * 4
               + t * c * 4)
    c_ops = valid * M + valid
    ms = event_ms(lambda: ops.pq_scan_dc(lut, codes, sizes), reps=20,
                  queued=True)
    plain_ms = event_ms(lambda: adc.adc_distances(lut, codes, sizes), reps=5,
                        warm=1, queued=True)
    b_ms, b_by = bound_ms(c_bytes, c_ops)
    log(f"  pq_scan_dc_bf16: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
        f"{ms / b_ms:.2f}x; plain {plain_ms:.4f} ms, library none); T={t} "
        f"C={c}")
    rows.append({"name": "pq_scan_dc_bf16", "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "max_abs_err": err_c, "bytes": c_bytes, "ops": c_ops,
                 "shape": {"T": t, "M": M, "CB": CB, "C": c,
                           "valid_rows": valid}})

    lut32, scodes, sids, ssizes, k, slots = captured["pq_scan_topk"]
    lut_h = lut32.to(torch.bfloat16)
    st, sc = slots.shape[0], scodes.shape[1]
    k_pad = next_pow2(max(k, 8))
    swhere = f"sharded step T={st} C={sc}"
    err = check_topk(ops, lut_h, scodes, sids, ssizes, k, swhere, slots)
    gathered = ops.gather_slots(scodes, sids, ssizes, slots)
    err = max(err, check_topk(ops, lut_h, *gathered, k, swhere))
    nbytes, nops, shape = fused_bytes_ops(scodes, ssizes, k_pad, False,
                                          slots, bf16=True)
    dense_bytes, _, _ = fused_bytes_ops(gathered[0], gathered[2], k_pad,
                                        False, bf16=True)
    ms = event_ms(lambda: ops.pq_scan_topk(lut_h, scodes, sids, ssizes, k,
                                           slots=slots), reps=20, queued=True)
    dense_ms = event_ms(lambda: ops.pq_scan_topk(lut_h, *gathered, k),
                        reps=20, queued=True)
    plain_ms = event_ms(lambda: ops.pq_scan_topk_plain(
        lut_h, scodes, sids, ssizes, k_pad, slots=slots), reps=3, warm=1,
        queued=True)
    pair_ms = event_ms(lambda: topk_smallest(
        ops.pq_scan_dc(lut_h, gathered[0], gathered[2]), gathered[1], k_pad),
        reps=20, queued=True)
    b_ms, b_by = bound_ms(nbytes, nops)
    dense_b_ms, _ = bound_ms(dense_bytes, nops)
    log(f"  pq_scan_topk_bf16: {ms:.4f} ms by slot (bound {b_ms:.4f} ms by "
        f"{b_by}, {ms / b_ms:.2f}x), {dense_ms:.4f} ms dense (bound "
        f"{dense_b_ms:.4f} ms); plain {plain_ms:.4f} ms, unfused pair "
        f"(C-bf16 + top-k) {pair_ms:.4f} ms, library none; {swhere}; "
        f"instance {ops.pq_scan_topk_instance(lut_h, scodes)}")
    rows.append({"name": "pq_scan_topk_bf16", "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None, "max_abs_err": err, "dense_ms": dense_ms,
                 "dense_bound_ms": dense_b_ms, "unfused_pair_ms": pair_ms,
                 "bytes": nbytes, "dense_bytes": dense_bytes, "ops": nops,
                 "shape": shape})
    for r in rows:
        src, replaces = BF16_KERNELS[r["name"]]
        r.update(route="cuda", source=src, replaces=replaces,
                 computes=BF16_COMPUTES, launches=0)
    return rows


# ---------------------------------------------------------------------------
# The service path: AnnService over the local and sharded engines
# ---------------------------------------------------------------------------

def served(reqs):
    """(queries, dists, ids) of served requests, stacked."""
    return (np.stack([r.query for r in reqs]), np.stack([r.dists for r in reqs]),
            np.stack([r.ids for r in reqs]))


def service_report(label: str, svc, secs: float, clock: str) -> dict:
    st = svc.stats()
    agg = st["aggregate"]
    caches = [m.get("lut_cache") for m in st["replicas"]]
    hit = agg.get("lut_hit_rate")
    # engine time per batch (host clock around search_batch, device work
    # included: results come back to the host), and the share of the
    # stream's span the replicas' engines were busy
    svc_s = [b.service_s for rep in svc.replicas
             for b in rep.runtime.stats.batches]
    engine_ms = float(np.mean(svc_s)) * 1e3
    busy = sum(svc_s) / (agg["requests"] / agg["qps"] * len(svc.replicas))
    # host seconds per engine phase, summed over the replicas (the cached
    # local engine and the sharded engine keep them; the uncached local
    # engine does not)
    phases: dict = {}
    for rep in svc.replicas:
        for k, v in getattr(rep.core, "phase_s", {}).items():
            phases[k] = phases.get(k, 0.0) + v
    log(f"  {label}, clock={clock}: {agg['requests']} requests in "
        f"{agg['batches']} batches: p50 {agg['p50_ms']:.3f} ms, p99 "
        f"{agg['p99_ms']:.3f} ms, QPS {agg['qps']:.1f}; engine "
        f"{engine_ms:.3f} ms a batch, engines busy {busy:.3f} of the span; "
        f"router "
        f"{st['router']['policy']} picks {st['router']['picks']}; LUT hit "
        f"rate {'none' if hit is None else f'{hit:.4f}'}"
        + ("" if caches[0] is None else
           f" ({sum(c['entries'] for c in caches)} entries, "
           f"{sum(c['bytes'] for c in caches) / 2**20:.1f} MiB)")
        + f"; retries {agg['retries']}; build {secs:.2f} s; engine host s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    return {"label": label, "clock": clock, "requests": agg["requests"],
            "batches": agg["batches"], "p50_ms": agg["p50_ms"],
            "p99_ms": agg["p99_ms"], "qps": agg["qps"],
            "picks": st["router"]["picks"], "lut_hit_rate": hit,
            "retries": agg["retries"], "build_s": secs,
            "engine_ms_per_batch": engine_ms, "engines_busy": busy,
            "engine_phase_s": phases}


def direct_wall_stream(rt, arrivals) -> list:
    """ServingRuntime on the wall clock, driven the way a direct user
    would: one caller thread submits each arrival when it is due and
    steps the runtime in between (a batch is served inline, so arrivals
    behind it wait, stamped when submitted)."""
    t0 = time.monotonic()
    reqs = []
    for t, q in arrivals:
        while True:
            now = time.monotonic() - t0
            rt.step(now)
            if now >= t:
                break
            ddl = rt.batcher.next_deadline()
            wake = t if ddl is None else min(t, ddl)
            time.sleep(max(0.0, wake - now))
        reqs.append(rt.submit(q, now))
        rt.step(now)
    while rt.batcher.depth:
        rt.step(time.monotonic() - t0, drain=True)
    return reqs


def service_path(handle, queries_np, results, rec_f32, gt, pool, trace,
                 direct_serving: dict, n: int, seed: int) -> list:
    """Drive AnnService (S1-S5) on the main path's index; hold every
    served result to a direct search.  ``results`` holds the local path's
    uncached search_ivfpq of all queries per LUT dtype (use_kernels=True);
    ``direct_serving`` the direct ServingRuntime's metrics per clock on
    ``trace``.  Returns one report per stream."""
    from repro_torch.core.search import SearchParams, recall_at_k
    from repro_torch.data import make_query_stream
    from repro_torch.service import AnnService, ServiceSpec

    base = dict(nprobe=NPROBE, k=K, buckets=SERVICE_BUCKETS)
    reports = []
    direct = {dt: tuple(x.cpu().numpy() for x in r)
              for dt, r in results.items()}
    row_of = {q.tobytes(): i for i, q in enumerate(queries_np)}

    def build(spec, **kw):
        svc, secs = sync_time(lambda: AnnService.build(spec, index=handle,
                                                       **kw))
        svc.warmup()
        for rep in svc.replicas:        # phase clocks: traffic only
            getattr(rep.core, "phase_s", {}).clear()
        return svc, secs

    def hold(label, reqs, want_d, want_i, rtol=0.0, atol=0.0):
        check(all(r.done for r in reqs), f"{label}: unserved requests")
        _, sd, si = served(reqs)
        check(np.allclose(sd, want_d, rtol=rtol, atol=atol) if rtol or atol
              else np.array_equal(sd, want_d),
              f"{label}: served distances differ from the direct search")
        bad = tie_diff_rows(sd, si, want_d, want_i, rtol, atol)
        check(bad == 0, f"{label}: ids differ on {bad} requests beyond "
                        f"k-th-place ties")

    def hold_direct(label, reqs, dt):
        """Bit for bit against the uncached search_ivfpq of the same
        queries (LC, DC and TS are per row, CL on a fixed block)."""
        rows = np.array([row_of[r.query.tobytes()] for r in reqs])
        hold(label, reqs, direct[dt][0][rows], direct[dt][1][rows])

    # S1: one local replica == search_ivfpq, bit for bit
    s1, secs = build(ServiceSpec(engine="local", replicas=1, **base))
    (d1, i1), t_s1 = sync_time(lambda: s1.search(queries_np))
    check(np.array_equal(d1, direct["f32"][0])
          and np.array_equal(i1, direct["f32"][1]),
          "S1: the 1-replica service differs from search_ivfpq")
    log(f"  S1 local, 1 replica: search of {len(queries_np)} queries "
        f"{t_s1 * 1e3:.1f} ms ({len(queries_np) / t_s1:.0f} QPS), equal to "
        f"search_ivfpq bit for bit; build {secs:.2f} s")
    s1.shutdown()

    # what the cache-aware router pays per request: CL of one query on a
    # CL_BLOCK-row block on the card, its probes back on the host
    from repro_torch.core.sharded_search import CL_BLOCK, locate_probes
    t0 = time.perf_counter()
    for q in queries_np[:64]:
        locate_probes(q[None], handle.centroids, NPROBE)
    probe_ms = (time.perf_counter() - t0) / 64 * 1e3
    log(f"  router probe: {probe_ms:.3f} ms a request (CL of one query on "
        f"a {CL_BLOCK}-row block, probes to the host; card idle)")
    reports.append({"label": "router probe", "ms_per_request": probe_ms})

    # S5: the direct serving runs' twin through the front door (one local
    # replica, no cache, the same Poisson trace), so what the service adds
    # (router, futures, executor thread) reads beside them
    for clock in ("virtual", "wall"):
        svc, secs = build(ServiceSpec(engine="local", replicas=1, **base))
        reqs = svc.stream(trace, clock=clock)
        hold_direct(f"S5 {clock}", reqs, "f32")
        r = service_report("S5 local x1 no cache, Poisson", svc, secs, clock)
        dm = direct_serving[clock]
        r["direct"] = {k: dm[k] for k in ("p50_ms", "p99_ms", "qps")}
        log(f"    direct ServingRuntime on the same trace, clock={clock}: "
            f"p50 {dm['p50_ms']:.3f} ms, p99 {dm['p99_ms']:.3f} ms, QPS "
            f"{dm['qps']:.1f}")
        reports.append(r)
        svc.shutdown()

    zipf = make_query_stream(pool, N_SERVE, qps=2000.0, skew=1.1,
                             seed=seed + 1)
    # S2 / S3: two local replicas, cache-aware router, the LUT cache;
    # S2-off: S2 with no cache, what the cache is measured against
    for name, dt, cap in (("S2", "f32", 1 << 30), ("S2-off", "f32", 0),
                          ("S3", "uint8", 1 << 28)):
        spec = ServiceSpec(engine="local", replicas=2, router="cache_aware",
                           lut_dtype=dt, cache_capacity_bytes=cap, **base)
        for clock in ("virtual", "wall"):
            svc, secs = build(spec)
            reqs = svc.stream(zipf, clock=clock)
            label = (f"{name} local x2 cache_aware lut={dt} cache "
                     f"{cap >> 20} MiB, Zipf 1.1")
            # reported before the direct searches below go through the cache
            reports.append(service_report(label, svc, secs, clock))
            hold_direct(f"{name} {clock}", reqs, dt)
            if dt == "uint8":
                # the service's own search (cache warm) too
                dd, di = svc.search(queries_np)
                check(np.array_equal(dd, direct[dt][0])
                      and np.array_equal(di, direct[dt][1]),
                      f"{name} {clock}: search differs from search_ivfpq")
            if dt == "uint8" and clock == "wall":
                rec = recall_at_k(torch.from_numpy(
                    di[:N_RECALL]).cuda(), gt)
                log(f"  S3 recall@{K} {rec:.4f} vs f32 {rec_f32:.4f} (drop "
                    f"{rec_f32 - rec:.4f})")
                check(rec_f32 - rec <= 0.01, "S3: uint8 recall drop > 0.01")
            svc.shutdown()

    # S4: two sharded replicas, least-queue router, Poisson, wall clock
    dup = int(CFG.dup_budget_frac * n * (M + 4))
    for dt in ("f32", "uint8"):
        spec = ServiceSpec(engine="sharded", replicas=2, router="least_queue",
                           n_shards=N_SHARDS, split_max=SPLIT_MAX,
                           dup_budget_bytes=dup,
                           tasks_per_shard=TASKS_PER_SHARD, lut_dtype=dt,
                           **base)
        svc, secs = build(spec, sample_queries=queries_np)
        reqs = svc.stream(trace, clock="wall")
        local = handle.search(served(reqs)[0], SearchParams(
            nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK, use_kernels=True,
            lut_dtype=dt))
        hold(f"S4 sharded lut={dt}", reqs, *local, RTOL, ATOL)
        reports.append(service_report(f"S4 sharded x2 least_queue lut={dt}, "
                                      f"Poisson", svc, secs, "wall"))
        svc.shutdown()
        del svc
        torch.cuda.empty_cache()
    return reports


# ---------------------------------------------------------------------------
# The mutation path: the live index behind the local and sharded engines
# ---------------------------------------------------------------------------

M1_ROUNDS, M1_NEW, M1_REUPSERT, M1_DELETE = 32, 1024, 256, 1024
S6_ROUNDS, S6_BATCH = 16, 256


class LiveSet:
    """The smoke's own model of the live index, kept apart from the code
    under test: which ids are live, and each id's vector as a corpus row
    plus an offset (every upserted vector is a corpus row + 1e-2)."""

    def __init__(self, points, n: int, capacity: int, seed: int):
        self.points = points                       # (N, D) on the card
        self.n = n
        self.alive = np.zeros(capacity, bool)
        self.alive[:n] = True
        self.src = np.arange(capacity) % n
        self.off = np.zeros(capacity, np.float32)
        self.next_id = n
        self.rng = np.random.default_rng(seed)

    def sample_live(self, count: int, originals: bool = False) -> np.ndarray:
        """``count`` distinct live ids, uniformly (the corpus's own ids
        only, with ``originals``)."""
        hi = self.n if originals else self.next_id
        out = np.zeros(0, np.int64)
        while len(out) < count:
            cand = self.rng.integers(0, hi, 2 * count)
            out = np.unique(np.concatenate([out, cand[self.alive[cand]]]))
        return self.rng.permutation(out)[:count]

    def vectors(self, src: np.ndarray) -> np.ndarray:
        rows = self.points[torch.from_numpy(src).cuda()]
        return rows.float().cpu().numpy() + np.float32(1e-2)

    def new_ids(self, count: int):
        """``count`` fresh ids (from N upward), each taking a random live
        corpus point's vector + 1e-2; recorded as live."""
        ids = np.arange(self.next_id, self.next_id + count)
        src = self.sample_live(count, originals=True)
        self.next_id += count
        self.upserted(ids, src)
        return ids, src

    def upserted(self, ids, src) -> None:
        self.alive[ids] = True
        self.src[ids] = src
        self.off[ids] = 1e-2

    def live_vectors(self):
        ids = np.nonzero(self.alive)[0]
        vecs = self.points[torch.from_numpy(self.src[ids]).cuda()].float()
        vecs += torch.from_numpy(self.off[ids]).cuda()[:, None]
        return ids, vecs

    def recall(self, found: np.ndarray, queries: torch.Tensor) -> float:
        """recall@K of ``found`` ids against brute force over the live
        set."""
        from repro_torch.core.search import exact_search, recall_at_k
        ids, vecs = self.live_vectors()
        _, gt = exact_search(vecs, queries, k=K, chunk=64)
        del vecs
        gt_ids = torch.from_numpy(ids)[gt.cpu().long()]
        return recall_at_k(torch.from_numpy(found).long(), gt_ids)


def stream_stats(reqs) -> dict:
    lat = np.array([r.latency_s for r in reqs]) * 1e3
    span = max(r.t_done for r in reqs) - min(r.t_arrival for r in reqs)
    return {"requests": len(reqs), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "qps": len(reqs) / span}


def mutation_path(index, points, queries, zipf, trace, rec_static: float,
                  s2_wall: dict, n: int, seed: int):
    """M1 (the handle + LocalEngine, f32 and uint8), S6 (two mutable
    cached local replicas, wall clock, mutations mid-stream) and S7 (one
    mutable sharded replica per LUT dtype) on one mutable handle over the
    main path's index.  Returns the report and the handle."""
    from repro_torch.core.mutable_index import Index
    from repro_torch.core.search import SearchParams, search_ivfpq
    from repro_torch.runtime import LocalEngine
    from repro_torch.service import AnnService, ServiceSpec

    queries_np = queries.cpu().numpy()
    report: dict = {}
    handle, t_wrap = sync_time(lambda: Index(index, points=points,
                                             mutable=True))
    lo, hi = handle.size_band()
    log(f"  M1 wrap: Index(mutable=True) over N={n}: {t_wrap:.2f} s; "
        f"padded width {handle.clusters.cmax}; auto band [{lo}, {hi}]")
    report["wrap_s"] = t_wrap
    params = {dt: SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                               use_kernels=True, lut_dtype=dt)
              for dt in ("f32", "uint8")}
    engines = {dt: LocalEngine(handle.search_view, handle.clusters, p)
               for dt, p in params.items()}
    model = LiveSet(points, n, n + (M1_ROUNDS + 2) * M1_NEW
                    + S6_ROUNDS * S6_BATCH, seed + 16)

    def hold_engines(qs: np.ndarray, tag: str) -> None:
        """Each engine == search_ivfpq over the handle's current snapshot,
        bit for bit; no deleted id and no padding in the results."""
        view, cl = handle.search_view, handle.clusters
        q = torch.from_numpy(qs).cuda()
        for dt, eng in engines.items():
            d, i = eng.search_batch(qs)
            wd, wi = (x.cpu().numpy()
                      for x in search_ivfpq(view, cl, q, params[dt]))
            check(np.array_equal(d, wd) and np.array_equal(i, wi),
                  f"M1 {tag} lut={dt}: engine differs from search_ivfpq "
                  f"over the snapshot")
            check(bool((i >= 0).all() and model.alive[i].all()),
                  f"M1 {tag} lut={dt}: a deleted id in the results")

    def self_hits(ids: np.ndarray) -> float:
        """Share of upserted ids found in their own vector's top-K."""
        _, i = engines["f32"].search_batch(model.vectors(model.src[ids]))
        return float(np.mean([pid in row for pid, row in zip(ids, i)]))

    # -- M1: 32 rounds of upsert / re-upsert / delete, then a generation --
    apply_ms, install_ms, copied = [], [], []
    new_all = []
    for r in range(M1_ROUNDS):
        ids, src = model.new_ids(M1_NEW)
        re_ids = model.sample_live(M1_REUPSERT, originals=True)
        re_src = model.sample_live(M1_REUPSERT, originals=True)
        model.upserted(re_ids, re_src)
        kill = model.sample_live(M1_DELETE)
        vecs, re_vecs = model.vectors(src), model.vectors(re_src)
        c0 = handle.copied_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = handle.upsert(ids, vecs)
        re_up = handle.upsert(re_ids, re_vecs)
        removed = handle.delete(kill)
        t1 = time.perf_counter()
        for eng in engines.values():
            eng.install(clusters=handle.clusters)
        t2 = time.perf_counter()
        model.alive[kill] = False
        apply_ms.append((t1 - t0) * 1e3)
        install_ms.append((t2 - t1) * 1e3)
        copied.append(handle.copied_bytes - c0)
        check(up["inserted"] == M1_NEW and re_up["replaced"] == M1_REUPSERT
              and removed == M1_DELETE,
              f"M1 round {r}: counts {up} {re_up} removed {removed}")
        lo_q = (r * 256) % (len(queries_np) - 256)
        hold_engines(queries_np[lo_q:lo_q + 256], f"round {r}")
        kept = ids[model.alive[ids]]
        hits = self_hits(kept)
        check(hits >= 0.9, f"M1 round {r}: upserted survivors retrieve "
                           f"themselves at {hits:.4f}")
        new_all.append(ids)
    new_all = np.concatenate(new_all)
    survivors = new_all[model.alive[new_all]]
    hits_before = self_hits(survivors)
    check(hits_before >= 0.9, f"M1: survivors self-retrieve at "
                              f"{hits_before:.4f}")
    _, found = handle.search(queries_np[:N_RECALL], params["f32"])
    rec_before = model.recall(found, queries[:N_RECALL])
    check(abs(rec_before - rec_static) <= 0.01,
          f"M1: recall {rec_before:.4f} vs the static index's "
          f"{rec_static:.4f}")
    def pct(xs, p):
        return float(np.percentile(xs, p))
    log(f"  M1 {M1_ROUNDS} rounds (upsert {M1_NEW} new, re-upsert "
        f"{M1_REUPSERT}, delete {M1_DELETE}; then install on the f32 and "
        f"uint8 engines): apply p50 {pct(apply_ms, 50):.2f} ms, p99 "
        f"{pct(apply_ms, 99):.2f} ms; install p50 {pct(install_ms, 50):.3f}"
        f" ms, p99 {pct(install_ms, 99):.3f} ms; bytes copied per round "
        f"p50 {pct(copied, 50):.0f}, max {max(copied)}; padded width "
        f"{handle.clusters.cmax}; engines == search_ivfpq over each "
        f"snapshot bit for bit, no deleted id; survivors self-retrieve "
        f"{hits_before:.4f}; recall@{K} {rec_before:.4f} (static "
        f"{rec_static:.4f})")
    plan = handle.maintenance_plan()
    gen, t_build = sync_time(lambda: handle.build_generation(seed=seed))
    info, t_install = sync_time(lambda: handle.install_generation(gen))
    del gen
    for eng in engines.values():
        eng.install(index=handle.search_view, clusters=handle.clusters)
    hold_engines(queries_np[:256], "after the generation")
    hits_after = self_hits(survivors[model.alive[survivors]])
    check(hits_after >= 0.9, f"M1: survivors self-retrieve at "
                             f"{hits_after:.4f} after the generation")
    _, found = handle.search(queries_np[:N_RECALL], params["f32"])
    rec_after = model.recall(found, queries[:N_RECALL])
    log(f"  M1 generation (auto band [{plan['band'][0]}, "
        f"{plan['band'][1]}], retrain): plan split {len(plan['split'])} "
        f"merge {len(plan['merge'])}; build {t_build:.2f} s, install "
        f"{t_install:.3f} s; splits {info['splits']} merges "
        f"{info['merges']} retrained {info['retrained']}, nlist "
        f"{info['nlist']}, padded width {handle.clusters.cmax}; survivors "
        f"self-retrieve {hits_after:.4f}; recall@{K} {rec_after:.4f}")
    report["M1"] = {
        "rounds": M1_ROUNDS, "apply_ms": apply_ms, "install_ms": install_ms,
        "copied_bytes": copied, "self_hits_before": hits_before,
        "self_hits_after": hits_after, "recall_before": rec_before,
        "recall_after": rec_after, "recall_static": rec_static,
        "generation_build_s": t_build, "generation_install_s": t_install,
        "generation": {k: info[k] for k in ("splits", "merges", "retrained",
                                            "nlist", "reconciled_upserts",
                                            "reconciled_deletes")},
        "cmax": handle.clusters.cmax}

    base = dict(nprobe=NPROBE, k=K, buckets=SERVICE_BUCKETS, mutable=True)

    def hold_fresh(svc, tag: str) -> None:
        """A fresh batch through each replica (its LUT cache included)
        == the uncached search_ivfpq over the current snapshot."""
        qs = queries_np[:64]
        for rep in svc.replicas:
            d, i = rep.engine.search_batch(qs)
            wd, wi = (x.cpu().numpy() for x in search_ivfpq(
                handle.search_view, handle.clusters,
                torch.from_numpy(qs).cuda(), rep.core.params))
            check(np.array_equal(d, wd) and np.array_equal(i, wi),
                  f"S6 {tag}: a served batch differs from the uncached "
                  f"search_ivfpq over the snapshot")

    # -- S6: two mutable cached local replicas, mutations mid-stream ------
    svc = AnnService.build(ServiceSpec(
        engine="local", replicas=2, router="cache_aware",
        cache_capacity_bytes=1 << 30, **base), index=handle)
    svc.warmup()
    stats0, gen0 = handle.stats.as_dict(), handle.generation
    deleted_at: list = []
    errors: list = []
    removed_total = [0]

    def mutator():
        try:
            for r in range(S6_ROUNDS):
                ids, src = model.new_ids(S6_BATCH)
                svc.upsert(ids, model.vectors(src))
                kill = model.sample_live(S6_BATCH)
                removed_total[0] += svc.delete(kill)
                deleted_at.append((time.monotonic(), kill))
                model.alive[kill] = False
                if r == S6_ROUNDS // 2:
                    svc.run_maintenance(force=True, wait=False)
        except Exception as e:             # noqa: BLE001 -- checked below
            errors.append(e)

    th = threading.Thread(target=mutator, name="s6-mutator")
    t0 = time.perf_counter()
    th.start()
    reqs1 = svc.stream(zipf, clock="wall")
    th.join(timeout=900)
    check(not th.is_alive() and not errors, f"S6 mutator: {errors}")
    svc.mutator.close()
    t_mut = time.perf_counter() - t0
    check(all(r.done for r in reqs1), "S6: unserved requests")
    for r in reqs1:
        dead = [k for t, k in deleted_at if t < r.t_arrival]
        check(not dead or not np.isin(r.ids, np.concatenate(dead)).any(),
              "S6: a request returned an id deleted before it was "
              "submitted")
    st = svc.stats()["mutation"]
    check(st["upserts"] - stats0["upserts"] == S6_ROUNDS * S6_BATCH
          and st["deletes"] - stats0["deletes"] == removed_total[0]
          == S6_ROUNDS * S6_BATCH and st["generation"] == gen0 + 1,
          f"S6: mutation stats {st} against {stats0}")
    hold_fresh(svc, "after the mutated stream")
    reqs2 = svc.stream(zipf, clock="wall")
    check(all(r.done for r in reqs2), "S6: unserved requests (stream 2)")
    qs = np.stack([r.query for r in reqs2])
    wd, wi = (x.cpu().numpy() for x in search_ivfpq(
        handle.search_view, handle.clusters, torch.from_numpy(qs).cuda(),
        svc.replicas[0].core.params))
    check(np.array_equal(np.stack([r.dists for r in reqs2]), wd)
          and np.array_equal(np.stack([r.ids for r in reqs2]), wi),
          "S6: stream 2 differs from the uncached search_ivfpq")
    hold_fresh(svc, "after stream 2")
    s6 = {"stream1": stream_stats(reqs1), "stream2": stream_stats(reqs2),
          "mutator_s": t_mut, "generation": st["last_maintenance"],
          "lut_hit_rate": svc.stats()["aggregate"].get("lut_hit_rate")}
    svc.shutdown()
    del svc
    log(f"  S6 local x2 cache_aware, mutable, Zipf 1.1 on the wall clock: "
        f"stream 1 with {S6_ROUNDS} rounds of {S6_BATCH} upserts + "
        f"{S6_BATCH} deletes and a generation mid-stream: p50 "
        f"{s6['stream1']['p50_ms']:.3f} ms, p99 {s6['stream1']['p99_ms']:.3f}"
        f" ms, QPS {s6['stream1']['qps']:.1f}; stream 2 on the new "
        f"generation: p50 {s6['stream2']['p50_ms']:.3f} ms, p99 "
        f"{s6['stream2']['p99_ms']:.3f} ms, QPS {s6['stream2']['qps']:.1f} "
        f"(S2 wall: p50 {s2_wall['p50_ms']:.3f} ms, p99 "
        f"{s2_wall['p99_ms']:.3f} ms, QPS {s2_wall['qps']:.1f}); mutator + "
        f"maintenance {t_mut:.2f} s; no id deleted before a request's "
        f"submission in its result; served == uncached search_ivfpq after "
        f"each stream")
    report["S6"] = s6

    # -- S7: one mutable sharded replica, f32 then uint8 -------------------
    dup = int(CFG.dup_budget_frac * n * (M + 4))
    report["S7"] = {}
    for dt in ("f32", "uint8"):
        spec = ServiceSpec(engine="sharded", replicas=1,
                           router="least_queue", n_shards=N_SHARDS,
                           split_max=SPLIT_MAX, dup_budget_bytes=dup,
                           tasks_per_shard=TASKS_PER_SHARD, lut_dtype=dt,
                           **base)
        svc, t_svc = sync_time(lambda: AnnService.build(
            spec, index=handle, sample_queries=queries_np))
        svc.warmup()
        stage = {}
        if dt == "f32":
            ids, src = model.new_ids(M1_NEW)
            _, stage["upsert"] = sync_time(
                lambda: svc.upsert(ids, model.vectors(src)))
        kill = model.sample_live(M1_DELETE)
        _, stage["delete"] = sync_time(lambda: svc.delete(kill))
        model.alive[kill] = False
        if dt == "f32":
            out, stage["maintenance"] = sync_time(
                lambda: svc.run_maintenance(force=True, wait=True))
            check(out["ran"], f"S7: maintenance did not run: {out}")
        reqs = svc.stream(trace, clock="wall")
        check(all(r.done for r in reqs), f"S7 lut={dt}: unserved requests")
        qs, sd, si = served(reqs)
        local = LocalEngine(handle.search_view, handle.clusters, params[dt])
        ld, li = local.search_batch(qs)
        d7, i7 = svc.search(queries_np[:N_RECALL])
        l7d, l7i = local.search_batch(queries_np[:N_RECALL])
        for tag, (a, b, c, e) in (("stream", (sd, si, ld, li)),
                                  ("search", (d7, i7, l7d, l7i))):
            check(np.allclose(a, c, rtol=RTOL, atol=ATOL),
                  f"S7 lut={dt} {tag}: distances differ from the local "
                  f"engine on the same snapshot")
            bad = tie_diff_rows(a, b, c, e, RTOL, ATOL)
            check(bad == 0, f"S7 lut={dt} {tag}: ids differ on {bad} rows "
                            f"beyond k-th-place ties")
            check(bool(model.alive[b[b >= 0]].all()),
                  f"S7 lut={dt} {tag}: a deleted id in the results")
        st = stream_stats(reqs)
        gens = svc.core_engine().serving_info()["generations"]
        report["S7"][dt] = {"build_s": t_svc, "stage_s": stage,
                            "generations": gens, **st}
        log(f"  S7 sharded x1, mutable, lut={dt}: build {t_svc:.2f} s; "
            f"staging s per call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in stage.items())
            + f"; {gens} generation swaps; Poisson on the wall clock: p50 "
            f"{st['p50_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms, QPS "
            f"{st['qps']:.1f}; == the local engine on the same snapshot "
            f"(rtol {RTOL}, atol {ATOL}, ids up to k-th-place ties)")
        svc.shutdown()
        del svc, local
        torch.cuda.empty_cache()
    report["stats"] = handle.stats.as_dict()
    return report, handle


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The tiered path: beyond-memory serving over the same index
# ---------------------------------------------------------------------------

TIER_DIR = ROOT / "build" / "tier"
T1_CHURN, T1_CHURN_DRAWS, T2_FULL_QUERIES, T2_GROUPS = 5, 4096, 512, 128


def zipf_rows(n_pool: int, n: int, seed: int, skew: float = 1.1):
    """``n`` rows drawn Zipf(``skew``) over a pool of ``n_pool`` queries
    under a permutation of its own (seeded): each seed makes other
    queries, and so other clusters, hot."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_pool)
    pmf = np.arange(1, n_pool + 1, dtype=np.float64) ** -skew
    return perm[rng.choice(n_pool, size=n, p=pmf / pmf.sum())]
T3_BATCHES = (("f32", 0), ("f32", 1), ("uint8", 0))


def tiered_path(ops, index, clusters, queries, results, zipf, gt,
                rec_f32: float, s5_wall: dict, n: int) -> dict:
    """Drive the tier on the card (T1), the two-level CL (T2), the tiered
    sharded engine (T3) and the tiered service (S8) on the main path's
    index; hold every result to the uncached search_ivfpq over
    pad_clusters (``results`` per LUT dtype).  The spill lives under
    ``build/tier`` and is removed at the end, whatever happens."""
    import shutil

    from repro_torch.core.coarse2 import build_coarse2, coarse2_locate
    from repro_torch.core.search import (SearchParams, cluster_locate,
                                         recall_at_k, search_ivfpq)
    from repro_torch.core.sharded_search import (DistributedEngine,
                                                 EngineConfig, locate_probes)
    from repro_torch.runtime import LocalEngine
    from repro_torch.service import AnnService, ServiceSpec
    from repro_torch.storage import CorruptClusterError, TieredStore

    out: dict = {}
    q_np = queries.cpu().numpy()
    direct = {dt: tuple(x.cpu().numpy() for x in r)
              for dt, r in results.items()}
    total = clusters.codes.numel() + clusters.ids.numel() * 4
    budget = total // 4
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    TIER_DIR.mkdir(parents=True)
    free = shutil.disk_usage(TIER_DIR).free
    log(f"  disk: {free / 2**30:.2f} GiB free under {TIER_DIR}; the phase "
        f"needs {1.5 * total / 2**30:.2f} GiB (one {total} B spill at a "
        f"time, and a margin)")
    check(free >= 1.5 * total, f"tiered path: {free} B free under "
                               f"{TIER_DIR}, short of {1.5 * total:.0f}")
    try:
        # -- T1: the tier on the card, LocalEngine over it ---------------
        t1_dir = TIER_DIR / "t1"
        tier, t_spill = sync_time(lambda: TieredStore.from_clusters(
            clusters, t1_dir, budget_bytes=budget, device="cuda"))
        disk = sum(f.stat().st_size for f in t1_dir.iterdir())
        opened, t_open = sync_time(lambda: TieredStore.open(
            t1_dir, budget_bytes=budget, device="cuda"))
        check(tier.total_bytes == total and disk == total + len(
            (t1_dir / "meta.json").read_bytes()),
              f"T1: spill holds {disk} B for {total} B of clusters")
        log(f"  T1 tier: {tier.nlist} clusters x cap {tier.cap} x M "
            f"{tier.m}: total {total} B, budget {budget} B, resident "
            f"{tier.resident_bytes} B in {tier.n_slots} slots on the card; "
            f"spill {t_spill:.2f} s ({disk} B on disk), open + full verify "
            f"{t_open:.2f} s")
        check(tier.resident_bytes <= budget, "T1: seeded over the budget")
        engines = {}
        for dt in ("f32", "uint8"):
            p = SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                             use_kernels=True, lut_dtype=dt)
            engines[dt] = LocalEngine(index, None, p, tiered_store=tier)
        # the 10,000 queries at f32 and uint8, then churn passes: each a
        # Zipf draw under its own permutation, so each moves the hot set
        # and every pass is checked at a residency of its own
        every = np.arange(len(q_np))
        plan = [("f32", every), ("uint8", every)] + [
            ("f32", zipf_rows(len(q_np), T1_CHURN_DRAWS, seed=1 + c))
            for c in range(T1_CHURN)]
        passes = []
        for j, (dt, rows) in enumerate(plan):
            eng = engines[dt]
            eng.phase_s.clear()
            fetch0 = dict(tier.fetch_s)
            st0 = tier.stats.as_dict()
            qj = q_np[rows]
            n_chunks = -(-len(qj) // QUERY_CHUNK)
            (d, i), secs = sync_time(lambda: eng.search_batch(qj))
            check(np.array_equal(d, direct[dt][0][rows])
                  and np.array_equal(i, direct[dt][1][rows]),
                  f"T1 pass {j} lut={dt}: the tiered engine differs from "
                  f"search_ivfpq")
            check(tier.resident_bytes <= budget,
                  f"T1 pass {j}: {tier.resident_bytes} B resident, over "
                  f"the {budget} B budget")
            st = tier.stats.as_dict()
            delta = {k: st[k] - st0[k] for k in st}
            check(j < 2 or (delta["promotions"] > 0
                            and delta["demotions"] > 0),
                  f"T1 churn pass {j}: promotions {delta['promotions']}, "
                  f"demotions {delta['demotions']}: residency did not move")
            probes = delta["hot_hits"] + delta["cold_requests"]
            fetch = {k: tier.fetch_s[k] - fetch0[k] for k in fetch0}
            rec = {"lut": dt, "queries": len(qj), "s": secs,
                   "ms_per_chunk": secs / n_chunks * 1e3,
                   "hot_rate": delta["hot_hits"] / max(probes, 1),
                   "cold_bytes": delta["cold_bytes"],
                   "cold_fetches": delta["cold_fetches"],
                   "promotions": delta["promotions"],
                   "demotions": delta["demotions"],
                   "host_ms_per_chunk": {
                       k: v / n_chunks * 1e3
                       for k, v in {**eng.phase_s, **fetch}.items()}}
            passes.append(rec)
            log(f"  T1 pass {j} lut={dt}: {len(qj)} queries {secs:.3f} s "
                f"({rec['ms_per_chunk']:.3f} ms a {QUERY_CHUNK}-query "
                f"chunk), == search_ivfpq bit for bit; hot rate "
                f"{rec['hot_rate']:.4f}, cold {delta['cold_fetches']} "
                f"clusters / {delta['cold_bytes']} B, promotions "
                f"{delta['promotions']}, demotions {delta['demotions']}, "
                f"resident {tier.resident_bytes} B; host ms a chunk: "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            rec["host_ms_per_chunk"].items()))
        st = tier.stats
        check(st.cold_fetches > 0 and st.promotions > 0,
              f"T1: cold_fetches {st.cold_fetches}, promotions "
              f"{st.promotions}")
        out["T1"] = {"spill_s": t_spill, "open_verify_s": t_open,
                     "disk_bytes": disk, "total_bytes": total,
                     "budget_bytes": budget, "passes": passes,
                     "stats": tier.serving_info()}
        # one chunk's parts on the card, each timed alone (CUDA events)
        p = engines["f32"].params
        q0 = queries[:QUERY_CHUNK]
        probes0 = cluster_locate(q0, index.centroids, NPROBE,
                                 block=QUERY_CHUNK)[0]
        flat0 = probes0.reshape(-1)
        src = tier._slot_of_dev.index_select(0, flat0).clamp_min(0)
        codes, ids, sizes = tier.gather(flat0)
        res = (q0[:, None, :] - index.centroids[probes0]).reshape(-1, D)
        cb = index.codebook
        lut = ops.lut_build(res, cb.codebooks, cb.sqnorms)
        from repro_torch.core.search import dc_ts_tasks
        parts = {
            "CL (flat)": lambda: cluster_locate(q0, index.centroids, NPROBE,
                                                block=QUERY_CHUNK),
            "hot gather (slab, all rows)": lambda: (
                tier._hot_codes.index_select(0, src),
                tier._hot_ids.index_select(0, src)),
            "whole fetch (gather)": lambda: tier.gather(flat0),
            "LC kernel": lambda: ops.lut_build(res, cb.codebooks,
                                               cb.sqnorms),
            "DC kernel + TS": lambda: dc_ts_tasks(lut, codes, ids, sizes,
                                                  QUERY_CHUNK, p),
        }
        counted = dict(ops.launches)     # timing launches do not count
        chunk_ms = {k: event_ms(fn, reps=5) for k, fn in parts.items()}
        ops.launches.update(counted)
        device_ms = sum(v for k, v in chunk_ms.items() if k != "whole fetch "
                        "(gather)")
        idle = 1 - device_ms / passes[0]["ms_per_chunk"]
        log(f"  T1 one {QUERY_CHUNK}-query chunk, f32, parts timed alone "
            f"(CUDA events, host included): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in chunk_ms.items()))
        log(f"  T1 device work of a chunk (the parts on the card) "
            f"{device_ms:.3f} ms of pass 0's {passes[0]['ms_per_chunk']:.3f}"
            f": idle share ~{idle:.3f}")
        out["T1"]["chunk_parts_ms"] = chunk_ms
        out["T1"]["idle_share"] = idle

        # budget_s=0: every cold probe shed; exact over what was scanned
        eng = engines["f32"]
        qd = q_np[:N_RECALL]
        d, i = eng.search_batch(qd, budget_s=0.0)
        counted = dict(ops.launches)
        info = eng.last_batch_info
        check(info["degraded"] and info["dropped_probes"] > 0,
              f"T1 budget_s=0: not degraded ({info})")
        cold = torch.from_numpy(~tier.resident_mask).cuda()
        emptied = clusters._replace(
            sizes=clusters.sizes.masked_fill(cold, 0),
            ids=clusters.ids.masked_fill(cold[:, None], -1))
        md, mi = (x.cpu().numpy() for x in search_ivfpq(
            index, emptied, torch.from_numpy(qd).cuda(), p))
        ops.launches.update(counted)     # nor does the comparison search
        check(np.array_equal(d, md) and np.array_equal(i, mi),
              "T1 budget_s=0: differs from search_ivfpq over the clusters "
              "with the cold ones emptied")
        del emptied
        log(f"  T1 budget_s=0 on {len(qd)} queries: degraded, "
            f"{info['dropped_probes']} probes dropped, == search_ivfpq "
            f"over the resident clusters bit for bit")
        out["T1"]["degraded_dropped_probes"] = info["dropped_probes"]

        # -- T2: two-level CL -----------------------------------------
        coarse, t_c2 = sync_time(lambda: build_coarse2(
            torch.Generator().manual_seed(0), index.centroids,
            n_groups=T2_GROUPS))
        qf = queries[:T2_FULL_QUERIES]
        flat = locate_probes(qf, index.centroids, NPROBE)
        two = coarse2_locate(coarse, qf, nprobe=NPROBE,
                             nprobe1=coarse.n_groups,
                             block=QUERY_CHUNK)[0].cpu().numpy()
        cents = index.centroids.double()
        c_sq = (cents * cents).sum(1)
        differ, worst = 0, 0.0
        for r in range(len(qf)):
            a, b = set(flat[r].tolist()), set(two[r].tolist())
            if a == b:
                continue
            differ += 1
            qr = qf[r].double()
            dist = ((qr[None] - cents) ** 2).sum(1)
            edge = torch.sort(dist).values[NPROBE - 1]
            for c in a ^ b:
                # each swapped probe sits at the nprobe-th distance, within
                # f32 rounding of the expansion's terms ||q||^2 + ||c||^2
                scale = float((qr * qr).sum() + c_sq[c])
                worst = max(worst, float(abs(dist[c] - edge)) / scale)
        check(worst <= 1e-5, f"T2: a differing probe is {worst:.2e} (of "
                             f"||q||^2 + ||c||^2) from the nprobe-th "
                             f"distance: not a near-tie")
        log(f"  T2 build_coarse2: {coarse.n_groups} groups, gmax "
            f"{coarse.gmax}, {t_c2:.2f} s; nprobe1 = {coarse.n_groups}: "
            f"{differ} of {len(qf)} queries' probe sets differ from flat "
            f"CL's, each a near-tie (worst gap to the {NPROBE}th distance "
            f"{worst:.2e} of ||q||^2 + ||c||^2, float64)")
        q0 = queries[:QUERY_CHUNK]
        counted = dict(ops.launches)
        cl_ms = {"flat": event_ms(lambda: cluster_locate(
            q0, index.centroids, NPROBE, block=QUERY_CHUNK), reps=10)}
        for nprobe1 in (8, coarse.n_groups):
            cl_ms[nprobe1] = event_ms(lambda: coarse2_locate(
                coarse, q0, nprobe=NPROBE, nprobe1=nprobe1,
                block=QUERY_CHUNK), reps=3)
        ops.launches.update(counted)
        eng2 = LocalEngine(index, clusters, p, coarse=coarse,
                           coarse_nprobe1=8)
        _, i2 = eng2.search_batch(q_np[:N_RECALL])
        rec2 = recall_at_k(torch.from_numpy(i2).cuda(), gt)
        log(f"  T2 CL ms a {QUERY_CHUNK}-query chunk (CUDA events): flat "
            f"{cl_ms['flat']:.3f}, two-level nprobe1=8 {cl_ms[8]:.3f}, "
            f"nprobe1={coarse.n_groups} {cl_ms[coarse.n_groups]:.3f}; "
            f"recall@{K} at nprobe1=8 {rec2:.4f} (flat {rec_f32:.4f})")
        out["T2"] = {"n_groups": coarse.n_groups, "gmax": coarse.gmax,
                     "build_s": t_c2, "full_fanout_queries": len(qf),
                     "full_fanout_differ": differ, "worst_gap": worst,
                     "cl_ms": {str(k): v for k, v in cl_ms.items()},
                     "recall_nprobe1_8": rec2}
        del eng2, coarse

        # -- T3: the tiered sharded engine over the reopened spill ------
        handle_view = index._replace(
            codes=index.codes[:0], ids=index.ids[:0])
        sample = locate_probes(queries, index.centroids, NPROBE)
        dup = int(CFG.dup_budget_frac * n * (M + 4))
        t3 = []
        sh_engines = {}
        for dt, b in T3_BATCHES:
            if dt not in sh_engines:
                cfg = EngineConfig(n_shards=N_SHARDS, nprobe=NPROBE, k=K,
                                   split_max=SPLIT_MAX,
                                   dup_budget_bytes=dup,
                                   tasks_per_shard=TASKS_PER_SHARD,
                                   lut_dtype=dt)
                sh_engines[dt], secs = sync_time(lambda: DistributedEngine(
                    handle_view, cfg, sample, tiered_store=opened))
                se = sh_engines[dt]
                log(f"  T3 DistributedEngine lut={dt} over the reopened "
                    f"spill: {secs:.2f} s (layout "
                    f"{se.phase_s['layout']:.2f}, materialize "
                    f"{se.phase_s['materialize']:.2f}); "
                    f"{int(se._cold_mask.sum())} of {index.nlist} clusters "
                    f"scanned through the tier")
            se = sh_engines[dt]
            se.phase_s.clear()
            rows = slice(b * SHARD_BATCH, (b + 1) * SHARD_BATCH)
            (d, i, _), secs = sync_time(lambda: se.search(q_np[rows]))
            ld, li = direct[dt][0][rows], direct[dt][1][rows]
            check(np.allclose(d, ld, rtol=RTOL, atol=ATOL),
                  f"T3 lut={dt} batch {b}: distances differ from T1's")
            bad = tie_diff_rows(d, i, ld, li, RTOL, ATOL)
            check(bad == 0, f"T3 lut={dt} batch {b}: ids differ from T1's "
                            f"on {bad} queries beyond k-th-place ties")
            t3.append({"lut": dt, "batch": b, "s": secs,
                       "phase_s": dict(se.phase_s)})
            log(f"  T3 lut={dt} batch {b}: {SHARD_BATCH} queries "
                f"{secs:.3f} s, == T1 (rtol {RTOL}, atol {ATOL}, ties "
                f"allowed); host s: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in se.phase_s.items()))
        out["T3"] = t3
        del sh_engines, opened, handle_view
        torch.cuda.empty_cache()

        # integrity on T1's store (after T3: the two share the files)
        r = int(np.nonzero(tier.resident_mask)[0][0])
        tier.corrupt_spill(r)
        rebuilds = tier.stats.rebuilds
        check(tier.demote(r) and tier.stats.rebuilds == rebuilds + 1,
              f"integrity: demoting resident cluster {r} with a rotten "
              f"spill did not rebuild it")
        rep, t_verify = sync_time(lambda: tier.verify())
        check(not rep["corrupt"], f"integrity: verify after the rebuild "
                                  f"found {rep['corrupt'][:8]}")
        c = int(np.nonzero(~tier.resident_mask)[0][1])
        tier.corrupt_spill(c)
        try:
            tier.gather(np.array([c]))
            check(False, f"integrity: gather served rotten cluster {c}")
        except CorruptClusterError as e:
            check(e.cluster == c, f"integrity: the error names {e.cluster}, "
                                  f"not {c}")
        _, _, sz, dropped = tier.gather_degraded(np.array([r, c]))
        check(dropped.tolist() == [False, True] and int(sz[1]) == 0,
              f"integrity: gather_degraded kept rotten cluster {c}")
        log(f"  integrity: resident cluster {r}'s rotten spill rebuilt on "
            f"demotion, verify() then clean ({t_verify:.2f} s for "
            f"{tier.nlist} clusters); cold cluster {c}'s rot raised "
            f"CorruptClusterError({c}) and gather_degraded dropped it")
        out["integrity"] = {"rebuilt": r, "quarantined": c,
                            "verify_s": t_verify}
        del engines, tier
        shutil.rmtree(t1_dir)

        # -- S8: the tiered service on S2's Zipf trace, wall clock -------
        spec = ServiceSpec(engine="local", replicas=1, nprobe=NPROBE, k=K,
                           buckets=SERVICE_BUCKETS, storage="tiered",
                           storage_budget_bytes=budget,
                           storage_dir=str(TIER_DIR / "s8"))
        svc, secs = sync_time(lambda: AnnService.build(spec, index=index))
        svc.warmup()
        svc.core_engine().phase_s.clear()
        fetch0 = dict(svc.index.tiered_store.fetch_s)
        reqs = svc.stream(zipf, clock="wall")
        fetch = {k: v - fetch0[k]
                 for k, v in svc.index.tiered_store.fetch_s.items()}
        s8 = service_report("S8 tiered local x1, Zipf 1.1", svc, secs,
                            "wall")
        check(all(r.done for r in reqs), "S8: unserved requests")
        row_of = {qq.tobytes(): j for j, qq in enumerate(q_np)}
        rows = np.array([row_of[r.query.tobytes()] for r in reqs])
        _, sd, si = served(reqs)
        check(np.array_equal(sd, direct["f32"][0][rows])
              and np.array_equal(si, direct["f32"][1][rows]),
              "S8: served results differ from search_ivfpq")
        tinfo = svc.stats()["tier"]
        log(f"    S8 beside S5 wall: p50 {s5_wall['p50_ms']:.3f}, p99 "
            f"{s5_wall['p99_ms']:.3f}, QPS {s5_wall['qps']:.1f}; hot rate "
            f"{tinfo['hot_rate']:.4f}, promotions {tinfo['promotions']}, "
            f"cold {tinfo['cold_fetches']} clusters / "
            f"{tinfo['cold_bytes']} B (host s over the stream: " + ", ".join(
                f"{k} {v:.3f}" for k, v in fetch.items())
            + "); == search_ivfpq bit for bit")
        out["S8"] = dict(s8, tier=tinfo, fetch_s=fetch)
        svc.shutdown()
    finally:
        shutil.rmtree(TIER_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The tenancy path: tenant namespaces, predicate filters and tenant QoS
# ---------------------------------------------------------------------------

N_TENANTS, SCARCE_TENANT, SCARCE_ROWS = 8, 8, 5
TAG_MOD, FILTER_WIDTH = 16, 4
TENANCY_MODES = (("tenant", ()), ("tenant+(3)", (3,)),
                 ("tenant+(1,5,9,13)", (1, 5, 9, 13)))
N2_BATCH, N4_UPSERTS, POSTFILTER_QUERIES = 1_000, 1_024, 256
ISO_TOL = 1e-5                 # the reference's isolation tolerance


def tenancy_metadata(index, clusters, n: int, seed: int):
    """The phase's VectorMeta: a vector's tenant is its mixture component
    mod 8 (the corpus's first draw, redrawn exactly from the seed), so a
    tenant owns whole topics; 5 seeded rows go to a ninth tenant; one tag
    column, id % 16, in a table of FILTER_WIDTH fields; clusters from the
    padded layout."""
    from repro_torch.core.filter import VectorMeta
    from repro_torch.data.vectors import _mixture
    _, _, comp = _mixture(np.random.default_rng(seed), n, D, 64, 1.0)
    tenant_of = (comp % N_TENANTS).astype(np.int32)
    del comp
    scarce = np.sort(np.random.default_rng(seed + 8).choice(
        n, SCARCE_ROWS, replace=False))
    tenant_of[scarce] = SCARCE_TENANT
    tags = (np.arange(n) % TAG_MOD).astype(np.uint32)[:, None]
    meta = VectorMeta(tag_fields=FILTER_WIDTH)
    meta.set(np.arange(n), tenant=tenant_of, tags=tags)
    meta.rebuild_clusters(clusters.ids.cpu().numpy(),
                          clusters.sizes.cpu().numpy())
    return meta, tenant_of, tags, scarce


def query_tenants(index, queries, meta) -> np.ndarray:
    """A query's tenant is the majority tenant of its nearest centroid,
    so a tenant's queries land near its own data; one query in 8 is left
    unscoped (-1)."""
    from repro_torch.core.sharded_search import locate_probes
    nearest = locate_probes(queries, index.centroids, 1)[:, 0]
    ok = meta.cluster_of >= 0
    counts = np.bincount(meta.cluster_of[ok].astype(np.int64)
                         * (N_TENANTS + 1) + meta.tenant_of[ok],
                         minlength=index.nlist * (N_TENANTS + 1))
    major = counts.reshape(index.nlist, N_TENANTS + 1)[:, :N_TENANTS]
    q_tenant = major.argmax(1)[nearest].astype(np.int32)
    q_tenant[7::8] = -1
    return q_tenant


def hold_to_subindex(index, meta, tenant: int, qs: np.ndarray, got_d,
                     got_i, p) -> tuple:
    """The isolation oracle: tenant-scoped results over the shared index
    against ``search_ivfpq`` over ``tenant_subindex`` at nprobe = min(32,
    members).  CL over all centroids (masked) and CL over the members
    alone are GEMMs of other shapes, so cuBLAS may round them apart and a
    near-tie at the nprobe-th centroid may swap a probe: such queries are
    counted, each differing probe checked to sit at the nprobe-th
    distance within 1e-5 of ||q||^2 + ||c||^2 (float64, as T2), and every
    other query is held to the reference's rule (distances at 1e-5, ids
    equal up to exact ties).  Returns (queries, differing, worst gap)."""
    from repro_torch.core.filter import tenant_subindex
    from repro_torch.core.ivf import pad_clusters
    from repro_torch.core.search import (cluster_locate,
                                         cluster_locate_masked,
                                         search_ivfpq)
    sub, members = tenant_subindex(index, meta, tenant)
    npr = min(NPROBE, len(members))
    dev = index.centroids.device
    q = torch.from_numpy(qs).to(dev)
    sd, si = (x.cpu().numpy() for x in search_ivfpq(
        sub, pad_clusters(sub), q, p._replace(nprobe=npr)))
    mem_t = torch.from_numpy(members).to(dev)
    shared, own = [], []
    for s in range(0, len(qs), QUERY_CHUNK):
        qb = q[s:s + QUERY_CHUNK]
        allowed = meta.allowed_on(np.full(len(qb), tenant), index.nlist,
                                  dev)
        shared.append(cluster_locate_masked(
            qb, index.centroids, NPROBE, allowed, block=QUERY_CHUNK)[0])
        own.append(mem_t[cluster_locate(qb, sub.centroids, npr,
                                        block=QUERY_CHUNK)[0]])
    shared = torch.cat(shared)[:, :npr].cpu().numpy()
    own = torch.cat(own).cpu().numpy()
    cents = index.centroids.double()
    c_sq = (cents * cents).sum(1)
    differ, worst = [], 0.0
    for r in range(len(qs)):
        a, b = set(shared[r].tolist()), set(own[r].tolist())
        if a == b:
            continue
        differ.append(r)
        qr = q[r].double()
        dist = ((qr[None] - cents[mem_t]) ** 2).sum(1)
        edge = torch.sort(dist).values[npr - 1]
        for c in a ^ b:
            scale = float((qr * qr).sum() + c_sq[c])
            dc = float(((qr - cents[c]) ** 2).sum())
            worst = max(worst, abs(dc - float(edge)) / scale)
    check(worst <= 1e-5, f"tenant {tenant}: a differing probe is "
                         f"{worst:.2e} from the nprobe-th distance: not a "
                         f"near-tie")
    keep = np.setdiff1d(np.arange(len(qs)), differ)
    fin = np.isfinite(sd[keep])
    check(np.array_equal(fin, np.isfinite(got_d[keep]))
          and np.allclose(got_d[keep][fin], sd[keep][fin], rtol=ISO_TOL,
                          atol=ISO_TOL),
          f"tenant {tenant}: scoped distances differ from the dedicated "
          f"sub-index")
    bad = tie_diff_rows(got_d[keep], got_i[keep], sd[keep], si[keep],
                        ISO_TOL, ISO_TOL)
    check(bad == 0 and np.array_equal(got_i[keep] < 0, si[keep] < 0),
          f"tenant {tenant}: ids differ from the dedicated sub-index on "
          f"{bad} queries beyond exact ties")
    return len(qs), len(differ), worst


def bucket_shed(times, rate: float, burst: int) -> int:
    """The smoke's own model of a token bucket: requests refused at the
    given arrival times (seconds)."""
    tokens, last, shed = float(burst), None, 0
    for t in times:
        last = t if last is None else last
        tokens = min(float(burst), tokens + max(t - last, 0.0) * rate)
        last = t
        if tokens >= 1.0:
            tokens -= 1.0
        else:
            shed += 1
    return shed


def scoped_names_check(ss, steps, meta) -> None:
    """The reference's names of the scoped step on N2's first steps (f32
    and uint8), with the scope as raw arrays (the meta tables on the host,
    the batch's tenants and u32 terms): ``run_shards_vmap_scoped`` and
    ``run_shards_vmap_lut_scoped`` (a bank of the f32 step's tasks' own
    tables, every other task's row withheld) == ``run_shards_scoped``
    with N2's ``Scope``, bit for bit."""
    raw = (meta.tenant_of, meta.tags)
    for quantize, (sx, qidx, sidx, qs, scope, k) in sorted(steps.items()):
        q_raw = (scope.tenants, scope.terms)
        want = ss.run_shards_scoped(sx, qidx, sidx, qs, scope, k=k,
                                    quantize=quantize)
        got = ss.run_shards_vmap_scoped(sx, qidx, sidx, qs, *raw, *q_raw,
                                        k=k, quantize=quantize)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"N2: run_shards_vmap_scoped (quantize={quantize}) differs "
              f"from run_shards_scoped")
        if quantize:
            continue
        codes, ids, sizes, cluster_of = ss._flat(sx)
        dev = codes.device
        si = ss._flat_slots(torch.from_numpy(sidx).to(dev), sx.slots)
        bank = ss._task_lut(cluster_of, torch.from_numpy(qidx).to(dev)
                            .reshape(-1), si.clamp_min(0).long(), qs,
                            sx.centroids, sx.codebook, sx.rotation, False)
        lidx = np.arange(qidx.size).reshape(qidx.shape)
        lidx[:, 1::2] = -1
        want = ss.run_shards_scoped(sx, qidx, sidx, qs, scope, k=k,
                                    lidx=lidx, lut_bank=bank)
        got = ss.run_shards_vmap_lut_scoped(sx, qidx, sidx, lidx, bank,
                                            *raw, *q_raw, k=k)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              "N2: run_shards_vmap_lut_scoped differs from "
              "run_shards_scoped")
        check(bool((want[1][:, 1::2] == -1).all()),
              "N2: a task without a bank row returned rows")
        del bank
    log(f"  N2 run_shards_vmap_scoped (f32, uint8) and "
        f"run_shards_vmap_lut_scoped on the raw scope arrays == "
        f"run_shards_scoped with the batch's Scope, bit for bit "
        f"({qidx.shape[0]} shards x {qidx.shape[1]} tasks)")


def tenancy_path(ops, index, clusters, points, queries, results, trace,
                 s5_runs, n: int, seed: int) -> dict:
    """Multi-tenant serving on the main path's index: N1 scoped local
    search, N2 the scoped sharded engine, N3 the tier, N4 the live index,
    S9 the tenant-aware service on both clocks.  Oracle searches and
    kernel checks restore the launch counts, so the path's counts are the
    scoped traffic's own."""
    import dataclasses
    import shutil

    from repro_torch.core.adc import (QuantizedLUT, adc_distances,
                                      adc_distances_quantized)
    from repro_torch.core.filter import pad_terms
    from repro_torch.core.mutable_index import Index
    from repro_torch.core.search import SearchParams, search_ivfpq
    from repro_torch.core.sharded_search import (DistributedEngine,
                                                 EngineConfig, locate_probes)
    from repro_torch.runtime import LocalEngine
    from repro_torch.service import AnnService, ServiceSpec
    from repro_torch.storage import TieredStore

    out: dict = {}
    dev = index.centroids.device
    q_np = queries.cpu().numpy()
    nq = len(q_np)
    n_chunks = -(-nq // QUERY_CHUNK)
    params = {dt: SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                               use_kernels=True, lut_dtype=dt)
              for dt in ("f32", "uint8")}
    t0 = time.perf_counter()
    meta, tenant_of, tags, scarce = tenancy_metadata(index, clusters, n,
                                                     seed)
    q_tenant = query_tenants(index, queries, meta)
    mt, mg = meta.device_tables(dev)
    dev_bytes = mt.numel() * mt.element_size() + mg.numel() * \
        mg.element_size()
    rows_per = np.bincount(tenant_of, minlength=N_TENANTS + 1)
    q_per = np.bincount(q_tenant[q_tenant >= 0], minlength=N_TENANTS + 1)
    members = meta.bitmap(index.nlist).sum(1)
    log(f"  metadata {time.perf_counter() - t0:.2f} s: rows per tenant "
        f"{rows_per.tolist()}, member clusters {members.tolist()} of "
        f"{index.nlist}, queries per tenant {q_per.tolist()} (+ "
        f"{int((q_tenant < 0).sum())} unscoped); tables {meta.nbytes} B on "
        f"the host, {dev_bytes} B on the card")
    out["meta"] = {"rows_per_tenant": rows_per.tolist(),
                   "member_clusters": members.tolist(),
                   "queries_per_tenant": q_per.tolist(),
                   "host_bytes": meta.nbytes, "device_bytes": dev_bytes}

    def counted_out(fn):
        """Run an oracle or a check whose launches do not count."""
        kept = dict(ops.launches)
        try:
            return fn()
        finally:
            ops.launches.update(kept)

    # -- N1: scoped LocalEngine over the 10,000 queries ------------------
    engines = {dt: LocalEngine(index, clusters, p, meta=meta)
               for dt, p in params.items()}
    n1, res = {"passes": []}, {}
    for dt in ("f32", "uint8"):
        eng = engines[dt]
        eng.search_batch(q_np[:QUERY_CHUNK], tenants=q_tenant[:QUERY_CHUNK])
        (_, _), unsc = counted_out(lambda: sync_time(lambda: search_ivfpq(
            index, clusters, queries, params[dt])))
        for label, terms in TENANCY_MODES:
            g = pad_terms([terms] * nq, FILTER_WIDTH)
            (d, i), secs = sync_time(lambda: eng.search_batch(
                q_np, tenants=q_tenant, terms=g))
            res[dt, label] = (d, i)
            live = i >= 0
            ii = np.clip(i, 0, None)
            tt = q_tenant[:, None]
            ok = (tt < 0) | (meta.tenant_of[ii] == tt)
            if terms:
                ok &= np.isin(meta.tags[ii, 0], terms)
            check(bool((~live | ok).all()), f"N1 {dt} {label}: a result "
                                            f"leaves its tenant or predicate")
            check(bool(np.isfinite(d[live]).all())
                  and not np.isfinite(d[~live]).any(),
                  f"N1 {dt} {label}: the (inf, -1) tail is broken")
            if not terms:
                free = q_tenant < 0
                ud, ui = (x.cpu().numpy() for x in results[dt])
                check(np.array_equal(d[free], ud[free])
                      and np.array_equal(i[free], ui[free]),
                      f"N1 {dt}: unscoped rows of the mixed batch differ "
                      f"from search_ivfpq")
            rec = {"lut": dt, "mode": label, "s": secs,
                   "ms_per_chunk": secs / n_chunks * 1e3,
                   "unscoped_ms_per_chunk": unsc / n_chunks * 1e3,
                   "live_fraction": float(live.mean())}
            n1["passes"].append(rec)
            log(f"  N1 lut={dt} {label}: {nq} queries {secs:.3f} s, "
                f"{rec['ms_per_chunk']:.3f} ms a {QUERY_CHUNK}-query chunk "
                f"(unscoped search_ivfpq {rec['unscoped_ms_per_chunk']:.3f});"
                f" {live.mean():.4f} of the slots filled; scope held"
                + ("; unscoped rows == search_ivfpq bit for bit"
                   if not terms else ""))
    # the isolation oracle, every tenant, both LUT dtypes
    iso = []
    for dt in ("f32", "uint8"):
        d, i = res[dt, "tenant"]
        for t in range(N_TENANTS):
            rows = np.nonzero(q_tenant == t)[0]
            if rows.size == 0:
                continue
            nq_t, diff, worst = counted_out(lambda: hold_to_subindex(
                index, meta, t, q_np[rows], d[rows], i[rows], params[dt]))
            iso.append({"lut": dt, "tenant": t, "queries": nq_t,
                        "probe_sets_differ": diff, "worst_gap": worst})
        # the ninth tenant, 5 rows: 16 queries, a 5-row result and a tail
        qs = q_np[:16]
        sd_, si_ = engines[dt].search_batch(
            qs, tenants=np.full(16, SCARCE_TENANT, np.int32))
        check(all(set(r[r >= 0].tolist()) == set(scarce.tolist())
                  and np.all(r[SCARCE_ROWS:] == -1) for r in si_)
              and np.isinf(sd_[:, SCARCE_ROWS:]).all()
              and np.isfinite(sd_[:, :SCARCE_ROWS]).all(),
              f"N1 {dt}: the 5-row tenant's result is not its 5 rows and "
              f"an (inf, -1) tail")
        nq_t, diff, worst = counted_out(lambda: hold_to_subindex(
            index, meta, SCARCE_TENANT, qs, sd_, si_, params[dt]))
        iso.append({"lut": dt, "tenant": SCARCE_TENANT, "queries": nq_t,
                    "probe_sets_differ": diff, "worst_gap": worst})
    n1["isolation"] = iso
    n_diff = sum(r["probe_sets_differ"] for r in iso)
    log(f"  N1 isolation: {sum(r['queries'] for r in iso)} scoped queries "
        f"over 9 tenants x 2 LUT dtypes == search_ivfpq over each tenant's "
        f"sub-index; {n_diff} with a probe set of their own, each a "
        f"near-tie (worst gap {max(r['worst_gap'] for r in iso):.2e}); "
        f"the 5-row tenant gets its 5 rows and an (inf, -1) tail")
    # the brute-force post-filter oracle on 256 queries, predicate only
    qb = q_np[:POSTFILTER_QUERIES]
    kbig = NPROBE * clusters.cmax
    for dt in ("f32", "uint8"):
        d_all, i_all = counted_out(lambda: tuple(
            x.cpu().numpy() for x in search_ivfpq(
                index, clusters, queries[:POSTFILTER_QUERIES],
                params[dt]._replace(k=kbig))))
        for terms in ((3,), (1, 5, 9, 13)):
            g = pad_terms([terms] * len(qb), FILTER_WIDTH)
            d, i = engines[dt].search_batch(qb, terms=g)
            keep = meta.match_host(i_all, terms=terms)
            rd = np.full((len(qb), K), np.inf, np.float32)
            ri = np.full((len(qb), K), -1, np.int32)
            for r in range(len(qb)):
                sel = np.flatnonzero(keep[r])[:K]
                rd[r, :sel.size], ri[r, :sel.size] = (d_all[r, sel],
                                                      i_all[r, sel])
            check(np.allclose(d, rd, rtol=ISO_TOL, atol=ISO_TOL)
                  and tie_diff_rows(d, i, rd, ri, ISO_TOL, ISO_TOL) == 0,
                  f"N1 {dt} terms {terms}: differs from the brute-force "
                  f"post-filter")
        del d_all, i_all
    log(f"  N1 post-filter: {len(qb)} queries, terms (3) and (1,5,9,13), "
        f"f32 and uint8 == ranking all {kbig} candidates of the same probes"
        f", dropping rows without a term, keeping {K}")
    # the mask alone on one chunk's candidates (CUDA events)
    from repro_torch.core.filter import Scope
    from repro_torch.core.search import cluster_locate
    probes0 = cluster_locate(queries[:QUERY_CHUNK], index.centroids,
                             NPROBE, block=QUERY_CHUNK)[0]
    ids0 = clusters.ids.index_select(0, probes0.reshape(-1)).reshape(
        QUERY_CHUNK, -1)
    d0 = torch.rand(ids0.shape, device=dev)
    mask_ms = {}
    for label, terms in TENANCY_MODES:
        sc = Scope(meta, q_tenant[:QUERY_CHUNK],
                   pad_terms([terms] * QUERY_CHUNK, FILTER_WIDTH), dev)
        fn = sc.masker(slice(0, QUERY_CHUNK))
        mask_ms[label] = event_ms(lambda: fn(d0, ids0), reps=10)
    del d0, ids0
    n1["mask_ms"] = mask_ms
    log(f"  N1 the scope mask alone on one chunk's {QUERY_CHUNK} x "
        f"{NPROBE * clusters.cmax} candidates (CUDA events): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in mask_ms.items()))
    out["N1"] = n1

    # -- N2: one scoped sharded engine, f32 then uint8 -------------------
    sample = locate_probes(queries, index.centroids, NPROBE)
    dup = int(CFG.dup_budget_frac * n * (M + 4))
    cfg = EngineConfig(n_shards=N_SHARDS, nprobe=NPROBE, k=K,
                       split_max=SPLIT_MAX, dup_budget_bytes=dup,
                       tasks_per_shard=TASKS_PER_SHARD, lut_dtype="f32")
    se, t_build = sync_time(lambda: DistributedEngine(index, cfg, sample,
                                                      meta=meta))
    log(f"  N2 DistributedEngine(meta=...) {t_build:.2f} s: "
        f"{len(se.sindex.slot_of_instance)} instances in {N_SHARDS} shards")
    captured = {}
    launch = ops.pq_scan_dc

    def capture(lut, codes, sizes=None, **kw):
        name = ("pq_scan_dc_q" if isinstance(lut, QuantizedLUT)
                else "pq_scan_dc")
        check(kw.get("slots") is None, "N2: the scoped sharded step "
                                       "launched DC by slot (held dense here)")
        captured.setdefault(name, (lut, codes, sizes))
        return launch(lut, codes, sizes, **kw)

    from repro_torch.core import sharded_search as ss_mod
    steps, step_fn = {}, ss_mod.run_shards_scoped

    def capture_step(sindex, qidx, sidx, qs, scope, **kw):
        steps.setdefault(kw.get("quantize", False),
                         (sindex, qidx, sidx, qs, scope, kw["k"]))
        return step_fn(sindex, qidx, sidx, qs, scope, **kw)

    n2 = []
    ops.pq_scan_dc = capture
    ss_mod.run_shards_scoped = capture_step
    try:
        for dt, (label, terms) in (("f32", TENANCY_MODES[0]),
                                   ("uint8", TENANCY_MODES[1])):
            # one engine for both LUT dtypes: the placement was priced at
            # f32 LUT widths; a LUT dtype changes no candidate
            se.cfg = dataclasses.replace(se.cfg, lut_dtype=dt)
            se.phase_s.clear()
            rows = slice(0, N2_BATCH)
            g = pad_terms([terms] * N2_BATCH, FILTER_WIDTH)
            (d, i, _), secs = sync_time(lambda: se.search(
                q_np[rows], tenants=q_tenant[rows], terms=g))
            ld, li = res[dt, label][0][rows], res[dt, label][1][rows]
            check(np.array_equal(np.isfinite(d), np.isfinite(ld))
                  and np.allclose(np.where(np.isfinite(d), d, 0),
                                  np.where(np.isfinite(ld), ld, 0),
                                  rtol=RTOL, atol=ATOL),
                  f"N2 lut={dt}: distances differ from N1's")
            bad = tie_diff_rows(d, i, ld, li, RTOL, ATOL)
            check(bad == 0, f"N2 lut={dt}: ids differ from N1's on {bad} "
                            f"queries beyond k-th-place ties")
            n2.append({"lut": dt, "mode": label, "queries": N2_BATCH,
                       "s": secs, "phase_s": dict(se.phase_s)})
            log(f"  N2 lut={dt} {label}: {N2_BATCH} queries {secs:.3f} s, "
                f"== N1 (rtol {RTOL}, atol {ATOL}, ties allowed); host s: "
                + ", ".join(f"{k} {v:.3f}" for k, v in se.phase_s.items()))
    finally:
        ops.pq_scan_dc = launch
        ss_mod.run_shards_scoped = step_fn
    del se
    check(set(steps) == {False, True},
          f"N2: scoped steps captured for quantize {sorted(steps)}")
    counted_out(lambda: scoped_names_check(ss_mod, steps, meta))
    del steps
    torch.cuda.empty_cache()
    check(set(captured) == {"pq_scan_dc", "pq_scan_dc_q"},
          f"N2: the scoped step launched {sorted(captured)}")
    log("kernels vs plain, the scoped sharded step's first DC launches:")
    lut, codes, sizes = captured["pq_scan_dc"]
    qlut, qcodes, qsizes = captured["pq_scan_dc_q"]
    where = (f"scoped sharded step T={codes.shape[0]} C={codes.shape[1]}")
    errs = {}
    for name, table, cc, sz, plain in (
            ("pq_scan_dc", lut, codes, sizes, adc_distances),
            ("pq_scan_dc_q", qlut, qcodes, qsizes, adc_distances_quantized)):
        got = counted_out(lambda: ops.pq_scan_dc(table, cc, sz))
        want = plain(table, cc, sz)
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)),
              f"{name} {where}: +inf mask differs")
        errs[name] = float((got[fin] - want[fin]).abs().max())
        check(torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL),
              f"{name} {where}: max |err| {errs[name]}")
    log(f"  {where}: pq_scan_dc max|err| {errs['pq_scan_dc']:.3e}, "
        f"pq_scan_dc_q max|err| {errs['pq_scan_dc_q']:.3e}")
    del captured, lut, codes, sizes, qlut, qcodes, qsizes
    out["N2"] = {"build_s": t_build, "batches": n2, "dc_check": errs}

    # -- N3: the tier, a quarter resident, one scoped pass at f32 ---------
    total = clusters.codes.numel() + clusters.ids.numel() * 4
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    TIER_DIR.mkdir(parents=True)
    check(shutil.disk_usage(TIER_DIR).free >= 1.5 * total,
          f"N3: short of {1.5 * total:.0f} B under {TIER_DIR}")
    try:
        tier = TieredStore.from_clusters(clusters, TIER_DIR / "n3",
                                         budget_bytes=total // 4,
                                         device=dev)
        teng = LocalEngine(index, None, params["f32"], tiered_store=tier,
                           meta=meta)
        n3 = []
        want = res["f32", "tenant"]
        for j in range(2):        # the second pass at its own residency
            before = tier.stats.as_dict()
            (d, i), secs = sync_time(lambda: teng.search_batch(
                q_np, tenants=q_tenant))
            check(np.array_equal(d, want[0]) and np.array_equal(i, want[1]),
                  f"N3 pass {j}: the tiered scoped search differs from "
                  f"N1's resident one")
            after = tier.stats.as_dict()
            n3.append({"pass": j, "s": secs,
                       "ms_per_chunk": secs / n_chunks * 1e3,
                       "promotions": after["promotions"]
                       - before["promotions"],
                       "cold_fetches": after["cold_fetches"]
                       - before["cold_fetches"]})
            log(f"  N3 tiered pass {j}, lut=f32 tenant: {secs:.3f} s "
                f"({n3[-1]['ms_per_chunk']:.3f} ms a chunk), promotions "
                f"{n3[-1]['promotions']}, cold fetches "
                f"{n3[-1]['cold_fetches']}; == N1 bit for bit")
        out["N3"] = n3
        del teng, tier
    finally:
        shutil.rmtree(TIER_DIR, ignore_errors=True)

    # -- N4: the live index, 1,024 upserts tagged to tenant 2 -------------
    handle, t_wrap = sync_time(lambda: Index(index, points=points,
                                             mutable=True))
    handle.meta = meta
    rng = np.random.default_rng(seed + 4)
    src = rng.choice(np.nonzero(tenant_of == 2)[0], N4_UPSERTS,
                     replace=False)
    vecs = (points[torch.from_numpy(src).to(dev)].float().cpu().numpy()
            + rng.normal(0, 1.0, (N4_UPSERTS, D)).astype(np.float32))
    new = np.arange(n, n + N4_UPSERTS)
    info, t_up = sync_time(lambda: handle.upsert(
        new, vecs, tenant=2, tags=(new % TAG_MOD).astype(np.uint32)[:, None]))
    leng = LocalEngine(handle.search_view, handle.clusters, params["f32"],
                       meta=meta)
    (d2, i2), t_s = sync_time(lambda: leng.search_batch(
        vecs, tenants=np.full(N4_UPSERTS, 2, np.int32)))
    self_hit = float(np.mean([new[j] in i2[j] for j in range(N4_UPSERTS)]))
    check(self_hit >= 0.9, f"N4: upserts in their own top-{K} under tenant "
                           f"2 at {self_hit:.4f} < 0.9")
    for t in range(N_TENANTS + 1):
        if t == 2:
            continue
        _, io = leng.search_batch(vecs, tenants=np.full(N4_UPSERTS, t,
                                                        np.int32))
        check(not np.isin(io, new).any(), f"N4: an upsert of tenant 2 "
                                          f"surfaced under tenant {t}")
    rows2 = np.nonzero(q_tenant == 2)[0]
    qs = np.concatenate([vecs, q_np[rows2]])
    dq, iq = leng.search_batch(qs, tenants=np.full(len(qs), 2, np.int32))
    snap = handle.to_ivfpq()
    nq4, diff4, worst4 = counted_out(lambda: hold_to_subindex(
        snap, meta, 2, qs, dq, iq, params["f32"]))
    out["N4"] = {"wrap_s": t_wrap, "upsert_s": t_up, "search_s": t_s,
                 "self_hit": self_hit, "queries": nq4,
                 "probe_sets_differ": diff4, "worst_gap": worst4,
                 "inserted": info["inserted"]}
    log(f"  N4 live: wrap {t_wrap:.2f} s, {N4_UPSERTS} upserts tagged to "
        f"tenant 2 in {t_up * 1e3:.1f} ms; self-retrieved in their top-{K} "
        f"under tenant 2 at {self_hit:.4f}, never under the other 8 "
        f"tenants; {nq4} tenant-2 queries == search_ivfpq over the "
        f"snapshot's sub-index ({diff4} near-tie probe sets, worst gap "
        f"{worst4:.2e})")
    del leng, handle, snap
    torch.cuda.empty_cache()

    # -- S9: the tenant-aware service, virtual and wall clocks ------------
    names = [f"t{t}" for t in range(N_TENANTS)]
    spec = ServiceSpec(
        engine="local", replicas=1, nprobe=NPROBE, k=K,
        buckets=SERVICE_BUCKETS, filter_width=FILTER_WIDTH, qos_wfq=True,
        tenants=tuple((names[t], t, 4.0 if t == 0 else 1.0,
                       100.0 if t == 7 else 0.0, 4 if t == 7 else 1)
                      for t in range(N_TENANTS)))
    row_of = {qq.tobytes(): j for j, qq in enumerate(q_np)}
    arr_rows = np.array([row_of[q.tobytes()] for _, q in trace])
    arr_ten = q_tenant[arr_rows]
    arrivals = [(t, q, None if arr_ten[j] < 0 else names[arr_ten[j]])
                for j, (t, q) in enumerate(trace)]
    t7 = [t for j, (t, _) in enumerate(trace) if arr_ten[j] == 7]
    model_shed = bucket_shed(t7, 100.0, 4)
    handle = Index(index)
    s9 = []
    for clock in ("virtual", "wall"):
        svc, secs = sync_time(lambda: AnnService.build(
            spec, index=handle, tenants=tenant_of, tags=tags))
        svc.warmup()
        reqs = svc.stream(arrivals, clock=clock)
        st = svc.stats()
        ten = st["tenants"]
        shed = {nm: ten[nm]["shed"] for nm in names}
        check(all(v == 0 for nm, v in shed.items() if nm != "t7"),
              f"S9 {clock}: a tenant other than t7 was shed: {shed}")
        check(len(reqs) + sum(shed.values()) == len(arrivals),
              f"S9 {clock}: {len(reqs)} served + {sum(shed.values())} shed "
              f"!= {len(arrivals)}")
        if clock == "virtual":
            check(shed["t7"] == model_shed, f"S9 virtual: t7 shed "
                                            f"{shed['t7']}, the bucket model "
                                            f"says {model_shed}")
        else:
            check(shed["t7"] <= len(t7), f"S9 wall: t7 shed {shed['t7']}")
            q = st["qos"]
            check(sum(q["dispatched"].values()) == len(reqs)
                  and q["queued"] == 0,
                  f"S9 wall: WFQ dispatched {q['dispatched']}")
            check(bool(st["router"].get("tenant_picks")),
                  "S9 wall: no per-tenant router picks")
        check(all(r.done for r in reqs), f"S9 {clock}: unserved requests")
        for t in sorted({r.tenant for r in reqs}):
            mine = [r for r in reqs if r.tenant == t]
            qs = np.stack([r.query for r in mine])
            dd, di = svc.search(qs, tenant=None if t < 0 else t)
            check(np.array_equal(np.stack([r.dists for r in mine]), dd)
                  and np.array_equal(np.stack([r.ids for r in mine]), di),
                  f"S9 {clock}: tenant {t}'s served results differ from "
                  f"the direct scoped search")
        rep = service_report("S9 local x1 tenants, Poisson", svc, secs,
                             clock)
        rep["tenants"] = {nm: {k: ten[nm].get(k) for k in
                               ("requests", "p50_ms", "p99_ms", "shed",
                                "weight")} for nm in names}
        rep["model_shed_t7"] = model_shed
        if clock == "wall":
            rep["qos"] = st["qos"]
            rep["tenant_picks"] = st["router"]["tenant_picks"]
        s5 = next(r for r in s5_runs if r.get("clock") == clock
                  and r["label"].startswith("S5"))
        rep["S5"] = {k: s5[k] for k in ("p50_ms", "p99_ms", "qps")}
        log(f"    S9 {clock} beside S5: p50 {s5['p50_ms']:.3f}, p99 "
            f"{s5['p99_ms']:.3f}, QPS {s5['qps']:.1f}; per tenant "
            f"(requests / p50 / p99 ms / shed): " + "; ".join(
                f"{nm} {ten[nm]['requests']} / {ten[nm]['p50_ms']:.3f} / "
                f"{ten[nm]['p99_ms']:.3f} / {ten[nm]['shed']}"
                for nm in names)
            + (f"; t7 offered {len(t7)}, the bucket model sheds "
               f"{model_shed}")
            + (f"; WFQ max_queued {st['qos']['max_queued']}, dispatched "
               f"{st['qos']['dispatched']}" if clock == "wall" else "")
            + "; every served result == the direct scoped search")
        s9.append(rep)
        svc.shutdown()
    out["S9"] = s9
    return out



# -- X: the chaos harness at N = 10M -----------------------------------------
CHAOS_QUERIES, CHAOS_INTERVAL_S, CHAOS_NPROBE, CHAOS_BATCH = (
    1_000, 5e-3, 8, 8)
# (label, LUT dtype, stream skew, resident share, promote margin): the
# reference's Zipf stream at the tiered phase's quarter budget and the
# spec's margin, at f32 and uint8.  There every batch's cold probes are
# promoted before its own gather (the slab holds 4,096 clusters, a batch
# probes at most 64), so the stream never reads a cold row.  Then uniform
# draws over a sixteenth at a margin of 1e6 (a probed cluster displaces
# only never-probed ones): a hot set past the budget, read from the host,
# which loads the degraded path (cold reads fire, dropped probes,
# degraded answers)
CHAOS_RUNS = (("f32", "f32", 1.1, 4, 1.25), ("uint8", "uint8", 1.1, 4, 1.25),
              ("f32 past the budget", "f32", 0.0, 16, 1e6))


def chaos_path(ops, ref, adc, index, clusters, points, queries,
               seed: int) -> dict:
    """The chaos harness's canonical experiment (service/chaos.py) on the
    main path's index: two tiered local replicas with a quarter of the
    padded clusters on the card, the harness's spec (nprobe 8, buckets
    1..8, deadline 50 ms, 2 retries, breaker at 3, checksums) under
    default_plan(seed), 1,000 Zipf(1.1) draws from the 10,000 queries
    offered on the wall clock at one per 5 ms; f32, then uint8, then f32
    on uniform draws over a sixteenth resident (the degraded path), each
    held to its own fault-free fleet.  Spills under build/tier (free
    space checked first), removed at the end.  Returns the phase's
    report and its launch counts (all runs)."""
    import shutil

    from repro_torch.core.search import cluster_locate, exact_search
    from repro_torch.service.chaos import (chaos_experiment, check_floors,
                                           zipf_stream)

    q_np = queries.cpu().numpy()
    total = clusters.codes.numel() + clusters.ids.numel() * 4
    # exact ids for every pool row a stream draws
    drawn = np.unique(np.concatenate([
        zipf_stream(CHAOS_QUERIES, len(q_np), seed, skew)
        for skew in sorted({r[2] for r in CHAOS_RUNS})]))
    gt = np.full((len(q_np), K), -1, np.int64)
    _, g = exact_search(points,
                        queries[torch.from_numpy(drawn).to(queries.device)],
                        k=K, chunk=64)
    gt[drawn] = g.cpu().numpy()
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    TIER_DIR.mkdir(parents=True)
    free = shutil.disk_usage(TIER_DIR).free
    check(free >= 1.5 * total, f"chaos path: {free} B free under "
                               f"{TIER_DIR}, short of {1.5 * total:.0f}")
    log(f"  padded clusters {total} B; {drawn.size} distinct queries "
        f"drawn; {free / 2**30:.2f} GiB free under {TIER_DIR}")
    out: dict = {}
    counts = {name: 0 for name in COUNTED}
    try:
        for label, dt, skew, share, margin in CHAOS_RUNS:
            past = share > 4
            ops.reset_launches()
            rep, secs = sync_time(lambda: chaos_experiment(
                index, q_np, gt, seed=seed, n_queries=CHAOS_QUERIES,
                replicas=2, deadline_ms=50.0, interval_s=CHAOS_INTERVAL_S,
                budget_bytes=total // share, lut_dtype=dt,
                nprobe=CHAOS_NPROBE, k=K, skew=skew, promote_margin=margin,
                spill_root=TIER_DIR))
            run_launches = dict(ops.launches)
            try:
                check_floors(rep, degraded=past)
            except RuntimeError as e:
                raise SmokeFailure(f"X {label}: {e}") from e
            lc, dc = (("lut_build_q", "pq_scan_dc_q") if dt == "uint8"
                      else ("lut_build", "pq_scan_dc"))
            check(run_launches[lc] > 0 and run_launches[dc] > 0,
                  f"X {label}: {lc} / {dc} never launched: {run_launches}")
            for name in COUNTED:
                counts[name] += run_launches[name]
            check(list(TIER_DIR.iterdir()) == [],
                  f"X {label}: spills left under {TIER_DIR}")
            fs = rep["fault_stats"]
            log(f"  X {label} ({'uniform' if skew == 0 else f'Zipf({skew})'}"
                f" draws, 1/{share} resident, {total // share} B, promote "
                f"margin {margin:g}): "
                f"availability {rep['availability']:.4f}, "
                f"answered {rep['answered']}, failed {rep['failed']}, shed "
                f"{rep['shed']}, degraded {rep['degraded']}, deadline "
                f"missed {rep['deadline_missed']}, retries "
                f"{rep['retries']}, failed batches {rep['batch_failures']}, "
                f"breakers {rep['breaker']}; corrupt_results 0 (every "
                f"non-degraded answer == the fault-free fleet's, bit for "
                f"bit); recall@{K} {rep['recall']:.4f}, non-degraded "
                f"{rep['recall_non_degraded']:.4f}; wall p50 "
                f"{rep['p50_ms']:.3f} ms, p99 {rep['p99_ms']:.3f} ms; "
                f"cluster {rep['corrupted']} rotted, healed by "
                f"{rep['healed_by']}, verify {rep['verify']['corrupt']} "
                f"corrupt / {rep['verify']['rebuilt']} rebuilt, "
                f"quarantined {rep['quarantined']}; tier degraded gathers "
                f"{rep['degraded_gathers']}, dropped probes "
                f"{rep['dropped_probes']}; {secs:.1f} s; launches "
                f"{run_launches}")
            log(f"    fault_stats {fs}")
            out[label] = {k: v for k, v in rep.items() if k != "verify"}
            out[label]["verify"] = {k: rep["verify"][k] for k in
                                    ("corrupt", "rebuilt", "quarantined")}
            out[label].update(secs=secs, launches=run_launches, skew=skew,
                              budget_bytes=total // share,
                              promote_margin=margin)
    finally:
        shutil.rmtree(TIER_DIR, ignore_errors=True)
    # A-D at one served batch's shape (8 queries x nprobe 8), after the
    # counts were read
    q8 = queries[:CHAOS_BATCH]
    probes, _ = cluster_locate(q8, index.centroids, CHAOS_NPROBE,
                               block=QUERY_CHUNK)
    res = (q8[:, None, :] - index.centroids[probes]).reshape(-1, D)
    flat = probes.reshape(-1)
    where = f"chaos batch T={res.shape[0]} C={clusters.cmax}"
    log("kernels vs plain, one served chaos batch:")
    lut, qlut, err_a, _ = check_lut(ops, ref, adc, res.contiguous(),
                                    index.codebook.codebooks,
                                    index.codebook.sqnorms, where)
    errs = check_scan(ops, adc.adc_distances, adc.adc_distances_quantized,
                      lut, qlut, clusters.codes.index_select(0, flat),
                      clusters.sizes.index_select(0, flat), where)
    out["batch_check"] = {"T": int(res.shape[0]), "lut_build": err_a,
                          **errs}
    return out, counts


# -- U: the SLO autotuner at N = 1M, D = 128 ----------------------------------
U_N, U_NLIST, U_QUERIES, U_BUDGET, U_BATCH = 1_000_000, 4096, 256, 8, 32
U_SPACE = dict(m=(16, 32, 64), nprobe=(8, 32, 96), lut_dtype=("uint8", "f32"),
               buckets=((1, 2, 4, 8, 16, 32),), tasks_per_shard=(1024,),
               cache_capacity_bytes=(0, 1 << 24))
# (modeled, survivors, pruned) for U_SPACE at U's pricing, as
# tests/test_torch_autotune.py pins them against the reference
U_SHORTLIST = (36, 18, 18)
# the paper's bar, then one the frontier meets (m=16 reads recall@10
# ~0.10 on this corpus, m=32 ~0.20), so the winner's branch runs too
U_SLOS = {"paper": (0.8, 50.0), "met": (0.15, math.inf)}


def tuner_kernel_checks(ops, ref, adc, indexes, frontier, queries) -> dict:
    """A-D against their plain versions on each index the tuner built, at
    one full calibration batch (32 queries) and the largest nprobe
    measured at that m: the widths (dsub 8, 4, 2) and padded clusters
    of the tuner's builds, which no other phase gives the kernels."""
    from repro_torch.core.search import cluster_locate
    out = {}
    q = queries[:U_BATCH].float()
    for m in sorted(indexes):
        view, cl = indexes[m].search_view, indexes[m].clusters
        nprobe = max(e["nprobe"] for e in frontier if e["m"] == m)
        probes, _ = cluster_locate(q, view.centroids, nprobe,
                                   block=QUERY_CHUNK)
        res = (q[:, None, :] - view.centroids[probes]).reshape(-1, D)
        flat = probes.reshape(-1)
        where = (f"tuner m={m} dsub={D // m} T={res.shape[0]} "
                 f"C={cl.cmax}")
        lut, qlut, err_a, _ = check_lut(ops, ref, adc, res.contiguous(),
                                        view.codebook.codebooks,
                                        view.codebook.sqnorms, where)
        errs = check_scan(ops, adc.adc_distances,
                          adc.adc_distances_quantized, lut, qlut,
                          cl.codes.index_select(0, flat),
                          cl.sizes.index_select(0, flat), where)
        out[str(m)] = {"T": int(res.shape[0]), "C": int(cl.cmax),
                       "nprobe": nprobe, "lut_build": err_a, **errs}
    return out


def autotune_path(ops, ref, adc, seed: int, device: str = "cuda"):
    """The SLO-driven tuner (core/autotune.py through autotune_service) on
    a corpus at the main path's width: N = 1M, D = 128, 64 components,
    256 queries with exact ground truth, nlist 4,096, CB 256, at most 8
    candidates measured, 400 calibration requests at 2,000 QPS, skew
    1.1.  First under the paper's bar SLO(recall@10 >= 0.8, p99 <= 50
    ms), where either outcome is a result (a validated spec that meets
    the SLO, or SLOInfeasible with its frontier); then, if that was
    infeasible, under one the frontier meets, so the winner's checks
    (spec, save -> load, served == search_ivfpq) run on the card.  After
    each run's counts were read, A-D are held to their plain versions on
    every index it built.  The latencies are PIM-paced: each batch is
    charged its modeled UPMEM time, not the card's.  Returns the report
    and the phase's launch counts (both runs)."""
    from repro_torch.core.search import SearchParams, search_ivfpq
    from repro_torch.data import make_clustered_corpus
    from repro_torch.service import (SLO, ServiceSpec, SLOInfeasible,
                                     TuneSpace, autotune_service)

    ds, t_corpus = sync_time(lambda: make_clustered_corpus(
        seed, U_N, D, n_queries=U_QUERIES, n_components=64, k_gt=K,
        device=device))
    space = TuneSpace(**U_SPACE)
    log(f"  corpus {t_corpus:.1f} s")
    out = {"corpus_s": t_corpus}
    counts = {name: 0 for name in COUNTED}
    for run, (recall, p99) in U_SLOS.items():
        slo = SLO(recall_at_k=recall, p99_ms=p99)
        ops.reset_launches()
        t0 = time.perf_counter()
        svc = None
        try:
            svc, res = autotune_service(
                ds.points, slo, queries=ds.queries,
                groundtruth=ds.groundtruth, space=space, nlist=U_NLIST,
                cb=CB, ranks=4, calibration_requests=N_SERVE,
                calibration_qps=2000.0, calibration_skew=1.1,
                max_wait_s=2e-3, validate_budget=U_BUDGET, seed=seed,
                device=device)
            outcome, detail = "winner", res.report()
        except SLOInfeasible as e:
            res, outcome, detail = e, "infeasible", str(e)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run_launches = dict(ops.launches)
        frontier = res.frontier
        log(f"  U {run} SLO {slo}: {outcome}, {res.modeled} candidates "
            f"modeled, {len(res.survivors)} survivors, {res.pruned} "
            f"pruned; {secs:.1f} s")
        for e in frontier:
            log(f"    m={e['m']} nprobe={e['nprobe']} lut={e['lut_dtype']} "
                f"cache={e['cache_capacity_bytes']}: predicted "
                f"{e['predicted_ms']:.3f} ms, recall@{K} {e['recall']:.4f}, "
                f"paced p50 {e['p50_ms']:.3f} / p99 {e['p99_ms']:.3f} ms, "
                f"QPS {e['qps']:.1f} (modeled UPMEM time), meets SLO "
                f"{e['meets_slo']}")
        log("    index builds (s): " + ", ".join(
            f"m={m} {t:.2f}" for m, t in sorted(res.build_s.items())))
        shortlist = (res.modeled, len(res.survivors), res.pruned)
        check(shortlist == U_SHORTLIST, f"U {run}: shortlist {shortlist} "
                                        f"!= the pinned {U_SHORTLIST}")
        pms = [e["predicted_ms"] for e in frontier]
        check(pms == sorted(pms), f"U {run}: predicted ms not "
                                  f"non-decreasing: {pms}")
        check([(e["m"], e["nprobe"], e["lut_dtype"],
                e["cache_capacity_bytes"]) for e in frontier]
              == [(c.m, c.nprobe, c.lut_dtype, c.cache_capacity_bytes)
                  for c in res.survivors[:len(frontier)]],
              f"U {run}: the frontier is not the shortlist's "
              f"cheapest-first order")
        for dt in {e["lut_dtype"] for e in frontier}:
            lc, dc = (("lut_build_q", "pq_scan_dc_q") if dt == "uint8"
                      else ("lut_build", "pq_scan_dc"))
            check(run_launches[lc] > 0 and run_launches[dc] > 0,
                  f"U {run}: {lc} / {dc} never launched: {run_launches}")
        rep = {"slo": [recall, None if math.isinf(p99) else p99],
               "outcome": outcome, "detail": detail, "secs": secs,
               "modeled": res.modeled, "survivors": len(res.survivors),
               "pruned": res.pruned, "frontier": frontier,
               "build_s": {str(m): t for m, t in res.build_s.items()},
               "launches": run_launches}
        if outcome == "winner":
            spec, m = res.spec, res.measured
            check(spec.validate() is spec, f"U {run}: the emitted spec "
                                           f"does not validate")
            path = spec.save(ROOT / "build" / "autotune_spec.json")
            check(ServiceSpec.load(path) == spec, f"U {run}: save -> load "
                                                  f"changed the spec")
            path.unlink()
            check(slo.met_by(m["recall"], m["p99_ms"]),
                  f"U {run}: the winner misses the SLO: {m}")
            d, i = svc.search(ds.queries.float().cpu().numpy())
            view = res.index
            wd, wi = (x.cpu().numpy() for x in search_ivfpq(
                view.search_view, view.clusters, ds.queries.float(),
                SearchParams(nprobe=spec.nprobe, k=K, use_kernels=True,
                             lut_dtype=spec.lut_dtype)))
            check(np.array_equal(d, wd) and np.array_equal(i, wi),
                  f"U {run}: autotune_service's search differs from "
                  f"search_ivfpq over result.index")
            svc.shutdown()
            log(f"  U {run}: winner m={spec.index.m} nprobe={spec.nprobe} "
                f"lut={spec.lut_dtype} cache={spec.cache_capacity_bytes} "
                f"buckets {spec.buckets}: recall@{K} {m['recall']:.4f}, "
                f"paced p50 {m['p50_ms']:.3f} / p99 {m['p99_ms']:.3f} ms, "
                f"QPS {m['qps']:.1f}; spec validated, save -> load equal, "
                f"the service's search == search_ivfpq bit for bit")
            rep.update(winner=spec.to_dict(), measured=m)
        else:
            check(len(frontier) == min(U_BUDGET, len(res.survivors)),
                  f"U {run}: the frontier holds {len(frontier)} entries")
            check(not any(e["meets_slo"] for e in frontier),
                  f"U {run}: SLOInfeasible with a frontier entry that "
                  f"meets the SLO")
            log(f"  U {run}: SLOInfeasible: {detail}")
        # after the counts were read
        log(f"kernels vs plain, the tuner's builds ({run} SLO):")
        rep["kernel_checks"] = tuner_kernel_checks(
            ops, ref, adc, res.indexes, frontier, ds.queries)
        for name in COUNTED:
            counts[name] += run_launches[name]
        out[run] = rep
        del svc, res
        if device == "cuda":
            torch.cuda.empty_cache()
        if outcome == "winner":
            break                 # the winner's branch has run
    out.update(outcome=out["paper"]["outcome"], launches=counts,
               secs=sum(out[r]["secs"] for r in U_SLOS if r in out))
    log(f"  U launches {counts}")
    return out, counts


# ---------------------------------------------------------------------------
# The paper-side variants and the entry points (V1, V2, L1)
# ---------------------------------------------------------------------------

V_TRAIN = 131_072              # DPQ training rows: (N, M, CB) f32 ~2.1 GB
V_CHUNK = 1 << 20              # rows re-encoded at once
V2_SCALES = (1.0, 0.5, 0.25)   # the uint8 grid, then finer ones
V2_TASKS = 1024                # tasks of one integer LC / DC step
V2_FLOOR = 0.8                 # top-1 agreement, tests/test_adc.py:83-97
V_SPEC = ROOT / "build" / "variants_spec.json"


def _rows_residuals(index, points, rows, cluster_of):
    """Residuals of the index rows ``rows`` (positions in the index's
    cluster order): the point minus its cluster's centroid, f32."""
    return (points[index.ids[rows].long()].float()
            - index.centroids[cluster_of[rows]])


def _recon_mse(cb, res) -> float:
    from repro_torch.core.pq import decode_pq, encode_pq
    err = res - decode_pq(cb, encode_pq(cb, res))
    return float((err * err).sum(-1).mean())


def dpq_path(index, points, queries, rec, gt, seed: int):
    """V1: a DPQ codebook trained on the card (``train_dpq``'s defaults:
    300 Adam steps from a k-means warm start) on the residuals of V_TRAIN
    index rows drawn from ``seed``; every row re-encoded with it in
    chunks (``IVFPQIndex._replace``, then ``pad_clusters``); the queries
    searched through A-D at f32 and uint8.  Returns (report, the DPQ
    index, its padded clusters)."""
    from repro_torch.core import (SearchParams, encode_pq, pad_clusters,
                                  recall_at_k, search_ivfpq, train_dpq)
    dev = index.codes.device
    n = index.codes.shape[0]
    cluster_of = torch.repeat_interleave(
        torch.arange(index.nlist, device=dev), index.sizes.long())
    g = torch.Generator().manual_seed(seed + 10)
    rows = torch.randperm(n, generator=g)[:min(V_TRAIN, n)].to(dev)
    res = _rows_residuals(index, points, rows, cluster_of)
    (cb, losses), t_train = sync_time(lambda: train_dpq(g, res, M, CB))
    losses = losses.cpu().numpy()
    check(bool(np.isfinite(losses).all()), "V1: non-finite DPQ loss")
    check(losses[-1] < losses[0], f"V1: the DPQ loss did not fall: "
                                  f"{losses[0]} -> {losses[-1]}")
    mse = {"dpq": _recon_mse(cb, res),
           "kmeans": _recon_mse(index.codebook, res)}
    log(f"  V1 train_dpq on {len(rows)} residuals: {t_train:.2f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; reconstruction MSE on "
        f"these rows: DPQ {mse['dpq']:.4f}, k-means {mse['kmeans']:.4f}")
    del res

    def reencode():
        codes = torch.empty_like(index.codes)
        for s in range(0, n, V_CHUNK):
            r = _rows_residuals(index, points, torch.arange(
                s, min(s + V_CHUNK, n), device=dev), cluster_of)
            codes[s:s + V_CHUNK] = encode_pq(cb, r)
        return codes
    codes, t_enc = sync_time(reencode)
    dpq_index = index._replace(codebook=cb, codes=codes)
    dpq_cl, t_pad = sync_time(lambda: pad_clusters(dpq_index))
    recoded = float((codes != index.codes).any(1).float().mean())
    log(f"  V1 re-encode {n} rows {t_enc:.2f} s, pad_clusters {t_pad:.2f} "
        f"s; share of rows whose code changed {recoded:.4f}")
    out = {"train_rows": int(len(rows)), "train_s": t_train,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "loss_every_30": [float(x) for x in losses[::30]],
           "recon_mse": mse, "reencode_s": t_enc, "pad_s": t_pad,
           "rows_recoded": recoded, "cmax": int(dpq_cl.cmax)}
    chunks = -(-queries.shape[0] // QUERY_CHUNK)
    for dt in ("f32", "uint8"):
        p = SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                         use_kernels=True, lut_dtype=dt)
        search_ivfpq(dpq_index, dpq_cl, queries[:QUERY_CHUNK], p)  # warm-up
        (d, i), secs = sync_time(lambda: search_ivfpq(dpq_index, dpq_cl,
                                                      queries, p))
        check(d.shape == (queries.shape[0], K) and bool(
            torch.isfinite(d).all()) and bool((i >= 0).all()),
              f"V1 {dt}: non-finite distances or padding ids")
        r = recall_at_k(i[:gt.shape[0]], gt)
        out[dt] = {"recall": r, "ms_per_chunk": secs * 1e3 / chunks,
                   "kmeans_recall": rec[dt]}
        log(f"  V1 DPQ search lut={dt}: recall@{K} {r:.4f} on "
            f"{gt.shape[0]} queries (k-means index {rec[dt]:.4f}); "
            f"{secs * 1e3 / chunks:.3f} ms a {QUERY_CHUNK}-query chunk")
    drop = out["f32"]["recall"] - out["uint8"]["recall"]
    check(drop <= 0.01, f"V1: uint8 recall drop {drop:.4f} > 0.01")
    return out, dpq_index, dpq_cl


def multiplierless_path(ops, index, clusters, probes, res, f32_ids):
    """V2: the multiplier-less LC and DC (paper §III-A) on one query
    chunk's tasks (T = Qc x NPROBE) of the k-means index.  At each scale
    of V2_SCALES the codebook and residuals are quantized on the card
    and on the CPU (equal integers), and every task's integer LUT built
    without multiplies equals the multiplied one bit for bit (the paper's
    losslessness); at the uint8 grid (scale 1.0) it also equals the
    CPU's.  The integer DC runs over the probed clusters with padded rows
    at INT_PAD, then a top-K per query (overlap with the f32 search's)
    and the top-1 agreement with the float DC per non-empty task (the
    reference's floor V2_FLOOR, held at the coarsest scale that meets
    it).  Then the integer LC and DC are timed against A and C on the
    same tasks at scale 1.0; nothing is gated on the times."""
    from repro_torch.core import multiplierless as ml
    from repro_torch.core.adc import adc_distances, build_lut_batch
    from repro_torch.core.pq import PQCodebook
    t = res.shape[0]
    qc, p = probes.shape
    flat = probes.reshape(-1)
    sizes = clusters.sizes.index_select(0, flat)
    c = clusters.cmax
    ids = clusters.ids.index_select(0, flat).view(qc, p * c)
    cb = index.codebook
    cb_cpu = PQCodebook(cb.codebooks.cpu(), cb.sqnorms.cpu())
    res_cpu = res.cpu()
    live = sizes > 0
    lut_f = build_lut_batch(cb, res)
    nn_f = torch.empty(t, dtype=torch.long, device=res.device)
    for a in range(0, t, V2_TASKS):
        codes = clusters.codes.index_select(0, flat[a:a + V2_TASKS])
        nn_f[a:a + V2_TASKS] = adc_distances(lut_f[a:a + V2_TASKS], codes,
                                             sizes[a:a + V2_TASKS]).argmin(1)
    pad = (torch.arange(c, device=res.device)[None, :] >= sizes[:, None])
    out = {"T": t, "C": c, "nonempty_tasks": int(live.sum()), "scales": {}}
    for scale in V2_SCALES:
        qcb = ml.quantize_codebook(cb, scale)
        rq = ml.quantize_residual(res, qcb.scale)
        qcb_c = ml.quantize_codebook(cb_cpu, scale)
        rq_c = ml.quantize_residual(res_cpu, qcb_c.scale)
        check(torch.equal(qcb.codebooks_q.cpu(), qcb_c.codebooks_q)
              and torch.equal(rq.cpu(), rq_c),
              f"V2 scale {scale}: the card's quantized integers differ "
              f"from the CPU's")
        lut = torch.empty((t, M, CB), dtype=torch.int32, device=res.device)
        dist = torch.empty((t, c), dtype=torch.int32, device=res.device)
        for a in range(0, t, V2_TASKS):
            s = slice(a, a + V2_TASKS)
            lut[s] = ml.build_lut_multiplierless(qcb, rq[s])
            check(torch.equal(lut[s], ml.build_lut_int_reference(qcb, rq[s])),
                  f"V2 scale {scale}: the multiplier-less LUT differs from "
                  f"the multiplied one on tasks {a}+ (not lossless)")
            if scale == 1.0:
                check(torch.equal(lut[s].cpu(), ml.build_lut_multiplierless(
                    qcb_c, rq_c[s])), f"V2: the card's integer LUT differs "
                                      f"from the CPU's on tasks {a}+")
            dist[s] = ml.scan_codes_int(
                lut[s], clusters.codes.index_select(0, flat[s]))
        cpu_note = " and equal to the CPU's" if scale == 1.0 else ""
        dist.masked_fill_(pad, ml.INT_PAD)
        agree = float((dist.argmin(1) == nn_f)[live].float().mean())
        _, top = torch.topk(dist.view(qc, p * c), K, dim=1, largest=False)
        top_ids = torch.gather(ids, 1, top)
        overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                                 for a, b in zip(top_ids.cpu(),
                                                 f32_ids.cpu())]))
        clipped = float((rq.abs() == 255).float().mean())
        out["scales"][str(scale)] = {
            "lossless_tasks": t, "top1_agreement": agree,
            "topk_overlap_with_f32": overlap, "residuals_clipped": clipped,
            "max_lut_entry": int(lut.max()),
            "max_distance": int(dist[~pad].max())}
        log(f"  V2 scale {scale}: integer LUT lossless on all {t} tasks"
            f"{cpu_note}; "
            f"top-1 agreement with the float DC {agree:.4f} on "
            f"{int(live.sum())} non-empty tasks; top-{K} overlap with the "
            f"f32 search {overlap:.4f}; residual entries clipped at 255 "
            f"{clipped:.4f}")
        if scale == 1.0:
            grid = (qcb, rq, lut)                 # timed below
    held = [sc for sc in V2_SCALES
            if out["scales"][str(sc)]["top1_agreement"] >= V2_FLOOR]
    check(bool(held), f"V2: top-1 agreement below {V2_FLOOR} at every "
                      f"scale {V2_SCALES}")
    out["floor_scale"] = held[0]
    log(f"  V2 the reference's top-1 floor {V2_FLOOR} holds at scale "
        f"{held[0]} (coarsest of {held})")

    qcb, rq, lut = grid
    codes_all = clusters.codes.index_select(0, flat)
    lut_a = ops.lut_build(res, cb.codebooks, cb.sqnorms)
    times = {
        "lc_int_ms": event_ms(lambda: ml.build_lut_multiplierless(qcb, rq),
                              reps=5, warm=1, queued=True),
        "lc_a_ms": event_ms(lambda: ops.lut_build(res, cb.codebooks,
                                                  cb.sqnorms),
                            reps=20, queued=True),
        "dc_int_ms": event_ms(lambda: ml.scan_codes_int(lut, codes_all),
                              reps=5, warm=1, queued=True),
        "dc_c_ms": event_ms(lambda: ops.pq_scan_dc(lut_a, codes_all, sizes),
                            reps=20, queued=True)}
    out.update(times)
    log(f"  V2 on the same {t} tasks (C={c}), CUDA events: integer LC "
        f"{times['lc_int_ms']:.4f} ms against A {times['lc_a_ms']:.4f} ms; "
        f"integer DC {times['dc_int_ms']:.4f} ms against C "
        f"{times['dc_c_ms']:.4f} ms")
    return out


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clone(x):
    if x is None:
        return None
    if isinstance(x, tuple):                  # a QuantizedLUT
        return type(x)(*(t.clone() for t in x))
    return x.clone()


def capture_launches(ops, seen: dict, label: list):
    """Wrap the kernel wrappers so that each kernel's last call with rows
    per shape, keyed (kernel, M, CB, code dtype[, k for E/F; "dense" or
    "slots" for C/D]; TS by slot: ("ts_topk", P, C, k)), is copied to
    ``seen`` as (run label, inputs); ``label[0]`` names the run.  The
    wrapped call launches and counts as before.  Returns a function that
    restores the wrappers."""
    from repro_torch.core.adc import QuantizedLUT
    names = ("lut_build", "lut_build_q", "lut_build_bf16", "pq_scan_dc",
             "pq_scan_topk", "ts_topk")
    orig = {n: getattr(ops, n) for n in names}

    def keep(key, args):
        seen[key] = (label[0], tuple(_clone(x) for x in args))

    def lc(name):
        def wrapped(residuals, codebooks, sqnorms):
            if residuals.shape[0]:
                keep((name, *codebooks.shape[:2], None),
                     (residuals, codebooks, sqnorms))
            return orig[name](residuals, codebooks, sqnorms)
        return wrapped

    def table_of(lut):
        table = lut.lut_q if isinstance(lut, QuantizedLUT) else lut
        return ops.KIND_SUFFIX[ops.table_kind(lut)], table

    def dc(lut, codes, sizes=None, **kw):
        sfx, table = table_of(lut)
        slots = kw.get("slots")
        if table.shape[0]:
            keep(("pq_scan_dc" + sfx, *table.shape[1:], str(codes.dtype),
                  "dense" if slots is None else "slots"),
                 (lut, codes, sizes, slots))
        return orig["pq_scan_dc"](lut, codes, sizes, **kw)

    def topk(lut, codes, ids, sizes, k, **kw):
        sfx, table = table_of(lut)
        if table.shape[0]:
            keep(("pq_scan_topk" + sfx, *table.shape[1:], str(codes.dtype),
                  k), (lut, codes, ids, sizes, kw.get("slots")))
        return orig["pq_scan_topk"](lut, codes, ids, sizes, k, **kw)

    def ts(dists, slots, sizes, ids, qc, k):
        if dists.shape[0]:
            keep(("ts_topk", dists.shape[0] // qc, dists.shape[1], k),
                 (dists, slots, sizes, ids))
        return orig["ts_topk"](dists, slots, sizes, ids, qc, k)

    ops.lut_build, ops.lut_build_q = lc("lut_build"), lc("lut_build_q")
    ops.lut_build_bf16 = lc("lut_build_bf16")
    ops.pq_scan_dc, ops.pq_scan_topk, ops.ts_topk = dc, topk, ts

    def restore():
        for n, f in orig.items():
            setattr(ops, n, f)
    return restore


def check_captured(ops, ref, adc, seen: dict, phase: str = "L1") -> dict:
    """Each captured launch's inputs through its kernel again, held to the
    plain version: A and B with check_lut, A-bf16 with check_lut_bf16, C,
    D or C-bf16 with check_scan, E, F or E-bf16 with check_topk, TS by
    slot with check_ts.  Returns {where: max errors}."""
    out = {}
    for key, (label, args) in sorted(seen.items(), key=str):
        if key[0] == "ts_topk":
            dists, slots, sizes, ids = args
            qc = dists.shape[0] // key[1]
            where = (f"{phase} {label}: ts_topk qc={qc} P={key[1]} "
                     f"C={key[2]}")
            check_ts(ops, dists, slots, sizes, ids, qc, key[3], where)
            out[where] = {"ts_topk": 0.0}
            continue
        name, m, cb = key[:3]
        where = f"{phase} {label}: {name} M={m} CB={cb}"
        if name == "lut_build_bf16":
            res, books, sqn = args
            where += f" dsub={books.shape[2]} T={res.shape[0]}"
            _, err = check_lut_bf16(ops, adc, res, books, sqn, where,
                                    chunk=QUERY_CHUNK * NPROBE)
            out[where] = {name: err}
        elif name in ("lut_build", "lut_build_q"):
            res, books, sqn = args
            where += f" dsub={books.shape[2]} T={res.shape[0]}"
            _, _, err_a, count_b = check_lut(ops, ref, adc, res, books, sqn,
                                             where)
            out[where] = {"lut_build": err_a, "lut_build_q_counts": count_b}
        elif name.startswith("pq_scan_dc"):
            lut, codes, sizes, slots = args
            where += (f" T={codes.shape[0]} C={codes.shape[1]} {key[3]}"
                      if slots is None else
                      f" T={slots.shape[0]} P={codes.shape[0]} "
                      f"C={codes.shape[1]} {key[3]} by slot")
            lut, q = (None, lut) if name == "pq_scan_dc_q" else (lut, None)
            out[where] = check_scan(ops, adc.adc_distances,
                                    adc.adc_distances_quantized, lut, q,
                                    codes, sizes, where, slots)
        else:
            lut, codes, ids, sizes, slots = args
            where += f" P={codes.shape[0]} C={codes.shape[1]} {key[3]}"
            out[where] = {name: check_topk(ops, lut, codes, ids, sizes,
                                           key[4], where, slots)}
    return out


def entry_points_path(ops, ref, adc, device: str = "cuda"):
    """L1: the port's entry points in this process, so the launch counters
    see them: ``repro_torch.launch.serve --ann`` on the virtual and the
    wall clock, ``--spec`` from a sharded uint8 spec saved here, and
    ``--autotune`` (the paper's SLO, the entry point's defaults); then
    examples/torch_quickstart.py and examples/torch_distributed_anns.py.
    Each serve run must return its service (an infeasible SLO exits) and
    serve what a direct ``svc.search`` of the same queries gives (local:
    bit for bit; sharded: distances at rtol 1e-5, ids up to k-th-place
    ties); the quickstart must reach 0.8 on its three searches.  Each
    run's launches are read as it ends (a serve run's before its direct
    search).  Each kernel's last launch per shape in these runs is kept
    and, after the runs, held to its plain version (check_captured): the
    entry points give the kernels shapes (dsub 4 and 2, CB 64, k 4) that
    no other phase does.  Returns (report, counts)."""
    from repro_torch.launch import serve
    from repro_torch.service import IndexSpec, ServiceSpec
    spec = ServiceSpec(engine="sharded", replicas=1, nprobe=8, k=10,
                       lut_dtype="uint8", index=IndexSpec(nlist=32, m=8,
                                                          cb=64),
                       n_shards=4, tasks_per_shard=256, buckets=(1, 2, 4),
                       max_wait_s=1e-3)
    V_SPEC.parent.mkdir(parents=True, exist_ok=True)
    path = spec.save(V_SPEC)
    runs = (("serve --ann", ["--ann"], "local"),
            ("serve --ann --clock wall", ["--ann", "--clock", "wall"],
             "local"),
            ("serve --ann --spec (sharded, uint8) --clock wall",
             ["--ann", "--spec", str(path), "--clock", "wall"], "sharded"),
            ("serve --ann --autotune", ["--ann", "--autotune"], "local"))
    counts = {name: 0 for name in COUNTED}
    out = {}
    seen, label = {}, [None]
    restore = capture_launches(ops, seen, label)
    try:
        for label[0], argv, engine in runs:
            ops.reset_launches()
            t0 = time.perf_counter()
            try:
                svc, reqs, _ = serve.serve_ann(serve.build_parser().parse_args(
                    [*argv, "--device", device]))
            except SystemExit as e:
                check(False, f"L1 {label[0]}: exited {e.code}")
            secs = time.perf_counter() - t0
            launched = dict(ops.launches)
            try:
                qs = np.stack([r.query for r in reqs]).astype(np.float32)
                d, i = svc.search(qs)
            finally:
                svc.shutdown()
            got_d = np.stack([r.dists for r in reqs])
            got_i = np.stack([r.ids for r in reqs])
            if engine == "local":
                check(np.array_equal(got_d, d) and np.array_equal(got_i, i),
                      f"L1 {label[0]}: served != svc.search bit for bit")
            else:
                check(np.allclose(got_d, d, rtol=1e-5, atol=1e-5)
                      and tie_diff_rows(got_d, got_i, d, i, 1e-5, 1e-5) == 0,
                      f"L1 {label[0]}: served != svc.search")
            check(len(reqs) == 64, f"L1 {label[0]}: served {len(reqs)}")
            for name in COUNTED:
                counts[name] += launched[name]
            out[label[0]] = {"secs": secs, "launches": launched}
            log(f"  L1 {label[0]}: served == direct, {secs:.2f} s, "
                f"launches {launched}")
        V_SPEC.unlink()
        for label[0] in ("torch_quickstart", "torch_distributed_anns"):
            ops.reset_launches()
            t0 = time.perf_counter()
            res = _load_example(label[0]).main(["--device", device])
            secs = time.perf_counter() - t0
            launched = dict(ops.launches)
            for k in COUNTED:
                counts[k] += launched[k]
            out[label[0]] = {"secs": secs, "result": res,
                             "launches": launched}
            log(f"  L1 examples/{label[0]}.py: {secs:.2f} s, launches "
                f"{launched}")
    finally:
        restore()
    q = out["torch_quickstart"]["result"]
    check(q["recall"] >= 0.8 and min(q["recall_kernels"].values()) >= 0.8,
          f"L1 quickstart below 0.8: {q}")
    dist = out["torch_distributed_anns"]["result"]
    check(len(dist) == 2 and all(r["recall"] >= 0.8 for r in dist.values()),
          f"L1 distributed example: {dist}")
    if device == "cuda":
        for k in ("lut_build", "pq_scan_topk"):
            check(out["torch_distributed_anns"]["launches"][k] > 0,
                  f"L1: {k} never launched by the distributed example")
    # after every run's counts were read
    log(f"kernels vs plain, the {len(seen)} launch shapes of L1:")
    out["kernel_checks"] = check_captured(ops, ref, adc, seen)
    held = {key[0] for key in seen}
    check(held >= {k for k in COUNTED if counts[k]},
          f"L1: launched {sorted(k for k in COUNTED if counts[k])} but held "
          f"only {sorted(held)} to plain")
    return out, counts


def variants_path(ops, ref, adc, index, clusters, points, queries,
                  results, rec, gt, seed: int):
    """V1, V2 and L1 on the main path's index (see the module docstring).
    The launch counters are reset before V1 and read after its searches,
    and read per run in L1; the kernel checks and V2's timings launch A-D
    outside those windows.  Returns (report, the phase's launch counts)."""
    from repro_torch.core.search import cluster_locate
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launches()
    v1, dpq_index, dpq_cl = dpq_path(index, points, queries, rec, gt, seed)
    v1_launches = dict(ops.launches)
    # after the counts were read: A-D on the DPQ index's first chunk
    q0 = queries[:QUERY_CHUNK]
    probes, _ = cluster_locate(q0, index.centroids, NPROBE,
                               block=QUERY_CHUNK)
    res = (q0[:, None, :] - index.centroids[probes]).reshape(-1, D)
    res = res.contiguous()
    flat = probes.reshape(-1)
    where = f"DPQ index T={res.shape[0]} C={dpq_cl.cmax}"
    log("kernels vs plain, the DPQ index's first chunk:")
    lut, qlut, v1["a_err"], v1["b_count"] = check_lut(
        ops, ref, adc, res, dpq_index.codebook.codebooks,
        dpq_index.codebook.sqnorms, where)
    v1["scan_err"] = check_scan(
        ops, adc.adc_distances, adc.adc_distances_quantized, lut, qlut,
        dpq_cl.codes.index_select(0, flat),
        dpq_cl.sizes.index_select(0, flat), where)
    del dpq_index, dpq_cl, lut, qlut
    torch.cuda.empty_cache()
    v2 = multiplierless_path(ops, index, clusters, probes, res,
                             results["f32"][1][:QUERY_CHUNK])
    l1, l1_launches = entry_points_path(ops, ref, adc)
    counts = {k: v1_launches[k] + l1_launches[k] for k in COUNTED}
    run = {"V1": v1, "V2": v2, "L1": l1, "launches": counts,
           "secs": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  variants path {run['secs']:.1f} s; peak device memory "
        f"{run['peak_gib']:.2f} GiB; launches {counts}")
    return run, counts


# ---------------------------------------------------------------------------
# 13. The LM stack and the RAG path
# ---------------------------------------------------------------------------

# card vs CPU, f32 (matmuls in IEEE f32 on both): rtol 1e-4, atol 1e-3 or
# 1e-4 of the logits' scale where that is larger: sums in another order
# leave ~3e-5 of that scale, and the tied-embedding archs read logits up to
# ~39 (the others ~1.5), where a flat 1e-3 sits below that rounding
LM_TOL = (1e-4, 1e-3)
LM_ATOL_PER_SCALE = 1e-4


def _lm_atol(scale: float) -> float:
    return max(LM_TOL[1], LM_ATOL_PER_SCALE * scale)
LM_DECODE_TOL = 5e-3           # decode == forward, tests/test_archs_smoke.py
LM_SEQ, LM_CHUNKED_S = 16, 2048
LM2_ARCHS = ("llama32_vision_11b", "whisper_base")
LM2_BATCH, LM2_PROMPT, LM2_GEN = 4, 16, 16
# bf16 decode == forward: the two paths round activations to bf16 (8
# mantissa bits, 2^-9 relative) at other points (one token a GEMM against
# 16, other GEMM algorithms), and the difference compounds over the
# layers; held to a share of the logits' scale, on soft attention (every
# wq scaled by 2^-6, exact in bf16; see lm_full_arch)
LM2_REL_TOL = 5e-2
LM2_WQ_SCALE = 2.0 ** -6
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core peak


def _lm_inputs(cfg, batch: int, seq: int, seed: int):
    from repro_torch.launch.serve import context_len
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    n = context_len(cfg)
    ctx = (None if n is None else torch.from_numpy(
        rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)))
    return toks, ctx


def _lm_run(params, cfg, toks, ctx, steps: int):
    """forward logits, and ``steps`` decode steps' logits, on the device
    the tensors lie on."""
    from repro_torch.models import decode_step, encode, forward, init_caches
    dev = toks.device
    with torch.inference_mode():
        logits, _ = forward(params, cfg, toks, ctx=ctx)
        enc_out = encode(params, cfg, ctx) if cfg.is_encdec else None
        caches = init_caches(cfg, toks.shape[0], steps, device=dev)
        outs = []
        for t in range(steps):
            lg, caches = decode_step(
                params, cfg, toks[:, t:t + 1],
                torch.full((toks.shape[0],), t, device=dev), caches,
                ctx=None if cfg.is_encdec else ctx, enc_out=enc_out)
            outs.append(lg[:, 0])
    return logits, torch.stack(outs, 1)


def _max_err(a, b, vocab: int) -> float:
    return float((a[..., :vocab].float() - b[..., :vocab].float()
                  ).abs().max())


def lm_smoke_archs(seed: int, device: str) -> dict:
    """LM1: every arch at its smoke config, on weights drawn once on the
    CPU: the card's forward and decode steps == the CPU port's; decode ==
    forward on the card (MoE at capacity factor 8, as the reference's
    test); then S = 2,048 through the chunked path (causal skip, and the
    local window) held to the dense masked path on the card."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import attention, forward, init_params
    from repro_torch.models.common import tree_map
    out = {}
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch, smoke=True)
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        params = init_params(cfg, seed, device="cpu")
        toks, ctx = _lm_inputs(cfg, 2, LM_SEQ, seed)
        cpu = _lm_run(params, cfg, toks, ctx, LM_SEQ)
        p_dev = tree_map(lambda x: x.to(device), params)
        dev = _lm_run(p_dev, cfg, toks.to(device),
                      None if ctx is None else ctx.to(device), LM_SEQ)
        scale = float(cpu[0][..., :cfg.vocab_size].abs().max())
        errs = {"max_abs_logit": scale}
        for name, a, b in (("forward", dev[0], cpu[0]),
                           ("decode", dev[1], cpu[1])):
            a = a.cpu()
            check(bool(torch.isfinite(a[..., :cfg.vocab_size]).all()),
                  f"LM1 {arch}: non-finite {name} logits")
            check(torch.allclose(a, b, rtol=LM_TOL[0],
                                 atol=_lm_atol(scale)),
                  f"LM1 {arch}: card {name} != CPU (max |err| "
                  f"{_max_err(a, b, cfg.vocab_size):.3e}, logits up to "
                  f"{scale:.2f})")
            errs[name] = _max_err(a, b, cfg.vocab_size)
        errs["decode_vs_forward"] = _max_err(dev[1], dev[0], cfg.vocab_size)
        check(errs["decode_vs_forward"] < LM_DECODE_TOL,
              f"LM1 {arch}: decode != forward on the card "
              f"({errs['decode_vs_forward']:.3e})")
        out[arch] = errs
        log(f"  LM1 {arch}: card == CPU, forward max |err| "
            f"{errs['forward']:.2e}, decode {errs['decode']:.2e} (logits up "
            f"to {scale:.2f}); decode vs "
            f"forward on the card {errs['decode_vs_forward']:.2e}")
    # the chunked path at S = 2,048 (s * l > 1024^2) against the dense one
    for arch in ("qwen3_14b", "recurrentgemma_2b"):
        cfg = registry.get_config(arch, smoke=True)
        params = init_params(cfg, seed, device=device)
        toks, _ = _lm_inputs(cfg, 1, LM_CHUNKED_S, seed)
        toks = toks.to(device)
        with torch.inference_mode():
            (chunked, _), secs = sync_time(lambda: forward(params, cfg, toks))
            limit = attention._DENSE_SCORE_LIMIT
            attention._DENSE_SCORE_LIMIT = math.inf
            try:
                (dense, _), dense_secs = sync_time(
                    lambda: forward(params, cfg, toks))
            finally:
                attention._DENSE_SCORE_LIMIT = limit
        err = _max_err(chunked, dense, cfg.vocab_size)
        scale = float(dense[..., :cfg.vocab_size].abs().max())
        check(torch.allclose(chunked, dense, rtol=LM_TOL[0],
                             atol=_lm_atol(scale)),
              f"LM1 {arch} S={LM_CHUNKED_S}: chunked != dense ({err:.3e})")
        out[f"{arch} S={LM_CHUNKED_S} chunked"] = {
            "max_abs_err": err, "chunked_s": secs, "dense_s": dense_secs}
        log(f"  LM1 {arch} S={LM_CHUNKED_S}: chunked path == dense masked "
            f"path, max |err| {err:.2e} ({secs:.3f} s against "
            f"{dense_secs:.3f} s)")
    return out


def scale_wq(tree, factor: float) -> int:
    """Every attention's query weight (``wq``) times ``factor``, in place;
    returns how many were scaled."""
    n = 0
    for key, val in tree.items():
        if key == "wq":
            val.mul_(factor)
            n += 1
        elif isinstance(val, dict):
            n += scale_wq(val, factor)
        elif isinstance(val, list):
            n += sum(scale_wq(v, factor) for v in val)
    return n


def _cast_(tree, dtype) -> None:
    """Every floating tensor of a dict / list tree to ``dtype``, in place,
    one at a time (each old tensor is freed as its copy replaces it)."""
    for key, val in list(tree.items() if isinstance(tree, dict)
                         else enumerate(tree)):
        if isinstance(val, (dict, list)):
            _cast_(val, dtype)
        elif val.is_floating_point():
            tree[key] = val.to(dtype)


def _decode_vs_forward(params, cfg, prompts, ctx) -> dict:
    fwd, dec = _lm_run(params, cfg, prompts, ctx, prompts.shape[1])
    check(bool(torch.isfinite(fwd[..., :cfg.vocab_size]).all())
          and bool(torch.isfinite(dec[..., :cfg.vocab_size]).all()),
          f"LM2 {cfg.name}: non-finite logits")
    scale = float(fwd[..., :cfg.vocab_size].abs().max())
    err = _max_err(dec, fwd, cfg.vocab_size)
    return {"max_abs": err, "max_abs_logit": scale, "rel": err / scale,
            "argmax_agree": float((dec.argmax(-1) == fwd.argmax(-1))
                                  .float().mean())}


def _step_profile(fn, top: int = 6, warm: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler (CUDA activity only), after
    one unprofiled call if ``warm``: the device time it adds up, the
    kernels it launched, and the ``top`` kernels by device time.  Empty
    where the profiler records no device time.  (The profiler's own
    start-up inflates the host time of the profiled call, so the caller
    sets the idle share against an unprofiled time.)"""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    if not events:
        return {}
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_ms": sum(e.self_device_time_total
                             for e in events) / 1e3,
            "kernels": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "count": e.count,
                     "ms": e.self_device_time_total / 1e3}
                    for e in events[:top]]}


def lm_full_arch(arch: str, seed: int, device: str, smoke: bool = False
                 ) -> dict:
    """LM2: one arch at its full config on one card: weights drawn on the
    card tensor by tensor, their count against count_params_analytic;
    ``generate`` timed; one decode step timed by CUDA events against its
    bound (the bytes it must read: every weight but the embedding, which
    it gathers B rows of, the context and the caches; or the context K/V
    recompute's bf16 operations, whichever is larger); then the decode
    steps over the prompt against the forward over it, in bf16.

    That last check runs with every ``wq`` scaled by LM2_WQ_SCALE (exact
    in bf16).  At the reference's draw (``wq``'s fan-in is its heads
    axis) attention scores are large enough that softmax is a hard
    argmax, whose near-ties flip under any change of rounding, and the
    flips compound over the layers; so decode == forward is only a
    statement about the code on soft attention, and at the draw the
    difference is logged, not held.  The same weights, cast to f32 in
    place once the bf16 runs are done, show the conditioning on the card:
    f32 decode == forward is held at LM_DECODE_TOL with ``wq`` scaled,
    and logged at the draw (``wq`` scaled back, exactly)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import count_params_analytic
    from repro_torch.models import (decode_step, encode, init_caches,
                                    init_params)
    from repro_torch.models.common import count_params, tree_leaves
    cfg = registry.get_config(arch, smoke=smoke)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(lambda: init_params(cfg, seed,
                                                   device=device))
    n = count_params(params)
    check(n == count_params_analytic(cfg),
          f"LM2 {arch}: {n} parameters, count_params_analytic says "
          f"{count_params_analytic(cfg)}")
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    emb_bytes = params["embedding"].numel() * params["embedding"].element_size()
    toks, ctx = _lm_inputs(cfg, LM2_BATCH, LM2_PROMPT, seed)
    prompts = toks.to(device)
    ctx = None if ctx is None else ctx.to(device)
    toks_out, gen_s = sync_time(lambda: generate(cfg, params, prompts,
                                                 LM2_GEN, ctx=ctx))
    check(tuple(toks_out.shape) == (LM2_BATCH, LM2_PROMPT + LM2_GEN)
          and bool(((toks_out >= 0) & (toks_out < cfg.vocab_size)).all())
          and torch.equal(toks_out[:, :LM2_PROMPT], prompts),
          f"LM2 {arch}: generate returned {tuple(toks_out.shape)}")
    steps = LM2_PROMPT + LM2_GEN - 1
    # one step alone (the cache written at the same slot each time)
    with torch.inference_mode():
        enc_out = encode(params, cfg, ctx) if cfg.is_encdec else None
        caches = init_caches(cfg, LM2_BATCH, LM2_PROMPT + LM2_GEN,
                             device=device)
        pos = torch.full((LM2_BATCH,), LM2_PROMPT, device=device)
        tok = prompts[:, -1:]
        step_ms = event_ms(lambda: decode_step(
            params, cfg, tok, pos, caches,
            ctx=None if cfg.is_encdec else ctx, enc_out=enc_out), reps=10)
        profile = _step_profile(lambda: decode_step(
            params, cfg, tok, pos, caches,
            ctx=None if cfg.is_encdec else ctx, enc_out=enc_out))
    if profile:
        profile["idle_share"] = max(0.0, 1 - profile["device_ms"] / step_ms)
    step_bytes = (nbytes - emb_bytes
                  + LM2_BATCH * cfg.d_model * params["embedding"]
                  .element_size()
                  + sum(x.numel() * x.element_size()
                        for x in tree_leaves(caches))
                  + (0 if ctx is None or cfg.is_encdec
                     else ctx.numel() * ctx.element_size())
                  + (0 if enc_out is None
                     else enc_out.numel() * enc_out.element_size()))
    del caches, enc_out
    # the context K/V recompute: each cross layer projects every context
    # row to K and V (2 * d * 2 * kv * hd operations a row)
    n_cross = (cfg.n_layers if cfg.is_encdec
               else cfg.layer_types.count("cross_attn"))
    ctx_rows = 0 if ctx is None else LM2_BATCH * ctx.shape[1]
    step_ops = n_cross * ctx_rows * 2 * cfg.d_model * 2 * cfg.n_kv_heads \
        * cfg.head_dim
    bound = max(step_bytes / HBM_BYTES_PER_S, step_ops / BF16_OPS_PER_S)
    at_draw = _decode_vs_forward(params, cfg, prompts, ctx)
    n_wq = scale_wq(params, LM2_WQ_SCALE)
    held = _decode_vs_forward(params, cfg, prompts, ctx)
    check(held["rel"] <= LM2_REL_TOL,
          f"LM2 {arch}: decode vs forward (wq x {LM2_WQ_SCALE}) max |err| "
          f"{held['max_abs']:.4f} > {LM2_REL_TOL} x max |logit| "
          f"{held['max_abs_logit']:.4f}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the same weights in f32 (IEEE matmuls): decode vs forward with wq
    # scaled (held), then at the draw (logged)
    _cast_(params, torch.float32)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    held32 = _decode_vs_forward(params, cfg32, prompts, ctx)
    check(held32["max_abs"] < LM_DECODE_TOL,
          f"LM2 {arch}: f32 decode vs forward (wq x {LM2_WQ_SCALE}) max "
          f"|err| {held32['max_abs']:.3e} >= {LM_DECODE_TOL}")
    scale_wq(params, 1 / LM2_WQ_SCALE)
    at_draw32 = _decode_vs_forward(params, cfg32, prompts, ctx)
    run = {"params": n, "param_gb": nbytes / 1e9, "init_s": init_s,
           "generate_s": gen_s, "ms_per_step_generate": gen_s / steps * 1e3,
           "tok_per_s": LM2_BATCH * LM2_GEN / gen_s,
           "decode_step_ms": step_ms, "decode_step_bound_ms": bound * 1e3,
           "bound_by": ("bytes" if step_bytes / HBM_BYTES_PER_S
                        >= step_ops / BF16_OPS_PER_S else "operations"),
           "step_gb": step_bytes / 1e9, "step_ops": step_ops,
           "step_profile": profile,
           "decode_vs_forward_at_draw": at_draw,
           "decode_vs_forward_held": dict(held, wq_scale=LM2_WQ_SCALE,
                                          wq_tensors=n_wq),
           "f32_decode_vs_forward_at_draw": at_draw32,
           "f32_decode_vs_forward_held": held32,
           "peak_gib": peak_gib,
           "peak_gib_f32": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  LM2 {arch}{' (smoke)' if smoke else ''}: {n / 1e9:.4f} B "
        f"parameters ({nbytes / 1e9:.2f} GB {str(cfg.dtype)[6:]}) drawn on "
        f"the card in {init_s:.2f} s; generate B={LM2_BATCH} prompt "
        f"{LM2_PROMPT} gen {LM2_GEN} in {gen_s:.3f} s "
        f"({run['tok_per_s']:.1f} tok/s, {run['ms_per_step_generate']:.2f} "
        f"ms a step); one decode step {step_ms:.3f} ms (CUDA events) "
        f"against its bound {bound * 1e3:.3f} ms ({run['bound_by']}: "
        f"{step_bytes / 1e9:.2f} GB, {step_ops / 1e12:.3f} TFLOP); decode "
        f"vs forward over the prompt: {held['rel']:.4f} of max |logit| "
        f"{held['max_abs_logit']:.4f} with {n_wq} wq x {LM2_WQ_SCALE} "
        f"(argmax agree {held['argmax_agree']:.3f}), {at_draw['rel']:.4f} "
        f"at the draw (argmax agree {at_draw['argmax_agree']:.3f}, not "
        f"held); peak {peak_gib:.2f} GiB")
    log(f"    the same weights in f32: decode vs forward max |err| "
        f"{held32['max_abs']:.3e} ({held32['rel']:.3e} of max |logit| "
        f"{held32['max_abs_logit']:.4f}, argmax agree "
        f"{held32['argmax_agree']:.3f}) with wq x {LM2_WQ_SCALE}; "
        f"{at_draw32['max_abs']:.3e} ({at_draw32['rel']:.3e} of "
        f"{at_draw32['max_abs_logit']:.4f}, argmax agree "
        f"{at_draw32['argmax_agree']:.3f}) at the draw, not held; peak "
        f"{run['peak_gib_f32']:.2f} GiB")
    if profile:
        log(f"    one step under torch.profiler: {profile['kernels']} "
            f"kernels, device {profile['device_ms']:.3f} ms of the step's "
            f"{step_ms:.3f} ms (idle share {profile['idle_share']:.3f}); "
            f"top: " + "; ".join(
                f"{t['name']} x{t['count']} {t['ms']:.3f} ms"
                for t in profile["top"]))
    del params, ctx
    torch.cuda.empty_cache()
    return run


LM3_RUNS = (
    ("serve --ann --engine sharded --arch llama32_vision_11b",
     ["--ann", "--engine", "sharded", "--arch", "llama32_vision_11b"],
     "sharded"),
    ("serve --ann --arch whisper_base --smoke",
     ["--ann", "--arch", "whisper_base", "--smoke"], "local"),
)


def lm_rag_path(ops, smoke: bool, device: str):
    """LM3: the RAG path through the entry points, in this process so the
    launch counters see it: ``launch.serve``'s ``serve_ann`` then
    ``rag_decode`` (what ``main`` runs for ``--ann --arch``), each served
    == ``svc.search`` of the same queries (local bit for bit, sharded at
    rtol 1e-5 with k-th-place ties), then examples/torch_rag_serving.py.
    Returns (report, launches, captured launches)."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    out, seen, label = {}, {}, [None]
    restore = capture_launches(ops, seen, label)
    try:
        for label[0], argv, engine in LM3_RUNS:
            if smoke and "--smoke" not in argv:
                argv = [*argv, "--smoke"]
            args = serve.build_parser().parse_args([*argv, "--device",
                                                    device])
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                svc, reqs, points = serve.serve_ann(args)
            except SystemExit as e:
                check(False, f"LM3 {label[0]}: exited {e.code}")
            try:
                toks = serve.rag_decode(args, reqs, points)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                qs = np.stack([r.query for r in reqs]).astype(np.float32)
                d, i = svc.search(qs)
            finally:
                svc.shutdown()
            got_d = np.stack([r.dists for r in reqs])
            got_i = np.stack([r.ids for r in reqs])
            if engine == "local":
                check(np.array_equal(got_d, d) and np.array_equal(got_i, i),
                      f"LM3 {label[0]}: served != svc.search bit for bit")
            else:
                check(np.allclose(got_d, d, rtol=1e-5, atol=1e-5)
                      and tie_diff_rows(got_d, got_i, d, i, 1e-5, 1e-5) == 0,
                      f"LM3 {label[0]}: served != svc.search")
            cfg = registry.get_config(args.arch, smoke=args.smoke)
            check(tuple(toks.shape) == (args.batch,
                                        args.prompt_len + args.gen)
                  and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                  f"LM3 {label[0]}: tokens {tuple(toks.shape)}")
            out[label[0]] = {
                "secs": secs, "requests": len(reqs),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            log(f"  LM3 {label[0]}: exit 0, {len(reqs)} served == direct, "
                f"tokens {tuple(toks.shape)}, {secs:.2f} s, peak "
                f"{out[label[0]]['peak_gib']:.2f} GiB")
            del svc, reqs, points, toks
            torch.cuda.empty_cache()
        label[0] = "torch_rag_serving"
        t0 = time.perf_counter()
        res = _load_example(label[0]).main(["--device", device])
        check(res["served_ok"] and res["tokens"].shape == (8, 20),
              "LM3 examples/torch_rag_serving.py")
        out[label[0]] = {"secs": time.perf_counter() - t0,
                         "requests": res["stats"]["requests"]}
        log(f"  LM3 examples/torch_rag_serving.py: served == direct, tokens "
            f"{res['tokens'].shape}, {out[label[0]]['secs']:.2f} s")
    finally:
        restore()
    return out, dict(ops.launches), seen


def lm_path(ops, ref, adc, seed: int, device: str = "cuda",
            smoke: bool = False):
    """Phase 13 (see the module docstring): LM1, LM2, LM3.  The launch
    counters are reset before LM1 and read after LM3 (LM1 and LM2 launch
    no kernel of the six; LM3 retrieves through them); LM3's captured
    launches are then held to their plain versions.  ``smoke`` runs LM2
    and LM3 at the smoke configs (a CPU rehearsal).  Returns (report,
    launch counts)."""
    t0 = time.perf_counter()
    ops.reset_launches()
    lm1 = lm_smoke_archs(seed, device)
    lm2 = {arch: lm_full_arch(arch, seed, device, smoke=smoke)
           for arch in LM2_ARCHS}
    lm3, launches, seen = lm_rag_path(ops, smoke, device)
    if device == "cuda":
        for name in ("lut_build", "pq_scan_dc", "pq_scan_topk"):
            check(launches[name] > 0, f"LM3: {name} never launched")
    log(f"kernels vs plain, the {len(seen)} launch shapes of LM3:")
    lm3["kernel_checks"] = check_captured(ops, ref, adc, seen, phase="LM3")
    held = {key[0] for key in seen}
    launched = {k for k in COUNTED if launches[k]}
    check(held >= launched, f"LM3: launched {sorted(launched)} but held "
                            f"only {sorted(held)} to plain")
    run = {"LM1": lm1, "LM2": lm2, "LM3": lm3, "launches": launches,
           "secs": time.perf_counter() - t0}
    log(f"  lm path {run['secs']:.1f} s; launches {launches}")
    return run, launches



# ---------------------------------------------------------------------------
# 14. Training
# ---------------------------------------------------------------------------

TR_BATCH, TR_SEQ = 2, 16       # TR1's batch: pipeline step 0
TR_REMAT_TOL = 1e-5            # remat == no remat, of each leaf's scale
TR2_ARCH, TR2_STEPS, TR2_BATCH, TR2_SEQ = "minitron_4b", 8, 1, 4096
TR2_PARAMS = 5_096_279_040     # count_params_analytic(minitron_4b)
TR3_ARCH, TR3_STEPS, TR3_FAIL, TR3_EVERY = "qwen3_14b", 10, 6, 3
TR3_RESUME_RTOL = 1e-5
TR_DIR = ROOT / "build" / "train_ckpt"
TR_EXAMPLE_STEPS = 60


def _batch_on(batch: dict, cfg, step: int, device) -> dict:
    """A pipeline batch (numpy) on ``device``, with the vlm / enc-dec
    context stub of ``step`` (drawn on the CPU, so both devices read the
    same rows)."""
    from repro_torch.launch.train import ctx_for
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ctx = ctx_for(cfg, step, out["tokens"].shape[0], "cpu")
    if ctx is not None:
        out["ctx"] = ctx.to(device)
    return out


def _loss_grads(cfg, params, batch) -> list:
    """The gradients of make_train_step's loss (CE + 1e-3 aux), leaf by
    leaf in tree order, without an optimizer step."""
    from repro_torch.launch.steps import cross_entropy
    from repro_torch.models import forward
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    logits, aux = forward(params, cfg, batch["tokens"], ctx=batch.get("ctx"))
    (cross_entropy(logits, batch["labels"]) + 1e-3 * aux).backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return grads


def tr_smoke_archs(seed: int, device: str) -> dict:
    """TR1: every arch at its smoke config (f32, IEEE matmuls), weights
    drawn once on the CPU: one make_train_step on the card == on the CPU
    (loss and grad_norm at LM1's tolerance); on the card, remat "full"
    and "half" gradients == "none"'s at TR_REMAT_TOL of each leaf's
    scale."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import make_token_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import forward, init_params
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    out = {}
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch, smoke=True)
        params = init_params(cfg, seed, device="cpu")
        batch = make_token_pipeline(cfg.vocab_size, TR_SEQ, TR_BATCH,
                                    seed=seed).batch_at(0)
        cpu_b = _batch_on(batch, cfg, 0, "cpu")
        with torch.no_grad():
            logits, _ = forward(params, cfg, cpu_b["tokens"],
                                ctx=cpu_b.get("ctx"))
        scale = float(logits[..., :cfg.vocab_size].abs().max())
        metrics = {}
        for dev in ("cpu", device):
            p = tree_map(lambda x: x.to(dev, copy=True), params)
            _, _, m = make_train_step(cfg)(p, adamw.init(p),
                                           _batch_on(batch, cfg, 0, dev))
            metrics[dev] = {k: float(v) for k, v in m.items()}
        row = {"max_abs_logit": scale}
        for k in ("loss", "grad_norm"):
            a, b = metrics[device][k], metrics["cpu"][k]
            check(math.isfinite(a) and abs(a - b) <= _lm_atol(scale)
                  + LM_TOL[0] * abs(b),
                  f"TR1 {arch}: card {k} {a:.6f} != CPU {b:.6f}")
            row[k] = a
            row[f"{k}_err"] = abs(a - b)
        check(metrics[device]["grad_norm"] > 0, f"TR1 {arch}: zero grads")
        dev_b = _batch_on(batch, cfg, 0, device)
        grads = {}
        for remat in ("none", "full", "half"):
            p = tree_map(lambda x: x.to(device, copy=True), params)
            grads[remat] = _loss_grads(dataclasses.replace(cfg, remat=remat),
                                       p, dev_b)
        for remat in ("full", "half"):
            rel = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(grads[remat], grads["none"]))
            check(rel <= TR_REMAT_TOL, f"TR1 {arch}: remat {remat} grads "
                                       f"!= none's ({rel:.3e})")
            row[f"remat_{remat}_rel"] = rel
        out[arch] = row
        log(f"  TR1 {arch}: card == CPU, loss {row['loss']:.6f} (|err| "
            f"{row['loss_err']:.2e}), grad_norm {row['grad_norm']:.6f} "
            f"(|err| {row['grad_norm_err']:.2e}); remat full / half vs "
            f"none on the card {row['remat_full_rel']:.1e} / "
            f"{row['remat_half_rel']:.1e} of the leaf's scale")
    return out


def _train_flops(cfg, params, batch: int, seq: int) -> dict:
    """A train step's operations: model FLOPs (6 x matmul parameters x
    tokens + causal attention 6 x L x S^2 x H x dh x B / 2, the MFU
    numerator) and what the port executes: the matmuls' forward +
    backward + the groups' recompute (bf16), and the attention at the
    blocks the chunked path visits (f32: the scores are f32 products
    there), forward + recompute + backward."""
    from repro_torch.models.common import tree_leaves
    tokens = batch * seq
    mm = sum(x.numel() for x in tree_leaves(params) if x.dim() >= 2) \
        - params["embedding"].numel()
    mm_groups = sum(x.numel() for g in params.get("groups", [])
                    for x in tree_leaves(g) if x.dim() >= 2)
    n_attn = sum(t in ("attn", "attn_local") for t in cfg.layer_types)
    hdim = cfg.n_heads * cfg.head_dim
    attn_model = 6 * n_attn * seq * seq * hdim * batch / 2
    blk = min(512, seq)
    nq = seq // blk
    visited = blk * blk * nq * (nq + 1) // 2          # causal block skip
    attn_fwd = 4 * n_attn * visited * hdim * batch
    return {"model": 6 * mm * tokens + attn_model,
            "bf16_exec": 6 * mm * tokens + 2 * mm_groups * tokens,
            "f32_exec": 4 * attn_fwd,
            "matmul_params": mm}


def attn_fan_in_(params, cfg) -> int:
    """Every GQA projection rescaled in place from the reference's draw,
    1 / sqrt(shape[-2]) (the heads axis for wq / wk / wv, head_dim for
    wo), to 1 / sqrt of the size it contracts (d_model; heads x head_dim
    for wo).  Returns how many attention blocks were rescaled."""
    n = 0
    with torch.no_grad():
        for key, val in params.items():
            if key == "attn" and "wo" in val:
                d, h, _ = val["wq"].shape
                kv = val["wk"].shape[1]
                val["wq"].mul_(math.sqrt(h / d))
                val["wk"].mul_(math.sqrt(kv / d))
                val["wv"].mul_(math.sqrt(kv / d))
                val["wo"].mul_(1 / math.sqrt(val["wo"].shape[0]))
                n += 1
            elif isinstance(val, dict):
                n += attn_fan_in_(val, cfg)
            elif isinstance(val, list):
                n += sum(attn_fan_in_(v, cfg) for v in val)
    return n


def _grad_by_depth(cfg, params, batch) -> dict:
    """One backward's global gradient norm, and the norm of each group's
    gradient: the first group's over the last's is the growth through the
    stack."""
    from repro_torch.models.common import tree_leaves
    grads = _loss_grads(cfg, params, batch)
    sq = [float(g.float().square().sum()) for g in grads]
    ids = {id(x): i for i, x in enumerate(tree_leaves(params))}
    per_group = [math.sqrt(sum(sq[ids[id(x)]] for x in tree_leaves(g)))
                 for g in params["groups"]]
    del grads
    return {"grad_norm": math.sqrt(sum(sq)), "group_first": per_group[0],
            "group_last": per_group[-1],
            "growth_per_layer": (per_group[0] / per_group[-1])
            ** (1 / max(cfg.n_layers - 1, 1))}


def tr_full_arch(seed: int, device: str, seq: int = TR2_SEQ) -> dict:
    """TR2: minitron-4b at its full published config (bf16 params, f32
    moments, remat "full") trained TR2_STEPS steps at B = TR2_BATCH,
    S = ``seq`` on the Zipf pipeline with train_loop's AdamW settings:
    every loss and grad_norm finite, grad_norm > 0, the last 3 losses'
    mean below the first 3's, the peak within the card.  Each step timed
    by CUDA events; one more step under torch.profiler.

    The weights are the reference's draw with the attention projections
    rescaled to their contracted size (``attn_fan_in_``).  At the draw
    itself (wq's fan-in is its heads axis) the gradient grows ~4x a
    layer backward through the 32 layers, to ~1e18 (the reference's own
    draw does the same, growing with depth and width): clipped by that
    norm every other leaf's update vanishes under Adam's eps and the loss
    does not move.  One backward at the draw is logged, not held."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import make_token_pipeline
    from repro_torch.launch.specs import count_params_analytic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.models.common import count_params, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    cfg = registry.get_config(TR2_ARCH)
    check(cfg.remat == "full" and cfg.dtype == torch.bfloat16,
          f"TR2: {TR2_ARCH} is not bf16 with remat full")
    torch.cuda.reset_peak_memory_stats()
    params, draw_s = sync_time(lambda: init_params(cfg, seed, device=device))
    n = count_params(params)
    check(n == count_params_analytic(cfg) == TR2_PARAMS,
          f"TR2: {n} parameters, count_params_analytic says "
          f"{count_params_analytic(cfg)}")
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))
    pipe = make_token_pipeline(cfg.vocab_size, seq, TR2_BATCH, seed=seed)
    at_draw = _grad_by_depth(cfg, params, _batch_on(pipe.batch_at(0), cfg,
                                                    0, device))
    n_attn = attn_fan_in_(params, cfg)
    rescaled = _grad_by_depth(cfg, params, _batch_on(pipe.batch_at(0), cfg,
                                                     0, device))
    log(f"    TR2 one backward at the reference's draw: grad norm "
        f"{at_draw['grad_norm']:.3e} (first group {at_draw['group_first']:.3e}"
        f", last {at_draw['group_last']:.3e}: x{at_draw['growth_per_layer']:.2f}"
        f" a layer), not held; with the {n_attn} attention blocks at their "
        f"contracted fan-in: {rescaled['grad_norm']:.3e} (x"
        f"{rescaled['growth_per_layer']:.2f} a layer)")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=max(TR2_STEPS // 10, 1),
                          total_steps=TR2_STEPS)
    opt_state = adamw.init(params)
    state_bytes = 8 * n
    step_fn = make_train_step(cfg, opt_cfg)
    hist, ms = [], []
    t0 = time.perf_counter()
    for step in range(TR2_STEPS):
        batch = _batch_on(pipe.batch_at(step), cfg, step, device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step_fn(params, opt_state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        hist.append({k: float(v) for k, v in m.items()})
        log(f"    TR2 step {step}: loss {hist[-1]['loss']:.4f} grad_norm "
            f"{hist[-1]['grad_norm']:.4f} lr {hist[-1]['lr']:.2e}, "
            f"{ms[-1]:.1f} ms")
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              and h["grad_norm"] > 0 for h in hist),
          f"TR2: a loss or grad_norm is not finite and positive: {hist}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"TR2: the loss did not fall: {losses}")
    check(peak <= total, f"TR2: peak {peak} B past the card's {total} B")
    step_ms = float(np.median(ms[1:]))
    fl = _train_flops(cfg, params, TR2_BATCH, seq)
    t_ops = (fl["bf16_exec"] / BF16_OPS_PER_S
             + fl["f32_exec"] / F32_OPS_PER_S) * 1e3
    # each input read once, each output written once: params, mu, nu
    t_bytes = 2 * (param_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    tokens = TR2_BATCH * seq
    batch = _batch_on(pipe.batch_at(TR2_STEPS), cfg, TR2_STEPS, device)
    profile = _step_profile(lambda: step_fn(params, opt_state, batch),
                            top=8, warm=False)
    if profile:
        profile["idle_share"] = max(0.0, 1 - profile["device_ms"] / step_ms)
    run = {"arch": TR2_ARCH, "params": n, "batch": TR2_BATCH, "seq": seq,
           "steps": TR2_STEPS, "draw_s": draw_s, "train_s": train_s,
           "at_draw": at_draw, "attn_fan_in": rescaled,
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "lrs": [h["lr"] for h in hist], "step_ms_all": ms,
           "step_ms": step_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ms_bytes": t_bytes, "bound_ms_ops": t_ops,
           "bound_ms_all_bf16": (fl["bf16_exec"] + fl["f32_exec"])
           / BF16_OPS_PER_S * 1e3,
           "model_tflop": fl["model"] / 1e12,
           "bf16_exec_tflop": fl["bf16_exec"] / 1e12,
           "f32_exec_tflop": fl["f32_exec"] / 1e12,
           "matmul_params": fl["matmul_params"],
           "tokens_per_s": tokens / step_ms * 1e3,
           "mfu": fl["model"] / (step_ms / 1e3) / BF16_OPS_PER_S,
           "peak_gib": peak / 2**30, "card_gib": total / 2**30,
           "step_profile": profile}
    log(f"  TR2 {TR2_ARCH} full: {n:,} parameters ({param_bytes / 1e9:.2f} "
        f"GB bf16 + {state_bytes / 1e9:.2f} GB f32 moments) drawn on the "
        f"card in {draw_s:.2f} s; {TR2_STEPS} steps at B={TR2_BATCH} "
        f"S={seq}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{step_ms:.1f} ms (median of steps 2-{TR2_STEPS}, CUDA events) "
        f"against its bound {run['bound_ms']:.1f} ms ({run['bound_by']}: "
        f"{fl['bf16_exec'] / 1e12:.1f} TFLOP bf16 at 989 TFLOP/s + "
        f"{fl['f32_exec'] / 1e12:.1f} TFLOP f32 attention at 67 TFLOP/s; "
        f"{run['bound_ms_all_bf16']:.1f} ms were it all bf16); "
        f"{run['tokens_per_s']:.0f} tokens/s, MFU {run['mfu']:.4f} "
        f"({fl['model'] / 1e12:.1f} TFLOP of model work a step); peak "
        f"{run['peak_gib']:.2f} GiB of {run['card_gib']:.2f}")
    if profile:
        log(f"    one step under torch.profiler: {profile['kernels']} "
            f"kernels, device {profile['device_ms']:.1f} ms of the step's "
            f"{step_ms:.1f} ms (idle share {profile['idle_share']:.3f}); "
            f"top: " + "; ".join(
                f"{t['name']} x{t['count']} {t['ms']:.1f} ms"
                for t in profile["top"]))
    del params, opt_state, step_fn, batch
    torch.cuda.empty_cache()
    return run


def _ref_format_keys(cfg, params) -> dict:
    """The reference's checkpoint keys and shapes for (params, AdamW
    state), from the port's tree through the reference-structured carry
    (groups stacked)."""
    from repro_torch.convert import lm_params_to_numpy

    def rec(node, prefix, out):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, f"{prefix}{k}/", out)
            else:
                out[f"{prefix}{k}"] = list(v.shape)
        return out

    ref = lm_params_to_numpy(cfg, params)
    keys = {"1/.step": []}
    for prefix in ("0/", "1/.mu/", "1/.nu/"):
        rec(ref, prefix, keys)
    return keys


def tr_entry_points(device: str) -> dict:
    """TR3: ``python -m repro_torch.launch.train --arch qwen3_14b --smoke
    --steps 10 --ckpt-dir build/train_ckpt`` after a run of the same
    settings crashed at step 6 (``train_loop(fail_at_step=6)``,
    checkpoints every 3 steps): it resumes at step 6 and its losses equal
    an uninterrupted run's at rtol 1e-5.  Its last checkpoint read back by
    a plain numpy reader of the reference's format (manifest, npz keys,
    shapes, dtypes, COMMITTED).  Then examples/torch_train_lm.py --steps
    60: exit 0 with the loss falling."""
    import shutil
    from repro_torch.configs import registry
    from repro_torch.launch import train
    cfg = registry.get_config(TR3_ARCH, smoke=True)
    parser = train.build_parser()
    args = parser.parse_args(["--arch", TR3_ARCH, "--smoke"])
    kw = dict(steps=TR3_STEPS, global_batch=args.batch, seq_len=args.seq,
              log_every=100, device=device)
    shutil.rmtree(TR_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    whole_params, whole = train.train_loop(cfg, **kw)
    try:
        train.train_loop(cfg, ckpt_dir=TR_DIR, ckpt_every=TR3_EVERY,
                         fail_at_step=TR3_FAIL, **kw)
        check(False, "TR3: the injected failure did not fire")
    except RuntimeError as e:
        check(str(e) == f"injected failure at step {TR3_FAIL}",
              f"TR3: {e}")
    from repro_torch.checkpoint import Checkpointer
    check(Checkpointer(TR_DIR).all_steps() == [3, 6],
          f"TR3: checkpoints {Checkpointer(TR_DIR).all_steps()}")
    resumed = train.main(["--arch", TR3_ARCH, "--smoke", "--steps",
                          str(TR3_STEPS), "--ckpt-dir", str(TR_DIR),
                          "--device", device])
    got = [h["loss"] for h in resumed]
    want = [h["loss"] for h in whole[TR3_FAIL:]]
    check(len(got) == TR3_STEPS - TR3_FAIL
          and np.allclose(got, want, rtol=TR3_RESUME_RTOL, atol=0),
          f"TR3: resumed losses {got} != uninterrupted {want}")
    # a plain numpy reader of the reference's format
    step_dir = TR_DIR / f"step_{TR3_STEPS:08d}"
    check((step_dir / "COMMITTED").exists(), "TR3: no COMMITTED marker")
    manifest = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / "proc_00000" / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    want_keys = _ref_format_keys(cfg, whole_params)
    check(set(arrays) == set(manifest["leaves"]) == set(want_keys),
          f"TR3: checkpoint keys differ from the reference's: "
          f"{sorted(set(arrays) ^ set(want_keys))[:8]}")
    for k, spec in manifest["leaves"].items():
        check(list(arrays[k].shape) == spec["shape"] == want_keys[k]
              and str(arrays[k].dtype) == spec["dtype"]
              == ("int32" if k == "1/.step" else "float32"),
              f"TR3: leaf {k}: {arrays[k].shape} {arrays[k].dtype} vs "
              f"{spec} / {want_keys[k]}")
    check(int(arrays["1/.step"]) == TR3_STEPS
          and manifest["extra"] == {"step": TR3_STEPS},
          f"TR3: step {arrays['1/.step']}, extra {manifest['extra']}")
    emb = whole_params["embedding"].detach().cpu().numpy()
    param_err = float(np.abs(arrays["0/embedding"] - emb).max())
    secs = time.perf_counter() - t0
    log(f"  TR3 launch.train --arch {TR3_ARCH} --smoke --steps {TR3_STEPS} "
        f"--ckpt-dir {TR_DIR}: crashed at step "
        f"{TR3_FAIL} (checkpoints 3, 6), resumed at step {TR3_FAIL}, "
        f"losses == the uninterrupted run's (max |err| "
        f"{max(abs(a - b) for a, b in zip(got, want)):.2e}); "
        f"{len(arrays)} leaves in the reference's format, keys / shapes / "
        f"dtypes checked; embedding vs the uninterrupted run max |err| "
        f"{param_err:.2e}; {secs:.1f} s")
    ex_dir = TR_DIR.parent / "torch_train_lm"
    shutil.rmtree(ex_dir, ignore_errors=True)
    t1 = time.perf_counter()
    res = _load_example("torch_train_lm").main(
        ["--steps", str(TR_EXAMPLE_STEPS), "--device", device,
         "--ckpt-dir", str(ex_dir)])
    ex_losses = res["losses"]
    ex_s = time.perf_counter() - t1
    check(len(ex_losses) == TR_EXAMPLE_STEPS
          and np.mean(ex_losses[-5:]) < np.mean(ex_losses[:5]),
          f"TR3 examples/torch_train_lm.py: losses {ex_losses[:5]} .. "
          f"{ex_losses[-5:]}")
    log(f"  TR3 examples/torch_train_lm.py --steps {TR_EXAMPLE_STEPS}: "
        f"loss {ex_losses[0]:.4f} -> {ex_losses[-1]:.4f} (first 5 mean "
        f"{np.mean(ex_losses[:5]):.4f}, last 5 {np.mean(ex_losses[-5:]):.4f}"
        f"), {ex_s:.1f} s")
    shutil.rmtree(TR_DIR, ignore_errors=True)
    shutil.rmtree(ex_dir, ignore_errors=True)
    return {"resumed_losses": got, "uninterrupted_losses": want,
            "leaves": len(arrays), "embedding_err": param_err,
            "restart_s": secs, "example_losses": ex_losses,
            "example_s": ex_s}


def train_path(ops, seed: int, device: str = "cuda") -> tuple:
    """Phase 14 (see the module docstring): TR1, TR2, TR3.  The training
    path runs none of the six kernels; their counters are reset before
    TR1 and read after TR3.  Returns (report, launch counts)."""
    t0 = time.perf_counter()
    ops.reset_launches()
    log(f"  device memory held entering the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tr1 = tr_smoke_archs(seed, device)
    tr2 = tr_full_arch(seed, device)
    tr3 = tr_entry_points(device)
    launches = dict(ops.launches)
    run = {"TR1": tr1, "TR2": tr2, "TR3": tr3, "launches": launches,
           "secs": time.perf_counter() - t0}
    log(f"  train path {run['secs']:.1f} s; launches {launches}")
    return run, launches


DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_LM = (("D2", "qwen3_14b", "train_4k"), ("D3", "qwen3_14b",
                                               "decode_32k"))


def _dry_summary(rec: dict) -> dict:
    keys = ("fits", "step_ms", "warm_ms", "peak_bytes", "per_device_flops",
            "per_device_hbm_bytes", "per_device_collective_bytes", "terms_s",
            "dominant", "chips", "mesh", "oom")
    return {k: rec.get(k) for k in keys}


def dry_restore(seed: int) -> dict:
    """D4: a smoke arch's checkpoint, saved by one process, restored onto
    the production mesh with ``restore(shardings=)``: rank 0's slice of
    every leaf on cuda:0, equal to numpy's slice of the saved array."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import init_params_and_axes
    from repro_torch.models.common import tree_leaves
    cfg = registry.get_config("qwen3_14b", smoke=True)
    params, axes = init_params_and_axes(cfg, seed, device="cpu")
    ck_dir = DRYRUN_DIR / "ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = Checkpointer(ck_dir)
    ck.save(1, params)
    mesh = meshlib.make_production_mesh()
    sh = meshlib.shardings_for_tree(params, axes,
                                    meshlib.rules_for(cfg, fsdp=True), mesh)
    got, _ = ck.restore(1, params, shardings=sh)
    with np.load(next(ck_dir.glob("step_*/proc_*/arrays.npz"))) as z:
        saved = {k: z[k] for k in z.files}
    leaves = sharded = 0
    for (key, group, leaf, s) in _keyed_leaves(got, sh):
        arr = saved[key] if group is None else saved[key][group]
        want = arr[s.local_slices(arr.shape)]
        local = leaf.to_local()
        check(local.device == torch.device("cuda", 0),
              f"D4 {key}: on {local.device}")
        check(np.array_equal(local.cpu().numpy(), want),
              f"D4 {key}: rank 0's slice differs from numpy's")
        leaves += 1
        sharded += want.size < arr.size
    shutil.rmtree(ck_dir, ignore_errors=True)
    check(sharded > 0, "D4: no leaf sharded")
    return {"arch": "qwen3_14b (smoke)", "leaves": leaves,
            "sharded_leaves": sharded, "exact": True}


def _keyed_leaves(tree, sh, path=(), group=None):
    """(checkpoint key, group, leaf, sharding) in the checkpoint's keys."""
    if isinstance(tree, torch.Tensor) or hasattr(tree, "to_local"):
        yield "/".join(path), group, tree, sh
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k == "groups":
                for g, sub in enumerate(v):
                    yield from _keyed_leaves(sub, sh[k][g], path + (k,), g)
            else:
                yield from _keyed_leaves(v, sh[k], path + (k,), group)


def d1_compare(dryrun, f32_run: dict, seed: int) -> dict:
    """The D1 cell's fused step on its own inputs at f32, uint8 and bf16:
    each step's device time (CUDA events over 20 steps queued behind a
    device-side sleep, so the host's dispatch is not in it); the mean
    share of each task's f32 top-10 ids that the bf16 step also returns
    (tasks with k valid winners); the largest relative gap of the bf16
    distances to the f32 ones at each rank."""
    shp = f32_run["shard_shape"]
    inp = dryrun.drim_inputs(shp, torch.device("cuda"), seed)
    steps = {"f32": (False, None), "uint8": (True, None),
             "bf16": (False, "bf16")}
    device_ms = {
        name: event_ms(lambda: dryrun.drim_step(inp, shp["k"], True, *how),
                       reps=20, queued=True)
        for name, how in steps.items()}
    d32, i32 = dryrun.drim_step(inp, shp["k"], True, False)
    dbf, ibf = dryrun.drim_step(inp, shp["k"], True, False, "bf16")
    i32, ibf = i32.cpu().numpy(), ibf.cpu().numpy()
    full = (i32 >= 0).all(1)
    share = float(np.mean([len(set(a) & set(b)) / len(a) for a, b in
                           zip(i32[full], ibf[full])]))
    gap = float(((dbf - d32).abs() / d32.abs()).max())
    # each entry and each sum rounds to bf16 (unit roundoff 2^-8): the
    # k-th distance moves by at most (1 + 2^-8)^2 - 1 of itself
    check(bool(torch.isfinite(dbf).all()) and gap <= 2.0 ** -7 + 2.0 ** -15,
          f"D1 bf16: distances {gap:.3e} from f32's (more than the bf16 "
          f"rounding of the tables and the sum)")
    del inp
    return {"device_ms": device_ms, "tasks": int(full.sum()),
            "top10_overlap": share, "max_rel_gap_by_rank": gap}


def d1_topk_bf16_alone(ops, seen: dict) -> dict:
    """E-bf16 alone at D1's shape: its launch in the bf16 fused step
    (rank 0's shard, T tasks by slot over 512 slots of C = 4,096), as
    captured, timed by CUDA events (20 launches queued behind a
    device-side sleep) beside its bound; the instance the wrapper picks
    (key bits, threads).  After the counts were read: these launches do
    not count."""
    from repro_torch.util import next_pow2
    keys = [key for key in seen if key[0] == "pq_scan_topk_bf16"]
    check(len(keys) == 1, f"D1: E-bf16 launches captured at {keys}")
    lut, codes, ids, sizes, slots = seen[keys[0]][1]
    k = keys[0][4]
    ms = event_ms(lambda: ops.pq_scan_topk(lut, codes, ids, sizes, k,
                                           slots=slots), reps=20,
                  queued=True)
    nbytes, nops, shape = fused_bytes_ops(codes, sizes,
                                          next_pow2(max(k, 8)), False,
                                          slots, bf16=True)
    b_ms, b_by = bound_ms(nbytes, nops)
    inst = ops.pq_scan_topk_instance(lut, codes)
    log(f"  pq_scan_topk_bf16 at D1's shape alone: {ms:.4f} ms by slot "
        f"(bound {b_ms:.4f} ms by {b_by}, {ms / b_ms:.2f}x); instance "
        f"{inst}; T={shape['T']} ({shape['nonempty_tasks']} non-empty) "
        f"C={shape['C']} k_pad={shape['k_pad']}, {shape['valid_rows']} "
        f"valid rows in {shape['slots_read']} slots")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "ops": nops, "instance": inst, "shape": shape}


def dryrun_path(ops, ref, adc, seed: int) -> tuple:
    """Phase 15: the dry-run as rank 0 of a fake world of 256 on the
    (16, 16) production mesh.  D1 the drim cell (rank 0's shard at the
    100M shape), fused, f32, uint8 then bf16, then bf16 unfused (A-bf16,
    C-bf16, ``torch.topk``), its launches captured and held to plain after
    the counts were read, then the three fused steps' device time and the
    top-10 overlap of the bf16 and f32 winners on the cell's inputs
    (``d1_compare``); D2 / D3 ``qwen3_14b`` ``train_4k`` /
    ``decode_32k`` (tp + FSDP), one warm and one timed step, held to
    ``fits``; D4 a restore onto the mesh.  Returns (report, launches,
    the D1 checks by kernel)."""
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"  device memory held entering the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run, seen, label = {}, {}, [""]
    with meshlib.fake_world(256, "cuda"):
        ops.reset_launches()
        restore = capture_launches(ops, seen, label)
        try:
            for lut, fused in ((None, True), ("uint8", True),
                               ("bf16", True), ("bf16", False)):
                label[0] = f"D1 {lut or 'f32'}" + ("" if fused
                                                   else " unfused")
                rec = dryrun.run_drim_ann_cell(False, DRYRUN_DIR,
                                               fused_scan=fused,
                                               lut_dtype=lut, seed=seed)
                run[label[0]] = dict(_dry_summary(rec),
                                     shard_shape=rec["shard_shape"])
        finally:
            restore()
        launches = dict(ops.launches)
        for name in SHARDED_KERNELS + tuple(BF16_KERNELS):
            check(launches[name] > 0, f"{name} never launched in D1")
        for lab, r in run.items():
            log(f"  {lab}: step {r['step_ms']:.4f} ms, hbm_bytes "
                f"{r['per_device_hbm_bytes']:.6g} "
                f"(roofline.drim_search_work), peak {r['peak_bytes']} B")
        log("kernels vs plain, at the drim cell's rank-0 shape:")
        checked = check_captured(ops, ref, adc, seen, phase="D1")
        run["D1 E-bf16 alone"] = d1_topk_bf16_alone(ops, seen)
        del seen
        at_cell = {}
        for where, errs in checked.items():
            name = where.split(": ")[1].split(" ")[0]
            at_cell[name] = {"where": where, **errs}
        run["D1 steps"] = d1_compare(dryrun, run["D1 f32"], seed)
        log(f"  D1 fused steps, device time and bf16 vs f32 winners: "
            f"{run['D1 steps']}")
        for tag, arch, shape in DRYRUN_LM:
            rec = dryrun.run_cell(arch, registry.SHAPES_BY_NAME[shape],
                                  False, DRYRUN_DIR, seed=seed)
            check(rec["fits"], f"{tag} {arch} {shape} does not fit: "
                               f"{rec['oom']}")
            check(rec["step_ms"] > 0 and rec["per_device_flops"] > 0,
                  f"{tag}: no step measured")
            check(rec["per_device_collective_bytes"]["total"] > 0,
                  f"{tag}: no collective counted")
            run[tag] = dict(_dry_summary(rec), arch=arch, shape=shape)
            log(f"  {tag} {arch} {shape}: " + json.dumps(run[tag]))
        run["D4"] = dry_restore(seed)
        log(f"  D4 restore: {run['D4']}")
    check(not dist.is_initialized(), "the fake world outlived phase D")
    run["secs"] = time.perf_counter() - t0
    log(f"  dryrun path {run['secs']:.1f} s; launches {launches}")
    return run, launches, at_cell


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-points", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # the local and sharded paths build their engines directly on purpose
    warnings.filterwarnings("ignore", category=DeprecationWarning,
                            message=r"Direct \w+\(\.\.\.\) construction")

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import adc
    from repro_torch.core.search import (SearchParams, cluster_locate,
                                         exact_search, recall_at_k,
                                         search_ivfpq)
    from repro_torch.core.ivf import build_ivfpq, pad_clusters
    from repro_torch.data import make_clustered_corpus, make_query_stream
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.runtime import LocalEngine, ServingConfig, ServingRuntime
    from repro_torch.util import ieee_f32_matmul, next_pow2

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    ieee_f32_matmul()
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")

    # -- 2. build ---------------------------------------------------------
    secs = _build.build()
    log(f"build: {secs:.2f} s for {list(_build.SOURCES)} "
        f"({' '.join(_build.NVCC_FLAGS)})")
    for name, text in _build.build_log.items():
        found = ptxas_instances(text)
        check(bool(found), f"no ptxas report in {name}'s build log")
        for kernel, regs, stack, st, ld in found:
            log(f"  ptxas {name}: {kernel}: {regs} registers, {stack} B "
                f"stack frame, spills {st} B stored / {ld} B loaded")
            check(name != "lut_build" or st + ld == 0,
                  f"{kernel} spills registers")

    # -- 3a. kernels vs plain at ragged shapes ----------------------------
    log("kernels vs plain, ragged shapes:")
    ragged_checks(ops, ref, adc)

    # -- 3c. recall on the reference's bench corpus ------------------------
    # benchmarks/common.py corpus_and_index at M=32 (n=30k, D=64, nlist=128):
    # the reference's recall/m=32_nprobe=8 row reads 0.830 (BENCH_quick.json),
    # above the paper's 0.8 bar; recall does not depend on the hardware
    bench = make_clustered_corpus(0, 30_000, 64, n_queries=256,
                                  n_components=64, k_gt=K, device="cuda")
    bidx = build_ivfpq(torch.Generator().manual_seed(0), bench.points,
                       nlist=128, m=32, cb=CB, kmeans_iters=8, pq_iters=8,
                       device="cuda")
    bcl = pad_clusters(bidx)
    brec = {}
    for dt in ("f32", "uint8"):
        _, ids = search_ivfpq(bidx, bcl, bench.queries.float(), SearchParams(
            nprobe=8, k=K, query_chunk=128, use_kernels=True, lut_dtype=dt))
        brec[dt] = recall_at_k(ids, bench.groundtruth)
    log(f"bench corpus (n=30000, D=64, nlist=128, M=32, nprobe=8): "
        f"recall@{K} f32 {brec['f32']:.4f}, uint8 {brec['uint8']:.4f} "
        f"(reference f32 0.830)")
    check(brec["f32"] >= 0.8, "bench-corpus recall@10 below the 0.8 bar")
    check(brec["f32"] - brec["uint8"] <= 0.01, "bench-corpus uint8 drop "
                                               "> 0.01")

    # -- 4. main path -----------------------------------------------------
    n = args.n_points
    nlist = next_pow2(int(4 * math.sqrt(n)))
    train_sample = min(40 * nlist, n)
    log(f"main path: N={n} D={D} M={M} CB={CB} nlist={nlist} "
        f"train_sample={train_sample} nprobe={NPROBE} k={K} "
        f"queries={N_QUERIES} query_chunk={QUERY_CHUNK}")
    log(f"  configs/drim_ann.config(): D, M, CB, k and the query batch as "
        f"given; cut N {CFG.n_points} -> {n}, nlist {CFG.nlist} -> "
        f"{nlist}, nprobe {CFG.nprobe} -> {NPROBE}; sharded layout: "
        f"dup_budget_frac {CFG.dup_budget_frac} as given, cut split_max "
        f"{CFG.split_max} -> {SPLIT_MAX} and tasks_per_shard "
        f"{CFG.tasks_per_shard} -> {TASKS_PER_SHARD} ({N_SHARDS} shards)")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    local_forms: dict = {}
    restore_forms = count_dc_forms(ops, local_forms)

    t0 = time.perf_counter()
    ds = make_clustered_corpus(args.seed, n, D, n_queries=N_QUERIES,
                               device="cuda")
    log(f"  corpus: {time.perf_counter() - t0:.1f} s (host generation + "
        f"copy), points {tuple(ds.points.shape)} {ds.points.dtype}")
    gen = torch.Generator().manual_seed(args.seed)
    index, t_build = sync_time(lambda: build_ivfpq(
        gen, ds.points, nlist=nlist, m=M, cb=CB, train_sample=train_sample,
        device="cuda"))
    clusters, t_pad = sync_time(lambda: pad_clusters(index))
    idx_bytes = sum(x.numel() * x.element_size() for x in (
        index.centroids, index.codebook.codebooks, index.codebook.sqnorms,
        index.codes, index.ids, index.offsets))
    cl_bytes = sum(x.numel() * x.element_size() for x in clusters)
    sizes_all = index.sizes
    log(f"  build_ivfpq {t_build:.1f} s, pad_clusters {t_pad:.1f} s; "
        f"cmax {clusters.cmax}, cluster sizes min/mean/max "
        f"{int(sizes_all.min())}/{float(sizes_all.float().mean()):.1f}/"
        f"{int(sizes_all.max())}; index {idx_bytes / 2**20:.1f} MiB + "
        f"padded clusters {cl_bytes / 2**20:.1f} MiB on the card")
    check(clusters.codes.dtype == getattr(torch, CFG.code_dtype),
          f"codes are not {CFG.code_dtype}")

    queries = ds.queries.float()
    results = {}
    for dt in ("f32", "uint8"):
        p = SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                         use_kernels=True, lut_dtype=dt)
        search_ivfpq(index, clusters, queries[:QUERY_CHUNK], p)   # warm-up
        (d, i), secs = sync_time(lambda: search_ivfpq(index, clusters,
                                                      queries, p))
        check(d.shape == (N_QUERIES, K) and i.shape == (N_QUERIES, K),
              f"{dt}: result shape {tuple(d.shape)}")
        check(bool(torch.isfinite(d).all()), f"{dt}: non-finite distances")
        check(bool((i >= 0).all()), f"{dt}: padding ids in results")
        results[dt] = (d, i)
        log(f"  search_ivfpq use_kernels=True lut={dt}: {secs * 1e3:.1f} ms "
            f"for {N_QUERIES} queries ({N_QUERIES / secs:.0f} QPS)")

    # ground truth on a prefix of the queries; (64, N) f32 blocks
    _, gt = exact_search(ds.points, queries[:N_RECALL], k=K, chunk=64)
    rec = {dt: recall_at_k(results[dt][1][:N_RECALL], gt) for dt in results}
    log(f"  recall@{K} on {N_RECALL} queries: f32 {rec['f32']:.4f}, "
        f"uint8 {rec['uint8']:.4f} (drop {rec['f32'] - rec['uint8']:.4f})")
    check(rec["f32"] - rec["uint8"] <= 0.01, "uint8 recall drop > 0.01")
    sweep = {}
    for nprobe in (64, 128, 256):       # same T = 8,192 tasks a launch
        p = SearchParams(nprobe=nprobe, k=K, use_kernels=True,
                         query_chunk=QUERY_CHUNK * NPROBE // nprobe)
        sweep[nprobe] = recall_at_k(
            search_ivfpq(index, clusters, queries[:N_RECALL], p)[1], gt)
    log(f"  recall@{K} vs nprobe (f32): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sweep.items()))

    # the plain path on the same card: f32 ids agree as sets
    plain = {}
    for dt in ("f32", "uint8"):
        p = SearchParams(nprobe=NPROBE, k=K + 1, query_chunk=QUERY_CHUNK,
                         lut_dtype=dt)
        plain[dt] = search_ivfpq(index, clusters, queries, p)
    kd, ki = (x.cpu().numpy() for x in results["f32"])
    pd, pi = (x.cpu().numpy() for x in plain["f32"])
    bad = same_neighbours(kd, ki, pd, pi, RTOL, ATOL)
    check(np.allclose(kd, pd[:, :K], rtol=RTOL, atol=ATOL),
          "f32 kernel distances differ from the plain path")
    check(bad == 0, f"f32: {bad} queries' ids differ from the plain path "
                    f"beyond k-th-place ties")
    u8_same = float(np.mean([set(a.tolist()) == set(b[:K].tolist())
                             for a, b in zip(results["uint8"][1].cpu().numpy(),
                                             plain["uint8"][1].cpu().numpy())]))
    rec_plain_u8 = recall_at_k(plain["uint8"][1][:N_RECALL, :K], gt)
    log(f"  plain path: f32 ids agree on every query (ties allowed); uint8 "
        f"id sets identical on {u8_same:.4f} of queries, plain uint8 recall "
        f"{rec_plain_u8:.4f}")
    check(abs(rec_plain_u8 - rec["uint8"]) <= 0.005,
          "uint8 kernel recall differs from the plain path by > 0.005")

    # serving: LocalEngine behind ServingRuntime, Poisson arrivals
    params = SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                          use_kernels=True)
    rt = ServingRuntime(LocalEngine(index, clusters, params),
                        ServingConfig(buckets=(1, 2, 4, 8, 16, 32)))
    rt.warmup(D)
    pool = ds.queries.float().cpu().numpy()
    trace = make_query_stream(pool, N_SERVE, qps=2000.0, seed=args.seed)
    reqs = rt.run_stream(trace)
    check(all(r.done for r in reqs), "unserved requests")
    qs = torch.from_numpy(np.stack([r.query for r in reqs])).cuda()
    p11 = params._replace(k=K + 1)
    dd, di = (x.cpu().numpy() for x in search_ivfpq(index, clusters, qs, p11))
    sd = np.stack([r.dists for r in reqs])
    si = np.stack([r.ids for r in reqs])
    rows_off = int((~np.isclose(sd, dd[:, :K], rtol=1e-5, atol=1e-3)
                    ).any(axis=1).sum())
    check(rows_off == 0, f"served distances differ from a direct search on "
                         f"{rows_off} of {len(reqs)} queries")
    bad = same_neighbours(sd, si, dd, di, 1e-5, 1e-3)
    check(bad == 0, f"served ids differ from a direct search on {bad} "
                    f"queries")
    m = rt.metrics()
    # the same trace on the wall clock, one caller thread
    rt_wall = ServingRuntime(LocalEngine(index, clusters, params),
                             ServingConfig(buckets=(1, 2, 4, 8, 16, 32)))
    rt_wall.warmup(D)
    wreqs = direct_wall_stream(rt_wall, trace)
    check(all(r.done for r in wreqs), "unserved requests (wall clock)")
    wd, wi = (x.cpu().numpy() for x in search_ivfpq(
        index, clusters, torch.from_numpy(served(wreqs)[0]).cuda(), params))
    check(np.array_equal(served(wreqs)[1], wd)
          and np.array_equal(served(wreqs)[2], wi),
          "wall-clock served results differ from a direct search")
    mw = rt_wall.metrics()
    direct_serving = {"virtual": m, "wall": mw}
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.launches)
    restore_forms()
    log(f"  DC launches by form: {local_forms}")
    for name in ("pq_scan_dc", "pq_scan_dc_q"):
        check(local_forms["dense"][name] == 0
              and local_forms["slots"][name] == launches[name],
              f"{name}: the local path launched it dense "
              f"({local_forms['dense'][name]} of {launches[name]})")
    # every local chunk is unscoped at k <= 256: one TS by slot a chunk
    chunks = local_forms["slots"]["pq_scan_dc"] + \
        local_forms["slots"]["pq_scan_dc_q"]
    check(launches["ts_topk"] == chunks,
          f"ts_topk: {launches['ts_topk']} launches on the local path, "
          f"{chunks} chunks")
    for clock, mm in direct_serving.items():
        log(f"  serving {mm['requests']} requests in {mm['batches']} "
            f"batches, clock={clock}: p50 {mm['p50_ms']:.3f} ms, p99 "
            f"{mm['p99_ms']:.3f} ms, QPS {mm['qps']:.1f}, occupancy "
            f"{mm['avg_batch_occupancy']:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    for name in LOCAL_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the local path")

    # -- where a search's time goes (after the counts were read) ----------
    serve_batch = torch.from_numpy(pool[:32]).cuda()
    for label, qs, dt in ((f"one {QUERY_CHUNK}-query chunk", queries[:QUERY_CHUNK],
                           "f32"),
                          (f"one {QUERY_CHUNK}-query chunk", queries[:QUERY_CHUNK],
                           "uint8"),
                          ("one 32-query serving batch", serve_batch, "f32")):
        p = SearchParams(nprobe=NPROBE, k=K, query_chunk=QUERY_CHUNK,
                         use_kernels=True, lut_dtype=dt)
        wall = event_ms(lambda: search_ivfpq(index, clusters, qs, p), reps=10)
        ph = phase_breakdown(ops, index, clusters, qs, dt)
        busy = sum(ph.values())
        log(f"  {label}, lut={dt}: search_ivfpq {wall:.3f} ms (CUDA events, "
            f"idle share ~{max(0.0, 1 - busy / wall):.3f}); phases timed "
            f"alone sum to {busy:.3f} ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in ph.items()))

    # -- 5. the sharded path on the same index -----------------------------
    log(f"sharded path: n_shards={N_SHARDS} split_max={SPLIT_MAX} "
        f"tasks_per_shard={TASKS_PER_SHARD} nprobe={NPROBE} k={K}, "
        f"{N_QUERIES} queries in batches of {SHARD_BATCH}")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    engines, captured, runs, sample, firsts = sharded_path(
        ops, index, queries, results, rec, gt, pool, trace, n, args.seed)
    sharded_launches = dict(ops.launches)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches {sharded_launches}")
    for name in SHARDED_KERNELS:
        check(sharded_launches[name] > 0,
              f"{name} never launched on the sharded path")
    sharded_step_time(engines, runs, queries)
    total = {k: launches[k] + sharded_launches[k] for k in KERNELS}

    # -- 5b. the shard mesh on the same index ------------------------------
    log(f"mesh path: DistributedEngine(mesh=make_shard_mesh({N_SHARDS}, "
        f"devices=[cuda:0] * {N_SHARDS})), lut f32 and uint8, "
        f"{MESH_BATCHES} batches of {SHARD_BATCH} with the LUT cache off, "
        f"then with it on (the first batch twice), then a batch at "
        f"{MESH_FLUSH_TASKS} tasks a shard; each == the flat engine bit for "
        f"bit")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launches()
    mesh_run, mesh_launches, mesh_seen = mesh_path(ops, index, queries,
                                                   engines, sample, firsts)
    mesh_run["secs"] = time.perf_counter() - t0
    log(f"  mesh path {mesh_run['secs']:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the mesh "
        f"searches' launches {mesh_launches}")
    for name in SHARDED_KERNELS:
        check(mesh_launches[name] > 0,
              f"{name} never launched on the mesh path")
    log("kernels vs plain, at a mesh entry's shape:")
    at_entry = mesh_entry_report(ops, ref, adc, mesh_seen)
    check(set(at_entry) == set(SHARDED_KERNELS),
          f"mesh entry launches captured: {sorted(at_entry)}")
    del mesh_seen

    # -- 3b. the main paths' own shapes: check, time, bound ---------------
    log("kernels vs plain, main-path shapes (first query chunk):")
    q0 = queries[:QUERY_CHUNK]
    probes, _ = cluster_locate(q0, index.centroids, NPROBE,
                               block=QUERY_CHUNK)
    res = (q0[:, None, :] - index.centroids[probes]).reshape(-1, D)
    flat = probes.reshape(-1)
    local_lc = (res.contiguous(), index.codebook.codebooks,
                index.codebook.sqnorms)
    rows = main_shape_report(ops, ref, adc, *local_lc, clusters.codes,
                             clusters.sizes, flat.int(), total,
                             local_forms["slots"])
    log("TS by slot vs plain, at the first chunk's and the benchmark's "
        "chunk:")
    rows.append(ts_report(ops, ops.lut_build(*local_lc), clusters.codes,
                          clusters.sizes, clusters.ids, flat.int(),
                          QUERY_CHUNK, launches["ts_topk"], args.seed))
    log("C and D by slot at the benchmark's chunk:")
    at_cell = dc_cell_report(ops, adc, args.seed)
    for r in rows:
        if r["name"] in at_cell:
            r["by_slot"]["at_benchmark_chunk"] = at_cell[r["name"]]
    log("kernels vs plain, the sharded path's first launches:")
    at_step = lut_at_sharded_step(ops, ref, adc, captured)
    for r in rows:
        if r["name"] in at_step:
            r["at_sharded_step"] = at_step[r["name"]]
    rows += fused_report(ops, captured, total)
    log("kernels vs plain, the bf16-table kernels at the first chunk's and "
        "the sharded step's shapes:")
    rows += bf16_report(ops, adc, *local_lc,
                        clusters.codes.index_select(0, flat),
                        clusters.ids.index_select(0, flat),
                        clusters.sizes.index_select(0, flat), captured,
                        (clusters.codes, clusters.sizes, flat.int()))
    for r in rows:
        if r["name"] in at_entry:
            r["at_mesh_entry"] = at_entry[r["name"]]
    save_launch(ops, captured, local_lc)
    del engines, captured
    torch.cuda.empty_cache()

    # -- 6. the service front door on the same index ---------------------
    from repro_torch.core.mutable_index import Index
    from repro_torch.service.__main__ import selftest
    log(f"service path: AnnService over the same index, buckets "
        f"{SERVICE_BUCKETS}, {N_SERVE} requests at 2,000 QPS offered")
    handle = Index(index)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    service_runs = service_path(handle, queries.cpu().numpy(), results,
                                rec["f32"], gt, pool, trace, direct_serving,
                                n, args.seed)
    service_launches = dict(ops.launches)
    log(f"  service path {time.perf_counter() - t0:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {service_launches}")
    for name in KERNELS:
        check(service_launches[name] > 0,
              f"{name} never launched on the service path")
    for clock in ("virtual", "wall"):
        check(selftest(clock=clock, device="cuda") == 0,
              f"service selftest on the card, clock={clock}")

    # -- 7. the live index on the same index ------------------------------
    log(f"mutation path: Index(mutable=True) over the same index, M1 "
        f"{M1_ROUNDS} rounds on LocalEngine (f32, uint8), S6 two mutable "
        f"cached local replicas on the wall clock, S7 one mutable sharded "
        f"replica (f32, uint8)")
    zipf = make_query_stream(pool, N_SERVE, qps=2000.0, skew=1.1,
                             seed=args.seed + 1)       # S2's trace
    s2_wall = next(r for r in service_runs if r.get("clock") == "wall"
                   and r["label"].startswith("S2 local"))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mutation_run, live = mutation_path(index, ds.points, queries, zipf,
                                       trace, rec["f32"], s2_wall, n,
                                       args.seed)
    mutation_launches = dict(ops.launches)
    log(f"  mutation path {time.perf_counter() - t0:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; peak "
        f"host RSS of the process "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} "
        f"GiB; launches {mutation_launches}")
    for name in KERNELS:
        check(mutation_launches[name] > 0,
              f"{name} never launched on the mutation path")
    # the kernels on the live snapshot's first chunk (after the counts
    # were read): its padded width is not pad_clusters's
    lcl, view = live.clusters, live.search_view
    probes, _ = cluster_locate(q0, view.centroids, NPROBE, block=QUERY_CHUNK)
    res = (q0[:, None, :] - view.centroids[probes]).reshape(-1, D)
    where = (f"live snapshot T={res.shape[0]} C={lcl.cmax} (pad_clusters: "
             f"C={clusters.cmax})")
    log("kernels vs plain, the live snapshot's first chunk:")
    lut, qlut, _, _ = check_lut(ops, ref, adc, res.contiguous(),
                                view.codebook.codebooks,
                                view.codebook.sqnorms, where)
    flat = probes.reshape(-1)
    check_scan(ops, adc.adc_distances, adc.adc_distances_quantized, lut,
               qlut, lcl.codes.index_select(0, flat),
               lcl.sizes.index_select(0, flat), where)
    del live, lut, qlut
    torch.cuda.empty_cache()

    # -- 8. beyond-memory serving on the same index ----------------------
    log(f"tiered path: TieredStore with a quarter of the padded clusters "
        f"on the card (T1 LocalEngine f32 + uint8 and {T1_CHURN} churn "
        f"passes, T2 two-level CL with {T2_GROUPS} groups, T3 tiered "
        f"DistributedEngine, S8 tiered AnnService on the Zipf trace, wall "
        f"clock)")
    s5_wall = next(r for r in service_runs if r.get("clock") == "wall"
                   and r["label"].startswith("S5"))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tiered_run = tiered_path(ops, index, clusters, queries, results, zipf,
                             gt, rec["f32"], s5_wall, n)
    tiered_launches = dict(ops.launches)
    log(f"  tiered path {time.perf_counter() - t0:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {tiered_launches}")
    for name in KERNELS:
        check(tiered_launches[name] > 0,
              f"{name} never launched on the tiered path")
    # -- 9. multi-tenant serving on the same index -----------------------
    log(f"tenancy path: {N_TENANTS} tenants (mixture component mod "
        f"{N_TENANTS}) + a {SCARCE_ROWS}-row one, tag id % {TAG_MOD}; N1 "
        f"scoped LocalEngine (f32, uint8), N2 scoped DistributedEngine, N3 "
        f"the tier, N4 the live index, S9 the tenant-aware service")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tenancy_run = tenancy_path(ops, index, clusters, ds.points, queries,
                               results, trace, service_runs, n, args.seed)
    tenancy_launches = dict(ops.launches)
    log(f"  tenancy path {time.perf_counter() - t0:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {tenancy_launches}")
    for name in LOCAL_KERNELS:
        check(tenancy_launches[name] > 0,
              f"{name} never launched on the tenancy path")
    # -- 10. the chaos harness on the same index -------------------------
    log(f"chaos path: two tiered local replicas (a quarter resident), "
        f"default_plan({args.seed}), {CHAOS_QUERIES} Zipf(1.1) requests at "
        f"{1 / CHAOS_INTERVAL_S:.0f} QPS on the wall clock, f32 then uint8, "
        f"then f32 on uniform draws over a sixteenth resident, promote "
        f"margin 1e6")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chaos_run, chaos_launches = chaos_path(ops, ref, adc, index, clusters,
                                           ds.points, queries, args.seed)
    chaos_run["secs"] = time.perf_counter() - t0
    log(f"  chaos path {chaos_run['secs']:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{chaos_launches}")
    for name in LOCAL_KERNELS:
        check(chaos_launches[name] > 0,
              f"{name} never launched on the chaos path")
    # -- 11. the SLO autotuner on a 1M corpus at the same width ----------
    log(f"autotune path: N={U_N} D={D} nlist={U_NLIST} CB={CB}, "
        f"TuneSpace {U_SPACE}, SLO recall@{K} >= 0.8 and p99 <= 50 ms "
        f"(then recall@{K} >= 0.15 if infeasible), validate_budget "
        f"{U_BUDGET}")
    torch.cuda.reset_peak_memory_stats()
    autotune_run, autotune_launches = autotune_path(ops, ref, adc,
                                                    args.seed)
    u_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  autotune path {autotune_run['secs']:.1f} s "
        f"({autotune_run['outcome']}); peak device memory {u_peak:.2f} GiB")
    # -- 12. the paper-side variants and the entry points ----------------
    log(f"variants path: V1 DPQ ({min(V_TRAIN, n)} training rows, "
        f"train_dpq defaults) re-encoding the same index, V2 the "
        f"multiplier-less LC / DC on the first chunk's tasks at scales "
        f"{V2_SCALES}, L1 the serve entry point and the two examples")
    variants_run, variants_launches = variants_path(
        ops, ref, adc, index, clusters, ds.points, queries, results, rec,
        gt, args.seed)
    for name in KERNELS:
        check(variants_launches[name] > 0,
              f"{name} never launched on the variants path")
    # -- 13. the LM stack and the RAG path -------------------------------
    # the ANN phases' index, corpus and engines are not needed past here
    del ds, index, clusters, handle, queries, results, rt, rt_wall, lcl
    del view, serve_batch, q0, res, flat, local_lc, bench, bidx, bcl
    torch.cuda.empty_cache()
    log(f"lm path: LM1 the ten smoke archs card == CPU "
        f"and S={LM_CHUNKED_S} chunked == dense; LM2 {', '.join(LM2_ARCHS)} "
        f"at their full configs (B={LM2_BATCH}, prompt {LM2_PROMPT}, gen "
        f"{LM2_GEN}); LM3 the RAG entry points")
    lm_run, lm_launches = lm_path(ops, ref, adc, args.seed)
    # -- 14. training ----------------------------------------------------
    log(f"train path: TR1 the ten smoke archs' train step card == CPU and "
        f"remat full / half == none; TR2 {TR2_ARCH} at its full config, "
        f"{TR2_STEPS} steps at B={TR2_BATCH} S={TR2_SEQ}; TR3 the train "
        f"entry point's restart and examples/torch_train_lm.py")
    train_run, train_launches = train_path(ops, args.seed)
    # -- 15. the dry-run: rank 0 of the 256-GPU production mesh -----------
    log("dryrun path: a fake world of 256 on the (16, 16) production mesh; "
        "D1 the drim cell at rank 0's 100M shape (fused f32, uint8, bf16; "
        "bf16 unfused), D2 qwen3_14b train_4k and D3 decode_32k (tp + "
        "FSDP), D4 a restore onto the mesh")
    dryrun_run, dryrun_launches, at_cell = dryrun_path(ops, ref, adc,
                                                       args.seed)
    for r in rows:
        if r["name"] in BF16_KERNELS:     # D1 is the path that runs them
            r["launches"] = dryrun_launches[r["name"]]
        if r["name"] in at_cell:
            r["at_dryrun_cell"] = dict(
                at_cell[r["name"]],
                shape=dryrun_run["D1 f32"]["shard_shape"])
    by_path = {"local": launches, "sharded": sharded_launches,
               "mesh": mesh_launches, "service": service_launches,
               "mutation": mutation_launches,
               "tiered": tiered_launches, "tenancy": tenancy_launches,
               "chaos": chaos_launches, "autotune": autotune_launches,
               "variants": variants_launches, "lm": lm_launches,
               "train": train_launches, "dryrun": dryrun_launches}
    for r in rows:
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in by_path.items()}
    log(json.dumps({"mesh": mesh_run}))
    log(json.dumps({"service": service_runs}))
    log(json.dumps({"mutation": mutation_run}))
    log(json.dumps({"tiered": tiered_run}))
    log(json.dumps({"tenancy": tenancy_run}))
    log(json.dumps({"chaos": chaos_run}))
    log(json.dumps({"autotune": autotune_run}))
    log(json.dumps({"variants": variants_run}))
    log(json.dumps({"lm": lm_run}))
    log(json.dumps({"train": train_run}))
    log(json.dumps({"dryrun": dryrun_run}))

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
