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
             the card, both clocks.

The launch counters of the six kernels are reset just before each path
and read just after it; every kernel of the path must have risen (the
service path runs all six).
Recall@10 is taken against the port's exact_search; the sharded results
are held to the local path's on the same queries, and served results to
a direct search: every local service cell bit for bit to the uncached
search_ivfpq of the same queries at its LUT dtype.  The last lines printed are one ``{"kernels": [...]}``
JSON line and ``{"ok": true, "device": {...}}``; A's and B's rows carry
their times at the sharded step's first LC launches too; ``launches``
sums the local and sharded paths, as before the service existed, and
``launches_by_path`` gives each path's own count, the service's
included.  E's and F's
first sharded launches, with their LC inputs and those of the local
path's first chunk, are written to ``build/sharded_launch.pt``, which
``tools/torch_fused_topk_bench.py`` and ``tools/torch_lut_build_bench.py``
replay.
Any failed check raises, so the exit code is non-zero and the ``ok`` line
is never printed; so is a run without CUDA or outside a checkout.

Configuration: the repo's DRIM-ANN shape (configs/drim_ann.py, the
paper's SV-A setup: D=128 uint8 points, M=16, CB=256, k=10, 10,000
queries a batch), with N cut from 100M to 10M so one run can generate
and build the index; nlist = 4 sqrt(N) rounded up to a power of two
(16,384 at 10M), train_sample = 40 nlist, nprobe = 32, query_chunk 256
(8,192 LC/DC tasks a launch).  ``--n-points`` cuts N further for a quick
run.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LAUNCH_FILE = ROOT / "build" / "sharded_launch.pt"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
RTOL, ATOL = 1e-4, 1e-3        # the reference's kernel tolerance

D, M, CB, K = 128, 16, 256, 10
N_QUERIES, QUERY_CHUNK, NPROBE = 10_000, 256, 32
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


def lut_bytes_ops(t: int, m: int, cb: int, dsub: int, quant: bool):
    """LC's bound inputs: bytes (residuals, codebooks and norms read once,
    the f32 table, or the u8 table with scale and bias, written once) and
    operations (per entry dsub FMAs, the combination and the clamp; per
    row ||r||^2; B adds the min, max, subtraction, division, rounding and
    clamp of each entry)."""
    nbytes = t * m * dsub * 4 + m * cb * dsub * 4 + m * cb * 4
    nbytes += t * m * cb + 2 * t * m * 4 if quant else t * m * cb * 4
    nops = t * m * cb * (2 * dsub + 4) + t * m * 2 * dsub
    if quant:
        nops += t * m * cb * 6
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


def check_scan(ops, plain_f32, plain_u8, lut, q, codes, sizes, where: str):
    errs = {}
    for name, table, plain in (("pq_scan_dc", lut, plain_f32),
                               ("pq_scan_dc_q", q, plain_u8)):
        for sz in (sizes, None):
            got = ops.pq_scan_dc(table, codes, sz)
            want = plain(table, codes, sz)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)),
                  f"{name} {where}: +inf mask differs")
            e = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
            check(torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL),
                  f"{name} {where}: max |err| {e}")
            errs[name] = max(errs.get(name, 0.0), e)
    log(f"  {where}: pq_scan_dc max|err| {errs['pq_scan_dc']:.3e}, "
        f"pq_scan_dc_q max|err| {errs['pq_scan_dc_q']:.3e}")
    return errs


def check_topk(ops, lut, codes, ids, sizes, k: int, where: str,
               slots=None) -> float:
    """E or F against its plain version (DC, then top-k_pad): distances
    allclose with equal +inf masks, -1 ids exactly at +inf, per-task id
    sets equal apart from ties at the k-th place.  Then, bit for bit, the
    first k entries of the (distance, row) sort of C's or D's output on
    the same (gathered) inputs and, with ``slots``, the dense launch on
    the gathered inputs.  Returns max |err| against the plain version."""
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
    name = "pq_scan_topk_q" if isinstance(lut, tuple) else "pq_scan_topk"
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
    check(np.allclose(gd[~inf], pd[:, :k][~inf], rtol=RTOL, atol=ATOL),
          f"{what}: max |err| {err}")
    bad = tie_diff_rows(gd, gi, pd[:, :k], pi[:, :k], RTOL, ATOL)
    check(bad == 0, f"{what}: ids differ on {bad} tasks beyond k-th-place "
                    f"ties")
    return err


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


def main_shape_report(ops, ref, adc, res, books, sqn, codes, sizes,
                      launches):
    """The main path's first chunk: check, time and bound each kernel."""
    t, c = codes.shape[0], codes.shape[1]
    dsub = books.shape[2]
    lut, q, err_a, err_b = check_lut(ops, ref, adc, res, books, sqn,
                                     f"main path T={t} C={c}")
    errs = check_scan(ops, adc.adc_distances, adc.adc_distances_quantized,
                      lut, q, codes, sizes, f"main path T={t} C={c}")
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
    ``core.search._search_chunk``)."""
    from repro_torch.core.search import cluster_locate
    from repro_torch.core.topk import topk_smallest
    qc = q.shape[0]
    probes = cluster_locate(q, index.centroids, NPROBE, block=QUERY_CHUNK)[0]
    flat = probes.reshape(-1)
    res = (q[:, None, :] - index.centroids[probes]).reshape(qc * NPROBE, -1)
    cb = index.codebook
    lc = ops.lut_build_q if dt == "uint8" else ops.lut_build
    lut = lc(res, cb.codebooks, cb.sqnorms)
    codes = clusters.codes.index_select(0, flat)
    sizes = clusters.sizes.index_select(0, flat)
    ids = clusters.ids.index_select(0, flat)
    dists = ops.pq_scan_dc(lut, codes, sizes)
    cand = qc, NPROBE * clusters.cmax
    phases = {
        "CL (GEMM + top-nprobe)": lambda: cluster_locate(
            q, index.centroids, NPROBE, block=QUERY_CHUNK),
        "RC (residuals)": lambda: (q[:, None, :]
                                   - index.centroids[probes]).reshape(
                                       qc * NPROBE, -1),
        "gather codes/ids/sizes": lambda: (
            clusters.codes.index_select(0, flat),
            clusters.ids.index_select(0, flat),
            clusters.sizes.index_select(0, flat)),
        "LC kernel": lambda: lc(res, cb.codebooks, cb.sqnorms),
        "DC kernel": lambda: ops.pq_scan_dc(lut, codes, sizes),
        "TS (torch.topk)": lambda: topk_smallest(dists.reshape(cand),
                                                 ids.reshape(cand), K),
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
    engines, the inputs of each fused kernel's first launch, and each
    engine's (wall s, steps, host s per phase) over the 10,000 queries."""
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
        dup = int(0.10 * n * (M + 4))
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

        runs = {}
        for dt, eng in engines.items():
            eng.phase_s.clear()
            outs, wall, rounds = [], 0.0, 0
            for b in range(0, len(queries), SHARD_BATCH):
                (d, i, info), secs = sync_time(
                    lambda: eng.search(queries[b:b + SHARD_BATCH]))
                outs.append((d, i))
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
    return engines, captured, runs


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


def fused_bytes_ops(codes, sizes, k_pad: int, quant: bool, slots=None):
    """E/F's bound inputs: bytes (non-empty tasks' tables, the codes of
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
    table = M * CB + 8 * M if quant else M * CB * 4
    nbytes = (nonempty * table + code_rows * M * codes.element_size()
              + winners * 4 + index_bytes + t * 8 * k_pad)
    nops = valid * M * (2 if quant else 1) + (nonempty * M if quant else 0)
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
    dup = int(0.10 * n * (M + 4))
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
# Main path
# ---------------------------------------------------------------------------

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
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()

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
    check(clusters.codes.dtype == torch.uint8, "codes are not uint8")

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
    engines, captured, runs = sharded_path(ops, index, queries, results, rec,
                                           gt, pool, trace, n, args.seed)
    sharded_launches = dict(ops.launches)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches {sharded_launches}")
    for name in SHARDED_KERNELS:
        check(sharded_launches[name] > 0,
              f"{name} never launched on the sharded path")
    sharded_step_time(engines, runs, queries)
    total = {k: launches[k] + sharded_launches[k] for k in KERNELS}

    # -- 3b. the main paths' own shapes: check, time, bound ---------------
    log("kernels vs plain, main-path shapes (first query chunk):")
    q0 = queries[:QUERY_CHUNK]
    probes, _ = cluster_locate(q0, index.centroids, NPROBE,
                               block=QUERY_CHUNK)
    res = (q0[:, None, :] - index.centroids[probes]).reshape(-1, D)
    flat = probes.reshape(-1)
    local_lc = (res.contiguous(), index.codebook.codebooks,
                index.codebook.sqnorms)
    rows = main_shape_report(ops, ref, adc, *local_lc,
                             clusters.codes.index_select(0, flat),
                             clusters.sizes.index_select(0, flat), total)
    log("kernels vs plain, the sharded path's first launches:")
    at_step = lut_at_sharded_step(ops, ref, adc, captured)
    for r in rows:
        if r["name"] in at_step:
            r["at_sharded_step"] = at_step[r["name"]]
    rows += fused_report(ops, captured, total)
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
    by_path = {"local": launches, "sharded": sharded_launches,
               "service": service_launches}
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
    log(json.dumps({"service": service_runs}))

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
