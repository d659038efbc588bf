"""PIM-aware ANNS performance model (paper §III-B, Eq. 1–12) + TPU roofline.

Two hardware profiles behind one set of cost functions:

  * ``UPMEM_PROFILE``  — the paper's platform: per-DPU 450 MHz scalar core,
    1 instruction/cycle nominal, multiply = 32 cycles (no hardware
    multiplier), ~1 GB/s MRAM bandwidth per DPU, 2,560 DPUs, 19.2 GB/s host
    link. With this profile the model reproduces the paper's qualitative
    behaviour (compute-bound LC/DC, bottleneck shifting DC->LC with nlist).
  * ``TPU_V5E_PROFILE`` — the adaptation target: 197 TFLOP/s bf16, 819 GB/s
    HBM, ~50 GB/s/link ICI, 256 chips/pod.  Used for the §Roofline analysis
    and the runtime scheduler's latency predictor.

Per-phase costs follow Eq. 1–10 exactly (operation counts and bytes moved);
``t_x = max(C_x / (F·PE), IO_x / BW)`` is Eq. 11; ``C2IO_x`` is Eq. 12.

Notation (paper Table I): N #clusters total, Q queries, D dim, K top-k,
P nprobe (located clusters/query), C avg cluster size, M subvectors,
CB codebook entries, B_x operand byte widths.

A framework-free copy of the reference's ``repro/core/perf_model.py``;
the port keeps its own copy so that it never imports ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

PHASES = ("CL", "RC", "LC", "DC", "TS")


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    pe: int                  # parallel processing units (DPUs / chips)
    freq_hz: float           # per-PE clock (UPMEM) or 1.0 for FLOP-rated HW
    ops_per_cycle: float     # nominal instructions (or FLOPs) per cycle per PE
    mult_cycles: float       # cost multiplier for a multiply (UPMEM: 32)
    bw_per_pe: float         # bytes/s local memory bandwidth per PE
    host_bw: float           # bytes/s host<->PIM (UPMEM) or ICI per link (TPU)
    # Instructions the PE itself spends per loaded word (address generation,
    # MRAM masking, WRAM indexing — the paper's 'auxiliary operations').
    # UPMEM: every load occupies the scalar pipeline; TPU: DMA engines are
    # decoupled from the MXU/VPU -> 0.
    ops_per_load: float = 0.0
    word_bytes: float = 8.0
    notes: str = ""

    @property
    def ops_per_sec_total(self) -> float:
        return self.pe * self.freq_hz * self.ops_per_cycle

    @property
    def bw_total(self) -> float:
        return self.pe * self.bw_per_pe


UPMEM_PROFILE = HardwareProfile(
    name="upmem-2560dpu",
    pe=2560, freq_hz=450e6, ops_per_cycle=1.0, mult_cycles=32.0,
    # CALIBRATED against the paper's three headline geomeans (2.92x /
    # 4.63x / 7.12x at 1x/2x/5x DPU compute, §V-B + Fig. 13); the model
    # reproduces them as 2.60x / 5.20x / 7.13x (max log-err 12%).
    #   bw_per_pe = 0.149 GB/s effective MRAM per DPU — the paper itself
    #   notes peak MRAM bw is ~63.3% of nominal [19] "even slightly worse
    #   in our reproduction", and the DC/LC access granule is small;
    #   ops_per_load = 13 instr per 8-byte word — DPU loads occupy the
    #   scalar pipeline (address arithmetic, MRAM masking, DMA setup;
    #   cf. Gomez-Luna et al. [19] instruction-cost tables).
    bw_per_pe=0.149e9,
    host_bw=19.2e9,           # DDR4-2400 host link (0.75% of PIM bandwidth)
    ops_per_load=13.0, word_bytes=8.0,
    notes="paper platform, calibrated to Fig. 13 (see comment)")

TPU_V5E_PROFILE = HardwareProfile(
    name="tpu-v5e-pod256",
    pe=256, freq_hz=1.0, ops_per_cycle=197e12, mult_cycles=1.0,
    bw_per_pe=819e9, host_bw=50e9,
    notes="197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI")


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """The DSE decision vector (K, P, C, M, CB) + dataset shape."""
    n_total: int          # total points in corpus
    nlist: int            # number of clusters (paper's N/C relation)
    q: int                # queries per batch
    d: int                # dimension
    k: int                # top-k
    p: int                # nprobe
    m: int                # subvectors
    cb: int               # codebook entries
    b_point: int = 1      # uint8 corpus
    b_query: int = 4      # f32 queries
    b_centroid: int = 4
    b_lut: int = 4
    b_addr: int = 4       # heap entry ids (TS)
    b_code: int = 1       # PQ code width (CB<=256 -> uint8)
    b_cb: int = 4         # codebook entry bytes/dim (4 = f32 Faiss;
                          # 1 = uint8-quantized multiplierless deployment)

    @property
    def c(self) -> float:
        """Average cluster size (paper's C)."""
        return self.n_total / self.nlist


def lut_width_bytes(lut_dtype: str) -> int:
    """Bytes per LUT entry for an engine ``lut_dtype`` — the knob that
    feeds :class:`IndexParams.b_lut` so phase costs, Eq. 15 task
    latencies, and C2IO all price the quantized path's real traffic
    (per-subspace scale/bias amortize to < 1% of the table and are
    ignored, matching the paper's word-granularity accounting)."""
    if lut_dtype == "f32":
        return 4
    if lut_dtype == "uint8":
        return 1
    raise ValueError(f"unknown lut_dtype {lut_dtype!r}")


def _log2(x: float) -> float:
    return math.log2(max(x, 2.0))


def phase_costs(ix: IndexParams, mult_cycles: float = 1.0,
                multiplierless: bool = False) -> Dict[str, Dict[str, float]]:
    """Eq. 1–10: per-phase op counts (C_x) and bytes (IO_x).

    IO is split by memory tier — the distinction §II-B makes between MRAM
    (per-DPU main memory, the bandwidth that counts) and WRAM (the 64 KB
    scratchpad whose accesses cost *instructions*, not MRAM bandwidth):

      bytes        — main-memory traffic (MRAM stream / CPU DRAM);
      local_bytes  — scratchpad traffic (WRAM LUT gathers, heap updates;
                     L1/L2-resident on the CPU baseline).

    ``bytes + local_bytes`` equals the paper's Eq. 2/4/6/8/10 totals
    (tests assert this).  ``mult_cycles`` weights each multiplication
    (UPMEM: 32); with ``multiplierless=True`` LC/CL multiplies become
    square-LUT lookups (1 op + B_l scratchpad bytes each) — §III-A.
    """
    n, q, d, k, p, m, cb = (ix.nlist, ix.q, ix.d, ix.k, ix.p, ix.m, ix.cb)
    c = ix.c
    bq, bc, bp, bl, ba = (ix.b_query, ix.b_centroid, ix.b_point, ix.b_lut,
                          ix.b_addr)
    mc = 1.0 if multiplierless else mult_cycles
    lut_extra = bl if multiplierless else 0.0

    out: Dict[str, Dict[str, float]] = {}
    # CL (Eq.1-2): Q x nlist centroid distances + top-P maintenance.
    # Centroids stream from main memory; the query + heap live in cache.
    c_cl = q * n * ((d * (mc + 2.0) - 1.0) + (_log2(p) - 1.0))
    main_cl = q * n * (bc * d)
    local_cl = q * n * (bq * d + (bq * 4 + bq) * (_log2(p) + 1.0)
                        + d * lut_extra)
    out["CL"] = {"ops": c_cl, "bytes": main_cl, "local_bytes": local_cl}
    # RC (Eq.3-4): residual subtraction — centroid streams, query cached.
    out["RC"] = {"ops": q * p * d, "bytes": bc * q * p * d,
                 "local_bytes": bq * q * p * d}
    # LC (Eq.5-6): codebook streams (CB*D*Bcb per task); diff reads, the
    # LUT write and the square-table lookups are scratchpad.
    c_lc = q * p * cb * ((m * (mc + 2.0) - 1.0) * (d / m))
    main_lc = q * p * cb * (d * ix.b_cb)          # codebook stream
    local_lc = q * p * cb * (d * bq + bl * m + d * lut_extra)
    out["LC"] = {"ops": c_lc, "bytes": main_lc, "local_bytes": local_lc}
    # DC (Eq.7-8): codes stream from main memory (M uint8 codes = the LUT
    # addresses) + result write; the M LUT gathers are scratchpad.
    out["DC"] = {"ops": q * p * c * (m - 1.0),
                 "bytes": q * p * c * (m * ix.b_code + bl),
                 "local_bytes": q * p * c * (m * bl)}
    # TS (Eq.9-10): heap lives in the scratchpad.
    out["TS"] = {"ops": q * p * c * (_log2(k) - 1.0),
                 "bytes": 0.0,
                 "local_bytes": q * p * c * (_log2(k) + 1.0) * (bl + ba)}
    return out


def phase_times(ix: IndexParams, hw: HardwareProfile,
                multiplierless: bool = False,
                compute_scale: float = 1.0) -> Dict[str, float]:
    """Eq. 11: t_x = max(C_x / (F*PE*scale), IO_x / BW_total).

    ``compute_scale`` models the paper's §V-D 2x/5x future-DPU study.
    """
    costs = phase_costs(ix, mult_cycles=hw.mult_cycles,
                        multiplierless=multiplierless)
    times = {}
    for ph, cst in costs.items():
        all_bytes = cst["bytes"] + cst["local_bytes"]
        ops_eff = cst["ops"] + hw.ops_per_load * (all_bytes / hw.word_bytes)
        t_compute = ops_eff / (hw.ops_per_sec_total * compute_scale)
        t_io = cst["bytes"] / hw.bw_total        # only main-memory traffic
        times[ph] = max(t_compute, t_io)
    return times


def c2io(ix: IndexParams, multiplierless: bool = False) -> Dict[str, float]:
    """Eq. 12: compute-to-IO ratio per phase."""
    costs = phase_costs(ix, mult_cycles=1.0, multiplierless=multiplierless)
    return {ph: c["ops"] / max(c["bytes"] + c["local_bytes"], 1.0)
            for ph, c in costs.items()}


def total_time(ix: IndexParams, hw: HardwareProfile,
               host_phases: tuple = ("CL",), multiplierless: bool = True,
               compute_scale: float = 1.0) -> float:
    """Eq. 13 objective: max(host pipeline, PIM pipeline) — phases with
    higher C2IO run on the host overlapped with PIM execution (paper
    default: CL on host, RC/LC/DC/TS on PIM)."""
    t = phase_times(ix, hw, multiplierless=multiplierless,
                    compute_scale=compute_scale)
    t_host = sum(v for k, v in t.items() if k in host_phases)
    t_pim = sum(v for k, v in t.items() if k not in host_phases)
    return max(t_host, t_pim)


# --------------------------------------------------------------------------
# Eq. 15 — the runtime scheduler's per-(q, c)-task latency predictor.
# latency = l_LUT + x * l_calc + x * l_sort      (x = cluster size)
# Unit latencies are derived from the same phase costs at C=1 so the
# scheduler and the DSE share one cost basis.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskLatencyModel:
    l_lut: float      # per-task LUT construction latency      (s)
    l_calc: float     # per-vector distance calculation        (s)
    l_sort: float     # per-vector top-k maintenance           (s)

    def task_latency(self, cluster_size) -> float:
        return self.l_lut + cluster_size * (self.l_calc + self.l_sort)


def make_task_latency_model(ix: IndexParams, hw: HardwareProfile,
                            multiplierless: bool = True,
                            compute_scale: float = 1.0) -> TaskLatencyModel:
    one = dataclasses.replace(ix, q=1, p=1)
    costs = phase_costs(one, mult_cycles=hw.mult_cycles,
                        multiplierless=multiplierless)
    rate = hw.freq_hz * hw.ops_per_cycle * compute_scale   # per-PE op rate
    bw = hw.bw_per_pe

    def t(ph, per_point=False):
        ops, bts = costs[ph]["ops"], costs[ph]["bytes"]
        lcl = costs[ph]["local_bytes"]
        if per_point:
            ops, bts, lcl = ops / one.c, bts / one.c, lcl / one.c
        ops_eff = ops + hw.ops_per_load * ((bts + lcl) / hw.word_bytes)
        return max(ops_eff / rate, bts / bw)

    return TaskLatencyModel(l_lut=t("RC") + t("LC"),
                            l_calc=t("DC", per_point=True),
                            l_sort=t("TS", per_point=True))


# --------------------------------------------------------------------------
# Disk tier — prices a cold probe the way c2io prices PIM transfers.
# A tiered index (repro.storage) keeps hot clusters resident and serves
# cold ones from an mmap spill file; the extra cost per cold probe is one
# seek plus the cluster's code+id bytes over disk bandwidth.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiskProfile:
    """Spill-tier device model: fixed per-read latency + stream bandwidth."""
    name: str
    seek_s: float      # per-read latency floor (s) — NVMe ~80 us
    bw: float          # sustained read bandwidth (bytes/s)
    notes: str = ""


NVME_PROFILE = DiskProfile(
    name="nvme-gen4", seek_s=8e-5, bw=3.5e9,
    notes="consumer Gen4 NVMe: ~80 us random-read latency, 3.5 GB/s")


def cold_probe_seconds(ix: IndexParams, disk: DiskProfile) -> float:
    """Added latency of serving one probe from the spill tier instead of
    RAM: one seek plus the cluster's record bytes (M code bytes + one
    id per point) streamed at disk bandwidth.  Strictly positive for any
    real device (``seek_s > 0``), so a cold probe always prices higher
    than the same probe hot — the invariant the residency controller's
    cost accounting relies on."""
    record_bytes = ix.c * (ix.m * ix.b_code + ix.b_addr)
    return disk.seek_s + record_bytes / disk.bw


def serving_batch_latency(ix: IndexParams, hw: HardwareProfile,
                          ranks: int, batch: int,
                          lut_hit_rate: float = 0.0,
                          multiplierless: bool = True,
                          compute_scale: float = 1.0,
                          cold_fraction: float = 0.0,
                          disk: "DiskProfile | None" = None) -> float:
    """Modeled service time (s) of one ``batch``-query serving batch on a
    ``ranks``-rank PIM fleet — the same Eq. 15 basis that paces
    :class:`~repro.runtime.serving.PimPacedEngine`, restated per batch:
    ``ceil(batch * nprobe / ranks)`` serial task waves, each paying
    ``l_lut + C * (l_calc + l_sort)``.

    ``lut_hit_rate`` discounts the per-task LUT construction by the
    fraction of (query, cluster) tasks the hot-cluster cache serves
    (the cache saves the RC+LC work, never the scan/sort) — the term
    the auto-tuner uses to price ``cache_capacity_bytes`` candidates.

    ``cold_fraction`` is the share of probes served from a disk spill
    tier (``repro.storage``): each such probe pays
    :func:`cold_probe_seconds` on top of its scan, so a tiered deploy is
    priced strictly above the all-resident one whenever it actually
    misses RAM.  Requires ``disk`` when nonzero.
    """
    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if not 0.0 <= lut_hit_rate <= 1.0:
        raise ValueError(f"lut_hit_rate must be in [0, 1], "
                         f"got {lut_hit_rate}")
    if not 0.0 <= cold_fraction <= 1.0:
        raise ValueError(f"cold_fraction must be in [0, 1], "
                         f"got {cold_fraction}")
    if cold_fraction > 0.0 and disk is None:
        raise ValueError("cold_fraction > 0 requires a DiskProfile")
    model = make_task_latency_model(ix, hw, multiplierless=multiplierless,
                                    compute_scale=compute_scale)
    l_task = (model.l_lut * (1.0 - lut_hit_rate)
              + ix.c * (model.l_calc + model.l_sort))
    if cold_fraction > 0.0:
        l_task += cold_fraction * cold_probe_seconds(ix, disk)
    waves = -(-(batch * ix.p) // ranks)
    return waves * l_task


# --------------------------------------------------------------------------
# TPU roofline terms (§Roofline of EXPERIMENTS.md) — used by launch/roofline
# for model-side sanity checks against compiled HLO numbers.
# --------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 197e12      # per chip
HBM_BW = 819e9                # per chip
ICI_BW_PER_LINK = 50e9        # per link


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int) -> Dict[str, float]:
    return {
        "compute_s": flops / (chips * PEAK_FLOPS_BF16),
        "memory_s": hbm_bytes / (chips * HBM_BW),
        "collective_s": collective_bytes / (chips * ICI_BW_PER_LINK),
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])
