// Fused DC + TS on Hopper: the PQ code scan with a per-task top-k.
//
// Replaces the Pallas TPU kernels `pq_scan_topk_pallas` and
// `pq_scan_topk_q_pallas` (src/repro/kernels/pq_scan.py), the per-shard
// scan of the sharded engine, and computes the reference's fused scan
// over a bf16 table (src/repro/core/sharded_search.py `_fused_scan_topk`
// under `_shard_tasks_fn(lut_dtype=bf16)`):
//
//     s        = slots[t]   (slots == NULL: s = t, the TPU's dense form)
//     d[t, c]  = the row distance of pq_scan.cu (f32, u8 or bf16 table
//                lut[t]) for the code row codes[s, c]
//     out[t]   = the k_pad smallest (d[t, c], c) over rows c < sizes[s],
//                ascending, as (distance, ids[s, c]); slots past the
//                valid rows are (+inf, -1).
//
// Slots: codes (P, C, M), ids (P, C) and sizes (P,) are the shard tensors
// as they lie on the card, and task t reads the rows of slot slots[t]
// where they are; a slot outside [0, P) (-1: no task) has size 0.  The
// sharded engine's step passes its task table here, so no copy of the
// tasks' codes or ids is made.  A zero-size task writes k_pad x (+inf,
// -1) and reads no table.
//
// The (T, C) distance matrix never reaches device memory.  Ties are
// broken by row: a candidate is the 64-bit key (order-preserving bits of
// its distance, row), keys are unique, and the selection is exact, so the
// output is a function of the inputs alone.
//
// What bounds it on an H100: bytes.  The function reads each non-empty
// task's table (M*CB*4 bytes f32; M*CB*2 bf16; M*CB + 8*M u8), the codes
// of the valid rows of the slots it reads (once a slot, however many
// tasks share it; in the dense form every task's own), the ids of the
// winners only (min(size, k_pad) a task), the slots and sizes, and
// writes T * k_pad * 8 bytes:
//
//     T_nonempty * table_bytes + slot_rows * M*code_bytes
//         + winner_rows * 4 + (T + slots_read) * 4 + T * 8*k_pad
//
// At the sharded step (k_pad = 16, 16 KB f32 tables, ~680 rows a task,
// tasks sharing slots) the f32 tables are most of those bytes.  What
// keeps a kernel from that bound is work a task pays whatever its size:
// the first merges of each warp's list, merging the warps' lists,
// barriers, and the latency of staging a table.  The design keeps those
// small:
//
//   * a persistent grid (as many blocks as fit on the card at once,
//     looked up on the first launch on a device) walks the tasks, block
//     b taking b, b + grid, ...; a block writes the empty tasks it meets
//     and stages no table for them;
//   * a block is few warps (kThreadsF32 = kThreadsBF16 = 64, kThreadsU8 =
//     32), so a warp sees half or all of a task's rows and the warps'
//     lists merge in at most one round.  The table is copied into shared
//     memory with cp.async (pq_row.cuh stage_table_async) as soon as
//     every warp is past the previous task's scan; a block holds 17 KB
//     (f32), 9 KB (bf16) or 4.2 KB (u8), so up to 13 (f32) or 32 (u8)
//     blocks share an SM, more bf16 ones than f32 ones, and one block's
//     copy overlaps the others' scans (a second buffer, to overlap it
//     inside the block, fits fewer blocks and was slower on the H100:
//     PERF.md lists what was tried);
//   * lane = row, 32 rows a warp a round: a row is one 16-byte code load
//     at M = 16 u8 (the next round's load in flight while this one is
//     scored) and M lookups out of shared memory summed in order m =
//     0..M-1 (pq_row.cuh: the same float as pq_scan.cu's);
//   * each warp keeps its own running top list in registers, L = max(32,
//     k_pad) keys, k_pad/32 a lane, sorted in the order i = j*32 + lane.
//     A row is kept only below the list's k_pad-th key, which a shuffle
//     broadcasts.  Up to kInsertMax kept rows are inserted one by one (a
//     shuffle shift); more are sorted across the warp and merged in with
//     a bitonic merge over __shfl_xor_sync.  No block barrier runs inside
//     the scan;
//   * the warps' lists are merged pairwise through shared memory
//     (reversed-min + bitonic merge), and warp 0 writes the k_pad winners
//     and looks their ids up.
//
// k_pad is a power of two in [8, 256].  The kernels allocate nothing and
// never synchronise with the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "pq_row.cuh"

namespace {

// Threads of a block (one task at a time, 32 rows a warp a round) for
// f32, u8 and bf16 tables.  Chosen on an H100 with
// tools/torch_fused_topk_bench.py --variant, which replays the sharded
// path's first launch (PERF.md): fewer warps a task cost less selection
// and merging.  The bf16 tables take the f32 tables' block (not tuned).
constexpr int kThreadsF32 = 64;
constexpr int kThreadsU8 = 32;
constexpr int kThreadsBF16 = 64;
constexpr int kMaxKPad = 256;
constexpr int kMaxDevices = 64;   // devices whose grid size is remembered
// Kept rows in a round up to which they are inserted one at a time; more
// are sorted across the warp and merged.
constexpr int kInsertMax = 16;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kNone = 0xff800000ffffffffull;  // (+inf, none)

typedef unsigned long long u64;

template <int kKind>
__host__ __device__ constexpr int threads_of() {
  return kKind == pqrow::kU8     ? kThreadsU8
         : kKind == pqrow::kBF16 ? kThreadsBF16
                                 : kThreadsF32;
}

int threads_of(int kind) {
  return kind == pqrow::kU8     ? kThreadsU8
         : kind == pqrow::kBF16 ? kThreadsBF16
                                : kThreadsF32;
}

__device__ __forceinline__ uint32_t ordered_bits(float d) {
  const uint32_t u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a < b ? b : a; }

// One key a lane, sorted ascending across the warp (bitonic, 15 steps).
__device__ __forceinline__ u64 warp_sort32(u64 x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 y = __shfl_xor_sync(kAll, x, j);
      const bool low = (lane & j) == 0, up = (lane & k) == 0;
      x = low == up ? kmin(x, y) : kmax(x, y);
    }
  }
  return x;
}

// Sort a bitonic sequence of L = 32 * KPL keys held as i = j*32 + lane:
// half-cleaners at distances L/2 .. 32 inside a lane, 16 .. 1 across.
template <int KPL>
__device__ __forceinline__ void bitonic_merge(u64 (&v)[KPL], int lane) {
#pragma unroll
  for (int jd = KPL / 2; jd > 0; jd >>= 1) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if ((j & jd) == 0) {
        const u64 a = v[j], b = v[j + jd];
        v[j] = kmin(a, b);
        v[j + jd] = kmax(a, b);
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const u64 y = __shfl_xor_sync(kAll, v[j], d);
      v[j] = (lane & d) ? kmax(v[j], y) : kmin(v[j], y);
    }
  }
}

// Fold 32 candidates (one a lane, kNone where none) into the sorted list:
// after it the list holds the L smallest of both, sorted.  The candidates
// are sorted, reversed and min-ed into the list's last 32 keys, which
// leaves a bitonic sequence.
template <int KPL>
__device__ __forceinline__ void merge32(u64 (&v)[KPL], u64 cand, int lane) {
  cand = warp_sort32(cand, lane);
  v[KPL - 1] = kmin(v[KPL - 1], __shfl_sync(kAll, cand, 31 - lane));
  bitonic_merge<KPL>(v, lane);
}

// Insert one key (not kNone) into the sorted list; the largest key drops.
template <int KPL>
__device__ __forceinline__ void insert1(u64 (&v)[KPL], u64 x, int lane) {
  u64 prev[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const u64 up = __shfl_up_sync(kAll, v[j], 1);
    const u64 last = j > 0 ? __shfl_sync(kAll, v[j > 0 ? j - 1 : 0], 31) : 0;
    prev[j] = lane > 0 ? up : last;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const bool first = j == 0 && lane == 0;
    v[j] = v[j] < x ? v[j] : (first || prev[j] < x ? x : prev[j]);
  }
}

// The k_pad-th smallest key of the list (k_pad <= 32 when KPL == 1, else
// k_pad == 32 * KPL), on every lane.
template <int KPL>
__device__ __forceinline__ u64 kth(const u64 (&v)[KPL], int kp) {
  if constexpr (KPL == 1) return __shfl_sync(kAll, v[0], kp - 1);
  return __shfl_sync(kAll, v[KPL - 1], 31);
}

// Task t's slot and its number of valid rows (0: no slot or no rows).
__device__ __forceinline__ int task_rows(const int* slots, const int* sizes,
                                         int t, int P, int C, int* slot) {
  const int s = slots == nullptr ? t : slots[t];
  *slot = s;
  return (s >= 0 && s < P) ? max(0, min(sizes[s], C)) : 0;
}

// From task t on, in steps of the grid, the first task with rows (T if
// none); the empty tasks passed over are written as (+inf, -1).  Every
// thread of the block calls it with the same arguments.
template <int kThreads>
__device__ __forceinline__ int next_task(int t, int T, const int* slots,
                                         const int* sizes, int P, int C,
                                         int kp, float* out_d, int* out_i,
                                         int* slot, int* rows) {
  for (; t < T; t += gridDim.x) {
    *rows = task_rows(slots, sizes, t, P, C, slot);
    if (*rows > 0) return t;
    for (int j = threadIdx.x; j < kp; j += kThreads) {
      out_d[(size_t)t * kp + j] = INFINITY;
      out_i[(size_t)t * kp + j] = -1;
    }
  }
  return t;
}

size_t table_bytes(int kind, int M, int CB) {
  return (pqrow::table_smem_bytes(kind, M, CB) + 15) & ~(size_t)15;
}

int keys_per_lane(int kp) { return kp <= 32 ? 1 : kp / 32; }

// The table and, with more than one warp, the warps' lists.
size_t smem_bytes(int kind, int M, int CB, int kp) {
  const int warps = threads_of(kind) / 32;
  return table_bytes(kind, M, CB) +
         (warps > 1 ? (size_t)warps * 32 * keys_per_lane(kp) * sizeof(u64)
                    : 0);
}

template <int KPL, typename CodeT, int kKind, bool kVec16>
__global__ void __launch_bounds__(threads_of<kKind>())
    pq_scan_topk_kernel(const void* __restrict__ lut,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const CodeT* __restrict__ codes,
                        const int* __restrict__ ids,
                        const int* __restrict__ sizes,
                        const int* __restrict__ slots,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int T, int P, int C, int M, int CB, int kp,
                        int tbytes) {
  constexpr bool kQuant = kKind == pqrow::kU8;
  constexpr int kThreads = threads_of<kKind>();
  constexpr int kWarps = kThreads / 32;
  constexpr int L = 32 * KPL;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* lists = reinterpret_cast<u64*>(smem + tbytes);   // [kWarps][L]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int slot, rows;
  int t = next_task<kThreads>(blockIdx.x, T, slots, sizes, P, C, kp, out_d,
                              out_i, &slot, &rows);
  if (t < T)
    pqrow::stage_table_async<kKind, kThreads>(lut, scale, bias, t, M, CB,
                                              smem);
  while (t < T) {
    pqrow::cp_async_wait_all();        // this thread's copies of task t
    __syncthreads();                   // ... and everyone's
    const pqrow::Table tab = pqrow::table_view(smem, M, CB);
    float bsum = 0.0f;
    float scl[16];
    if constexpr (kQuant) {
      bsum = pqrow::bias_sum(tab.sc, M);
      if constexpr (kVec16) {
#pragma unroll
        for (int m = 0; m < 16; ++m) scl[m] = tab.sc[m];
      }
    }

    // -- scan: each warp keeps its own top list ------------------------
    u64 v[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = kNone;
    u64 thr = kNone;                   // the warp's k_pad-th key
    const CodeT* base = codes + (size_t)slot * C * M;
    const uint4* base16 = reinterpret_cast<const uint4*>(base);
    uint4 next = {};                   // vec16: this lane's next row
    if constexpr (kVec16)
      if (warp * 32 + lane < rows) next = __ldg(base16 + warp * 32 + lane);
    for (int c0 = warp * 32; c0 < rows; c0 += kThreads) {
      const int c = c0 + lane;
      u64 key = kNone;
      if constexpr (kVec16) {
        const uint4 w = next;
        if (c + kThreads < rows) next = __ldg(base16 + c + kThreads);
        if (c < rows) {
          float d;
          if constexpr (kQuant)
            d = pqrow::row_sum_vec16<kKind, 256>(w, tab, scl, CB) + bsum;
          else
            d = pqrow::row_sum_vec16<kKind, 256>(w, tab, tab.sc, CB);
          key = ((u64)ordered_bits(d) << 32) | (uint32_t)c;
        }
      } else if (c < rows) {
        float d = pqrow::row_sum<CodeT, kKind>(base + (size_t)c * M, tab,
                                               tab.sc, M, CB);
        if constexpr (kQuant) d += bsum;
        key = ((u64)ordered_bits(d) << 32) | (uint32_t)c;
      }
      const bool keep = key < thr;
      unsigned kept = __ballot_sync(kAll, keep);
      if (kept == 0) continue;
      if (__popc(kept) <= kInsertMax) {
        do {
          const int src = __ffs(kept) - 1;
          kept &= kept - 1;
          insert1<KPL>(v, __shfl_sync(kAll, key, src), lane);
        } while (kept);
      } else {
        merge32<KPL>(v, keep ? key : kNone, lane);
      }
      thr = kth<KPL>(v, kp);
    }

    // -- merge the warps' lists pairwise through shared memory ---------
#pragma unroll
    for (int half = kWarps / 2; half > 0; half >>= 1) {
      if (warp >= half && warp < 2 * half) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) lists[warp * L + j * 32 + lane] = v[j];
      }
      __syncthreads();
      if (warp < half) {
        const u64* other = lists + (warp + half) * L;
#pragma unroll
        for (int j = 0; j < KPL; ++j)
          v[j] = kmin(v[j], other[L - 1 - (j * 32 + lane)]);
        bitonic_merge<KPL>(v, lane);
      }
    }
    // Every warp is past its scan (the merge barriers, or alone, here):
    // the block's next task's table may land while warp 0 writes.
    int slot1, rows1;
    const int t1 = next_task<kThreads>(t + gridDim.x, T, slots, sizes, P, C,
                                       kp, out_d, out_i, &slot1, &rows1);
    if (t1 < T)
      pqrow::stage_table_async<kKind, kThreads>(lut, scale, bias, t1, M, CB,
                                                smem);
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int i = j * 32 + lane;
        if (i < kp) {
          const uint32_t row = (uint32_t)v[j];
          const bool none = row == 0xffffffffu;
          out_d[(size_t)t * kp + i] =
              none ? INFINITY : from_ordered((uint32_t)(v[j] >> 32));
          out_i[(size_t)t * kp + i] = none ? -1 : ids[(size_t)slot * C + row];
        }
      }
    }
    t = t1, slot = slot1, rows = rows1;
  }
}

template <int KPL, typename CodeT, int kKind, bool kVec16>
int launch_typed(const void* lut, const void* scale, const void* bias,
                 const void* codes, const void* ids, const void* sizes,
                 const void* slots, void* out_d, void* out_i, int T, int P,
                 int C, int M, int CB, int kp, void* stream) {
  auto kernel = pq_scan_topk_kernel<KPL, CodeT, kKind, kVec16>;
  const size_t smem = smem_bytes(kKind, M, CB, kp);
  // The blocks of this instance that fit on the card at once, looked up on
  // the first launch per device and shared-memory size: (smem << 32) |
  // blocks, 0 until then.
  static std::atomic<unsigned long long> resident[kMaxDevices];
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  const unsigned long long seen =
      dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  int blocks = (int)(seen & 0xffffffffull);
  if (seen == 0 || (seen >> 32) != smem) {
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads_of<kKind>(), smem)) != cudaSuccess)
      return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    if (dev < kMaxDevices)
      resident[dev].store(((unsigned long long)smem << 32) | (unsigned)blocks,
                          std::memory_order_relaxed);
  }
  const int grid = T < blocks ? T : blocks;
  kernel<<<grid, threads_of<kKind>(), smem, (cudaStream_t)stream>>>(
      lut, (const float*)scale, (const float*)bias, (const CodeT*)codes,
      (const int*)ids, (const int*)sizes, (const int*)slots, (float*)out_d,
      (int*)out_i, T, P, C, M, CB, kp, (int)table_bytes(kKind, M, CB));
  return (int)cudaGetLastError();
}

template <int KPL, int kKind>
int launch_codes(const void* lut, const void* scale, const void* bias,
                 const void* codes, const void* ids, const void* sizes,
                 const void* slots, void* out_d, void* out_i, int T, int P,
                 int C, int M, int CB, int code_bytes, int kp, void* stream) {
  if (code_bytes == 4)
    return launch_typed<KPL, int32_t, kKind, false>(
        lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
        CB, kp, stream);
  if (M == 16 && CB == 256 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch_typed<KPL, uint8_t, kKind, true>(
        lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
        CB, kp, stream);
  return launch_typed<KPL, uint8_t, kKind, false>(
      lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
      CB, kp, stream);
}

template <int kKind>
int launch(const void* lut, const void* scale, const void* bias,
           const void* codes, const void* ids, const void* sizes,
           const void* slots, void* out_d, void* out_i, int T, int P, int C,
           int M, int CB, int code_bytes, int kp, void* stream) {
  if (kp < 8 || kp > kMaxKPad || (kp & (kp - 1)) != 0 || sizes == nullptr ||
      (code_bytes != 1 && code_bytes != 4) || (slots == nullptr && P != T))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  switch (keys_per_lane(kp)) {
    case 1:
      return launch_codes<1, kKind>(lut, scale, bias, codes, ids, sizes,
                                    slots, out_d, out_i, T, P, C, M, CB,
                                    code_bytes, kp, stream);
    case 2:
      return launch_codes<2, kKind>(lut, scale, bias, codes, ids, sizes,
                                    slots, out_d, out_i, T, P, C, M, CB,
                                    code_bytes, kp, stream);
    case 4:
      return launch_codes<4, kKind>(lut, scale, bias, codes, ids, sizes,
                                    slots, out_d, out_i, T, P, C, M, CB,
                                    code_bytes, kp, stream);
    default:
      return launch_codes<8, kKind>(lut, scale, bias, codes, ids, sizes,
                                    slots, out_d, out_i, T, P, C, M, CB,
                                    code_bytes, kp, stream);
  }
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 u8, 2 bf16 table.
size_t pq_scan_topk_smem_bytes(int kind, int M, int CB, int k_pad) {
  return smem_bytes(kind, M, CB, k_pad);
}

// lut (T, M, CB) f32; codes (P, C, M) u8 (code_bytes=1) or i32 (4), ids
// (P, C) i32, sizes (P,) i32; slots (T,) i32, or NULL with P == T (task t
// reads slot t) -> out_d (T, k_pad) f32 ascending, out_i (T, k_pad) i32.
// Returns cudaGetLastError().
int pq_scan_topk_f32(const void* lut, const void* codes, const void* ids,
                     const void* sizes, const void* slots, void* out_d,
                     void* out_i, int T, int P, int C, int M, int CB,
                     int code_bytes, int k_pad, void* stream) {
  return launch<pqrow::kF32>(lut, nullptr, nullptr, codes, ids, sizes,
                             slots, out_d, out_i, T, P, C, M, CB, code_bytes,
                             k_pad, stream);
}

// lut_q (T, M, CB) u8, scale/bias (T, M) f32, the rest as above.
int pq_scan_topk_u8(const void* lut_q, const void* scale, const void* bias,
                    const void* codes, const void* ids, const void* sizes,
                    const void* slots, void* out_d, void* out_i, int T, int P,
                    int C, int M, int CB, int code_bytes, int k_pad,
                    void* stream) {
  return launch<pqrow::kU8>(lut_q, scale, bias, codes, ids, sizes, slots,
                            out_d, out_i, T, P, C, M, CB, code_bytes, k_pad,
                            stream);
}

// lut (T, M, CB) bf16, the rest as for pq_scan_topk_f32; each distance
// out is a bf16 value.
int pq_scan_topk_bf16(const void* lut, const void* codes, const void* ids,
                      const void* sizes, const void* slots, void* out_d,
                      void* out_i, int T, int P, int C, int M, int CB,
                      int code_bytes, int k_pad, void* stream) {
  return launch<pqrow::kBF16>(lut, nullptr, nullptr, codes, ids, sizes,
                              slots, out_d, out_i, T, P, C, M, CB,
                              code_bytes, k_pad, stream);
}

const char* pq_scan_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
