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
// The (T, C) distance matrix never reaches device memory.  The selection
// is warp_topk.cuh's, with the row as a key's position: ties go to the
// lower row, and the output is a function of the inputs alone.  Keys are
// 64-bit, except on a bf16 table of at most 65,535 rows a slot (below).
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
//   * each warp keeps its own running top list in registers
//     (warp_topk.cuh).  A round of 32 rows is one vote against the list's
//     k_pad-th key; up to kInsertMax kept rows are inserted one by one,
//     more are merged in at once, and the k_pad-th key is read again after
//     the round.  No block barrier runs inside the scan;
//   * the warps' lists are merged pairwise through shared memory
//     (reversed-min + bitonic merge), and warp 0 writes the k_pad winners
//     and looks their ids up.
//
// E-bf16 (the bf16 table, pq_scan_topk_bf16).  Its table is 8 KB, half
// the f32 one, so the bytes it must move are 0.18 ms at the sharded step
// against E's 0.32; on E's kernel (64-bit keys, 64 threads) it took 0.41
// ms there (2.25x the bound).  Probes of that kernel (tools/
// torch_fused_topk_bench.py --probe, PERF.md) put 29% of its time in the
// selection, ~1% in waiting for a staged table.  A bf16 row distance has
// 16 bits, so its key fits in 32 bits (warp_topk.cuh's 32-bit keys), and
// pq_scan_topk_narrow_kernel runs the same task loop on those keys, so
// every shuffle of the sort, insert, k-th broadcast and merge moves one
// register instead of two, and the lists and their shared-memory merge
// halve.  Its block was swept on the H100 (kThreadsBF16 32 / 64 / 128,
// and a second table buffer staged during the scan): 64 threads were
// fastest at the sharded step and at the dry-run cell's shape (4,096 rows
// a task), a second buffer slower.
// What bounds it now: the lookups' instructions (a byte extract, an
// address, a shared-memory load, a widening and an add for each of a
// row's 16 terms) -- a probe that makes every warp load conflict-free but
// adds two operations a lookup is slower, not faster -- then the
// selection (14% by the probe).  The wrapper sends C >= 65,536 rows a
// slot to pq_scan_topk_bf16_wide: E's kernel on the bf16 table, 64-bit
// keys, as before.
//
// k_pad is a power of two in [8, 256].  The kernels allocate nothing and
// never synchronise with the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "occupancy.cuh"
#include "pq_row.cuh"
#include "warp_topk.cuh"

namespace {

using namespace wtopk;

// Threads of a block (one task at a time, 32 rows a warp a round) for
// f32, u8 and bf16 tables.  Chosen on an H100 with
// tools/torch_fused_topk_bench.py --variant, which replays the sharded
// path's first launch (PERF.md): fewer warps a task cost less selection
// and merging.  The bf16 value was swept with 32-bit keys (the 64-bit
// bf16 instance, for slots of more than 65,535 rows, takes it too).
constexpr int kThreadsF32 = 64;
constexpr int kThreadsU8 = 32;
constexpr int kThreadsBF16 = 64;
// Kept rows in a round up to which they are inserted one at a time; more
// are sorted across the warp and merged.
constexpr int kInsertMax = 16;

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

// From task t on, in steps of the grid, the first task with rows (T if
// none); the empty tasks passed over are written as (+inf, -1).  Every
// thread of the block calls it with the same arguments.
template <int kThreads>
__device__ __forceinline__ int next_task(int t, int T, const int* slots,
                                         const int* sizes, int P, int C,
                                         int kp, float* out_d, int* out_i,
                                         int* slot, int* rows) {
  for (; t < T; t += gridDim.x) {
    *rows = pqrow::task_rows(slots, sizes, t, P, C, slot);
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

// The table and, with more than one warp, the warps' lists (of 32-bit
// keys with key32, bf16 tables only).
size_t smem_bytes(int kind, int M, int CB, int kp, bool key32) {
  const int warps = threads_of(kind) / 32;
  return table_bytes(kind, M, CB) +
         (warps > 1 ? (size_t)warps * 32 * keys_per_lane(kp) *
                          (key32 ? sizeof(uint32_t) : sizeof(u64))
                    : 0);
}

// The block's task loop: Key is the selection key (u64, or uint32_t on a
// bf16 table), kThreads the block.
template <typename Key, int kThreads, int KPL, typename CodeT, int kKind,
          bool kVec16>
__device__ __forceinline__ void scan_tasks(
    const void* lut, const float* scale, const float* bias,
    const CodeT* codes, const int* ids, const int* sizes, const int* slots,
    float* out_d, int* out_i, int T, int P, int C, int M, int CB, int kp,
    int tbytes) {
  constexpr bool kQuant = kKind == pqrow::kU8;
  constexpr int kWarps = kThreads / 32;
  constexpr int L = 32 * KPL;
  const Key none = none_key(Key());
  extern __shared__ __align__(16) unsigned char smem[];
  Key* lists = reinterpret_cast<Key*>(smem + tbytes);   // [kWarps][L]
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
    Key v[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = none;
    Key thr = none;                    // the warp's k_pad-th key
    const CodeT* base = codes + (size_t)slot * C * M;
    const uint4* base16 = reinterpret_cast<const uint4*>(base);
    uint4 next = {};                   // vec16: this lane's next row
    if constexpr (kVec16)
      if (warp * 32 + lane < rows) next = __ldg(base16 + warp * 32 + lane);
    for (int c0 = warp * 32; c0 < rows; c0 += kThreads) {
      const int c = c0 + lane;
      Key key = none;
      if constexpr (kVec16) {
        const uint4 w = next;
        if (c + kThreads < rows) next = __ldg(base16 + c + kThreads);
        if (c < rows) {
          float d;
          if constexpr (kQuant)
            d = pqrow::row_sum_vec16<kKind, 256>(w, tab, scl, CB) + bsum;
          else
            d = pqrow::row_sum_vec16<kKind, 256>(w, tab, tab.sc, CB);
          key = make_key(d, c, Key());
        }
      } else if (c < rows) {
        float d = pqrow::row_sum<CodeT, kKind>(base + (size_t)c * M, tab,
                                               tab.sc, M, CB);
        if constexpr (kQuant) d += bsum;
        key = make_key(d, c, Key());
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
        merge32<KPL>(v, keep ? key : none, lane);
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
        const Key* other = lists + (warp + half) * L;
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
          const uint32_t row = key_row(v[j]);
          const bool no_row = row == none_row(Key());
          out_d[(size_t)t * kp + i] = no_row ? INFINITY : key_dist(v[j]);
          out_i[(size_t)t * kp + i] = no_row ? -1
                                             : ids[(size_t)slot * C + row];
        }
      }
    }
    t = t1, slot = slot1, rows = rows1;
  }
}

// f32 and u8 tables, and bf16 tables of more than kMaxRowsKey32 rows a
// slot: 64-bit keys.
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
  scan_tasks<u64, threads_of<kKind>(), KPL, CodeT, kKind, kVec16>(
      lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
      CB, kp, tbytes);
}

// bf16 tables of at most kMaxRowsKey32 rows a slot: narrow (32-bit) keys.
template <int KPL, typename CodeT, bool kVec16>
__global__ void __launch_bounds__(kThreadsBF16)
    pq_scan_topk_narrow_kernel(const void* __restrict__ lut,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              const CodeT* __restrict__ codes,
                              const int* __restrict__ ids,
                              const int* __restrict__ sizes,
                              const int* __restrict__ slots,
                              float* __restrict__ out_d,
                              int* __restrict__ out_i, int T, int P, int C,
                              int M, int CB, int kp, int tbytes) {
  scan_tasks<uint32_t, kThreadsBF16, KPL, CodeT, pqrow::kBF16, kVec16>(
      lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
      CB, kp, tbytes);
}

template <int KPL, typename CodeT, int kKind, bool kVec16, bool kKey32>
int launch_typed(const void* lut, const void* scale, const void* bias,
                 const void* codes, const void* ids, const void* sizes,
                 const void* slots, void* out_d, void* out_i, int T, int P,
                 int C, int M, int CB, int kp, void* stream) {
  static_assert(!kKey32 || kKind == pqrow::kBF16, "32-bit keys: bf16 only");
  void (*kernel)(const void*, const float*, const float*, const CodeT*,
                 const int*, const int*, const int*, float*, int*, int, int,
                 int, int, int, int, int);
  if constexpr (kKey32)
    kernel = pq_scan_topk_narrow_kernel<KPL, CodeT, kVec16>;
  else
    kernel = pq_scan_topk_kernel<KPL, CodeT, kKind, kVec16>;
  const int threads = threads_of<kKind>();
  const size_t smem = smem_bytes(kKind, M, CB, kp, kKey32);
  static occupancy::Resident resident;
  int blocks = 0;
  const cudaError_t e =
      occupancy::resident_blocks(resident, kernel, threads, smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  const int grid = T < blocks ? T : blocks;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      lut, (const float*)scale, (const float*)bias, (const CodeT*)codes,
      (const int*)ids, (const int*)sizes, (const int*)slots, (float*)out_d,
      (int*)out_i, T, P, C, M, CB, kp, (int)table_bytes(kKind, M, CB));
  return (int)cudaGetLastError();
}

template <int KPL, int kKind, bool kKey32>
int launch_codes(const void* lut, const void* scale, const void* bias,
                 const void* codes, const void* ids, const void* sizes,
                 const void* slots, void* out_d, void* out_i, int T, int P,
                 int C, int M, int CB, int code_bytes, int kp, void* stream) {
  if (code_bytes == 4)
    return launch_typed<KPL, int32_t, kKind, false, kKey32>(
        lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
        CB, kp, stream);
  if (M == 16 && CB == 256 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch_typed<KPL, uint8_t, kKind, true, kKey32>(
        lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
        CB, kp, stream);
  return launch_typed<KPL, uint8_t, kKind, false, kKey32>(
      lut, scale, bias, codes, ids, sizes, slots, out_d, out_i, T, P, C, M,
      CB, kp, stream);
}

template <int kKind, bool kKey32 = false>
int launch(const void* lut, const void* scale, const void* bias,
           const void* codes, const void* ids, const void* sizes,
           const void* slots, void* out_d, void* out_i, int T, int P, int C,
           int M, int CB, int code_bytes, int kp, void* stream) {
  if (kp < 8 || kp > kMaxKPad || (kp & (kp - 1)) != 0 || sizes == nullptr ||
      (code_bytes != 1 && code_bytes != 4) || (slots == nullptr && P != T) ||
      (kKey32 && C > kMaxRowsKey32))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  switch (keys_per_lane(kp)) {
    case 1:
      return launch_codes<1, kKind, kKey32>(lut, scale, bias, codes, ids,
                                            sizes, slots, out_d, out_i, T, P,
                                            C, M, CB, code_bytes, kp, stream);
    case 2:
      return launch_codes<2, kKind, kKey32>(lut, scale, bias, codes, ids,
                                            sizes, slots, out_d, out_i, T, P,
                                            C, M, CB, code_bytes, kp, stream);
    case 4:
      return launch_codes<4, kKind, kKey32>(lut, scale, bias, codes, ids,
                                            sizes, slots, out_d, out_i, T, P,
                                            C, M, CB, code_bytes, kp, stream);
    default:
      return launch_codes<8, kKind, kKey32>(lut, scale, bias, codes, ids,
                                            sizes, slots, out_d, out_i, T, P,
                                            C, M, CB, code_bytes, kp, stream);
  }
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 u8, 2 bf16 table; key_bits: 32 (pq_scan_topk_bf16) or
// 64 (every other entry point).
size_t pq_scan_topk_smem_bytes(int kind, int M, int CB, int k_pad,
                               int key_bits) {
  return smem_bytes(kind, M, CB, k_pad, key_bits == 32);
}

// Threads of a block of the instances for a table kind.
int pq_scan_topk_threads(int kind) { return threads_of(kind); }

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

// lut (T, M, CB) bf16, the rest as for pq_scan_topk_f32, C at most
// 65,535 (32-bit keys; more: cudaErrorInvalidValue); each distance out is
// a bf16 value.
int pq_scan_topk_bf16(const void* lut, const void* codes, const void* ids,
                      const void* sizes, const void* slots, void* out_d,
                      void* out_i, int T, int P, int C, int M, int CB,
                      int code_bytes, int k_pad, void* stream) {
  return launch<pqrow::kBF16, true>(lut, nullptr, nullptr, codes, ids, sizes,
                                    slots, out_d, out_i, T, P, C, M, CB,
                                    code_bytes, k_pad, stream);
}

// pq_scan_topk_bf16 with 64-bit keys, for any C.
int pq_scan_topk_bf16_wide(const void* lut, const void* codes,
                           const void* ids, const void* sizes,
                           const void* slots, void* out_d, void* out_i, int T,
                           int P, int C, int M, int CB, int code_bytes,
                           int k_pad, void* stream) {
  return launch<pqrow::kBF16>(lut, nullptr, nullptr, codes, ids, sizes,
                              slots, out_d, out_i, T, P, C, M, CB,
                              code_bytes, k_pad, stream);
}

const char* pq_scan_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
