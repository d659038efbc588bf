// Fused DC + TS on Hopper: the PQ code scan with a per-task top-k.
//
// Replaces the Pallas TPU kernels `pq_scan_topk_pallas` and
// `pq_scan_topk_q_pallas` (src/repro/kernels/pq_scan.py), the per-shard
// scan of the sharded engine:
//
//     d[t, c]  = the row distance of pq_scan.cu (f32 or u8 table)
//     out[t]   = the k_pad smallest (d[t, c], c) over rows c < sizes[t],
//                ascending, as (distance, ids[t, c]); slots past the
//                valid rows are (+inf, -1).
//
// The (T, C) distance matrix never reaches device memory.  Ties are
// broken by row, so the output is a function of the inputs alone: no
// atomics, and the order of the candidates in shared memory comes from a
// block-wide prefix count, not from scheduling.
//
// What bounds it on an H100: bytes.  The function reads each non-empty
// task's table (M*CB*4 bytes f32; M*CB + 8*M u8), the codes of the valid
// rows, the ids of the winners only (min(sizes[t], k_pad) a task), every
// task's size, and writes T * k_pad * 8 bytes:
//
//     T_nonempty * M*CB*b_lut + valid_rows * M*code_bytes
//         + winner_rows * 4 + T * (4 + 8*k_pad)
//
// (the kernel looks an id up only once its row has won).  The selection
// costs a few compare-exchanges per surviving row, far below the card's
// integer rate.  The design:
//
//   * one block of 256 threads per task; a zero-size task writes k_pad x
//     (+inf, -1) and exits without reading its table;
//   * the task's table is staged in shared memory once (pq_row.cuh, the
//     same staging and row distance as pq_scan.cu, so both scans give the
//     same float for a row), and the block walks the valid rows 256 at a
//     time: one row per thread, one 16-byte code load per row at M = 16
//     u8 (the loop inside the block replaces the TPU's sequential C grid
//     axis);
//   * a row is a 64-bit key (order-preserving bits of its distance, row)
//     and survives only below the current k_pad-th key; survivors are
//     appended to a shared buffer at offsets given by a warp ballot plus
//     a count across the 8 warps, so their order does not depend on
//     scheduling;
//   * once more than 256 survivors are pending, the winners and the
//     pending keys are bitonic-sorted together in shared memory (at most
//     512 keys), the k_pad-th key becomes the new threshold, and the
//     round's rows are filtered again against it; one last sort at the
//     end.  After the first sort the threshold rejects most rows, so the
//     sorts stay few.
//
// k_pad is a power of two in [8, 256].  The kernels allocate nothing and
// never synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pq_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKPad = 256;
constexpr int kPending = kThreads;      // pending survivors that force a sort
constexpr int kSortCap = kMaxKPad + kPending;   // keys in the shared buffer
constexpr unsigned long long kNone = 0xff800000ffffffffull;  // (+inf, none)

__device__ __forceinline__ uint32_t ordered_bits(float d) {
  const uint32_t u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Sort keys[0, n) ascending, n a power of two; ends with a barrier.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Fold the cnt candidates in keys[kp, kp + cnt) into the sorted winners
// keys[0, kp): after it keys[0, kp) holds the kp smallest keys, sorted.
__device__ void merge(unsigned long long* keys, int kp, int cnt) {
  __syncthreads();                       // the candidates' stores land
  const int used = kp + cnt;
  const int n = 1 << (32 - __clz(used - 1));
  for (int i = used + threadIdx.x; i < n; i += kThreads) keys[i] = kNone;
  __syncthreads();
  bitonic_sort(keys, n);
}

// This thread's offset among the block's kept keys, in (warp, lane)
// order, and their total.  All threads call it; it ends after a barrier.
// The merge's barriers separate a round's second call from its first.
__device__ __forceinline__ int block_offset(bool keep, int* wc, int lane,
                                            int warp, int* total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) wc[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int n = wc[w];
    before += w < warp ? n : 0;
    all += n;
  }
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

size_t table_bytes(bool quant, int M, int CB) {
  return (pqrow::table_smem_bytes(quant, M, CB) + 15) & ~(size_t)15;
}

size_t smem_bytes(bool quant, int M, int CB) {
  return table_bytes(quant, M, CB) + kSortCap * sizeof(unsigned long long) +
         2 * kWarps * sizeof(int);
}

template <typename CodeT, bool kQuant, bool kVec16>
__global__ void __launch_bounds__(kThreads)
    pq_scan_topk_kernel(const void* __restrict__ lut,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const CodeT* __restrict__ codes,
                        const int* __restrict__ ids,
                        const int* __restrict__ sizes,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int C, int M, int CB, int kp, int tbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int size = max(0, min(sizes[t], C));
  float* od = out_d + (size_t)t * kp;
  int* oi = out_i + (size_t)t * kp;
  if (size == 0) {
    for (int j = tid; j < kp; j += kThreads) {
      od[j] = INFINITY;
      oi[j] = -1;
    }
    return;
  }
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + tbytes);
  int* wcount = reinterpret_cast<int*>(keys + kSortCap);  // [2][kWarps]
  for (int j = tid; j < kp; j += kThreads) keys[j] = kNone;
  pqrow::stage_table<kQuant, kThreads>(lut, scale, bias, t, M, CB, smem);
  const pqrow::Table tab = pqrow::table_view(smem, M, CB);

  const int lane = tid & 31, warp = tid >> 5;
  unsigned long long thr = kNone;       // the current kp-th key
  int cnt = 0;                          // pending keys in keys[kp, kp + cnt)
  for (int c0 = 0, r = 0; c0 < size; c0 += kThreads, ++r) {
    const int c = c0 + tid;
    unsigned long long key = kNone;
    if (c < size) {
      const float d = pqrow::row_dist<CodeT, kQuant, kVec16>(
          codes + ((size_t)t * C + c) * M, tab.lut_f, tab.lut_q, tab.sc, M,
          CB);
      key = ((unsigned long long)ordered_bits(d) << 32) | (uint32_t)c;
    }
    int* wc = wcount + (r & 1) * kWarps;   // double-buffered counts
    bool keep = key < thr;
    int total;
    int at = block_offset(keep, wc, lane, warp, &total);
    if (cnt + total > kPending) {         // uniform across the block
      merge(keys, kp, cnt);
      thr = keys[kp - 1];
      cnt = 0;
      keep = key < thr;
      at = block_offset(keep, wc, lane, warp, &total);
    }
    if (keep) keys[kp + cnt + at] = key;
    cnt += total;
  }
  if (cnt > 0) merge(keys, kp, cnt);
  for (int j = tid; j < kp; j += kThreads) {
    const unsigned long long key = keys[j];
    const uint32_t row = (uint32_t)key;
    const bool none = row == 0xffffffffu;
    od[j] = none ? INFINITY : from_ordered((uint32_t)(key >> 32));
    oi[j] = none ? -1 : ids[(size_t)t * C + row];
  }
}

template <typename CodeT, bool kQuant, bool kVec16>
int launch_typed(const void* lut, const void* scale, const void* bias,
                 const void* codes, const void* ids, const void* sizes,
                 void* out_d, void* out_i, int T, int C, int M, int CB,
                 int kp, void* stream) {
  auto kernel = pq_scan_topk_kernel<CodeT, kQuant, kVec16>;
  const size_t smem = smem_bytes(kQuant, M, CB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<T, kThreads, smem, (cudaStream_t)stream>>>(
      lut, (const float*)scale, (const float*)bias, (const CodeT*)codes,
      (const int*)ids, (const int*)sizes, (float*)out_d, (int*)out_i, C, M,
      CB, kp, (int)table_bytes(kQuant, M, CB));
  return (int)cudaGetLastError();
}

template <bool kQuant>
int launch(const void* lut, const void* scale, const void* bias,
           const void* codes, const void* ids, const void* sizes, void* out_d,
           void* out_i, int T, int C, int M, int CB, int code_bytes, int kp,
           void* stream) {
  if (kp < 8 || kp > kMaxKPad || (kp & (kp - 1)) != 0 || sizes == nullptr ||
      (code_bytes != 1 && code_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  if (code_bytes == 4)
    return launch_typed<int32_t, kQuant, false>(lut, scale, bias, codes, ids,
                                                sizes, out_d, out_i, T, C, M,
                                                CB, kp, stream);
  if (M == 16 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch_typed<uint8_t, kQuant, true>(lut, scale, bias, codes, ids,
                                               sizes, out_d, out_i, T, C, M,
                                               CB, kp, stream);
  return launch_typed<uint8_t, kQuant, false>(lut, scale, bias, codes, ids,
                                              sizes, out_d, out_i, T, C, M,
                                              CB, kp, stream);
}

}  // namespace

extern "C" {

size_t pq_scan_topk_smem_bytes(int quant, int M, int CB) {
  return smem_bytes(quant != 0, M, CB);
}

// lut (T, M, CB) f32, codes (T, C, M) u8 (code_bytes=1) or i32 (4),
// ids (T, C) i32, sizes (T,) i32 -> out_d (T, k_pad) f32 ascending,
// out_i (T, k_pad) i32.  Returns cudaGetLastError().
int pq_scan_topk_f32(const void* lut, const void* codes, const void* ids,
                     const void* sizes, void* out_d, void* out_i, int T,
                     int C, int M, int CB, int code_bytes, int k_pad,
                     void* stream) {
  return launch<false>(lut, nullptr, nullptr, codes, ids, sizes, out_d,
                       out_i, T, C, M, CB, code_bytes, k_pad, stream);
}

// lut_q (T, M, CB) u8, scale/bias (T, M) f32, the rest as above.
int pq_scan_topk_u8(const void* lut_q, const void* scale, const void* bias,
                    const void* codes, const void* ids, const void* sizes,
                    void* out_d, void* out_i, int T, int C, int M, int CB,
                    int code_bytes, int k_pad, void* stream) {
  return launch<true>(lut_q, scale, bias, codes, ids, sizes, out_d, out_i, T,
                      C, M, CB, code_bytes, k_pad, stream);
}

const char* pq_scan_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
