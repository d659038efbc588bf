// DC phase on Hopper: the PQ code scan over padded clusters.
//
// Replaces the Pallas TPU kernels `pq_scan_dc_pallas` and
// `pq_scan_dc_q_pallas` (src/repro/kernels/pq_scan.py), plus the sizes
// mask their wrapper applied afterwards (src/repro/kernels/ops.py), and
// computes the reference's plain DC over a bf16 table
// (src/repro/core/sharded_search.py `_shard_tasks_fn(lut_dtype=bf16)`):
//
//     f32:  d[t, c] = sum_m lut[t, m, codes[t, c, m]]
//     u8:   d[t, c] = sum_m scale[t, m] * lut_q[t, m, codes[t, c, m]]
//                     + sum_m bias[t, m]
//     bf16: d[t, c] = bf16_rn(sum_m f32(lut_h[t, m, codes[t, c, m]]))
//     rows c >= sizes[t] are written as +inf (sizes == NULL: all valid).
//
// Slots: with a slot table, codes (P, C, M) and sizes (P,) are P code
// slots (the padded clusters as they lie on the card), and task t reads
// the rows of slot slots[t] where they are, as the fused kernels do
// (pq_row.cuh task_rows): codes[t] and sizes[t] above become
// codes[slots[t]] and sizes[slots[t]], and a slot outside [0, P) has
// size 0.  So the engine scans the probed clusters without a copy of
// their codes.  The slot form is the kernel's overload with a slot table;
// both overloads run one block body (scan_task).
//
// The TPU kernels turned the gather into a one-hot MXU contraction,
// because a lane gather is slow there.  On Hopper a gather out of shared
// memory is cheap, so this is the paper's own loop: table lookups + adds.
//
// What bounds it on an H100: bytes.  Per task it reads the table (16 KB
// f32, 8 KB bf16 or 4 KB u8 at M=16, CB=256) and 16 bytes of codes per
// valid row, and writes 4 bytes per row, padding included; the adds are
// ~1 op per byte read.  The design reads each task's table from device
// memory once a launch, and not at all for a task with no valid row:
//
//   * grid (T): one block of 256 threads a task.  It reads the task's
//     size first; if the task has a valid row it issues the copy of the
//     table into shared memory with cp.async (pq_row.cuh
//     stage_table_async), writes the padding while the copy lands, then
//     scores rows [0, size) against that one copy.  A task with no valid
//     row reads no table;
//   * a thread reads a row's M=16 u8 codes as one 16-byte load (the next
//     row's load in flight while this one is scored; generic loop for
//     other M and for int32 codes), then M lookups out of shared memory,
//     summed in order m = 0..M-1 (pq_row.cuh row_sum, the u8 bias sum
//     added last);
//   * rows [size, C) are not read: they are written +inf with 16-byte
//     stores, no table needed.
//
// A persistent grid (as many blocks as fit at once, each walking tasks b,
// b + grid, ...) was 4-7% slower on the H100 at the benchmark's chunk
// than one block a task (PERF.md).
//
// The staging and the row distance live in pq_row.cuh, shared with the
// fused DC+TS kernels (pq_scan_topk.cu).  The kernels allocate nothing and
// never synchronise with the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pq_row.cuh"

namespace {

constexpr int kThreads = 256;

// row[c] = +inf for c in [c0, C), with the whole block: 16-byte stores
// from the first 16-byte boundary on.
__device__ __forceinline__ void write_padding(float* row, int c0, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + c0);
  const int head = min(C, c0 + (int)(((16 - (a & 15)) & 15) / 4));
  const int n4 = (C - head) / 4, tail = head + 4 * n4;
  if (c0 + (int)threadIdx.x < head) row[c0 + threadIdx.x] = INFINITY;
  float4* v = reinterpret_cast<float4*>(row + head);
  const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
  for (int i = threadIdx.x; i < n4; i += kThreads) v[i] = inf4;
  if (tail + (int)threadIdx.x < C) row[tail + threadIdx.x] = INFINITY;
}

// Score rows [0, rows) of code slot `base` against the staged table into
// `o`: each row's terms summed in order m = 0..M-1, the u8 bias sum
// `bsum` added last.
template <typename CodeT, int kKind, bool kVec16>
__device__ __forceinline__ void score_rows(const CodeT* __restrict__ base,
                                           const pqrow::Table& tab,
                                           float bsum,
                                           float* __restrict__ o, int rows,
                                           int M, int CB) {
  if constexpr (kVec16) {
    float scl[16];                       // u8: the scales in registers
    if constexpr (kKind == pqrow::kU8) {
#pragma unroll
      for (int m = 0; m < 16; ++m) scl[m] = tab.sc[m];
    }
    const uint4* base16 = reinterpret_cast<const uint4*>(base);
    uint4 next = {};
    if ((int)threadIdx.x < rows) next = __ldg(base16 + threadIdx.x);
    for (int c = threadIdx.x; c < rows; c += kThreads) {
      const uint4 w = next;
      if (c + kThreads < rows) next = __ldg(base16 + c + kThreads);
      float d;
      if constexpr (kKind == pqrow::kU8)
        d = pqrow::row_sum_vec16<kKind>(w, tab, scl, CB) + bsum;
      else
        d = pqrow::row_sum_vec16<kKind>(w, tab, tab.sc, CB);
      o[c] = d;
    }
  } else {
    for (int c = threadIdx.x; c < rows; c += kThreads) {
      float d = pqrow::row_sum<CodeT, kKind>(base + (size_t)c * M, tab,
                                             tab.sc, M, CB);
      if constexpr (kKind == pqrow::kU8) d += bsum;
      o[c] = d;
    }
  }
}

// One block of kernel C: task t = blockIdx.x reads slot slots[t] of P
// (slots == NULL: slot t), all C rows valid without sizes.  If the task
// has a valid row, issue its table's copy; write the padding while the
// copy lands; then score the rows against the table.
template <typename CodeT, int kKind, bool kVec16>
__device__ __forceinline__ void scan_task(const void* __restrict__ lut,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          const CodeT* __restrict__ codes,
                                          const int* __restrict__ sizes,
                                          const int* __restrict__ slots,
                                          float* __restrict__ out, int P,
                                          int C, int M, int CB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  int slot = t;
  const int rows =
      sizes == nullptr ? C : pqrow::task_rows(slots, sizes, t, P, C, &slot);
  float* o = out + (size_t)t * C;
  if (rows > 0)
    pqrow::stage_table_async<kKind, kThreads>(lut, scale, bias, t, M, CB,
                                              smem);
  write_padding(o, rows, C);
  if (rows == 0) return;
  pqrow::cp_async_wait_all();            // this thread's copies
  __syncthreads();                       // ... and everyone's
  const pqrow::Table tab = pqrow::table_view(smem, M, CB);
  const float bsum = kKind == pqrow::kU8 ? pqrow::bias_sum(tab.sc, M) : 0.0f;
  score_rows<CodeT, kKind, kVec16>(codes + (size_t)slot * C * M, tab, bsum,
                                   o, rows, M, CB);
}

// The dense form: task t reads slot t.
template <typename CodeT, int kKind, bool kVec16>
__global__ void __launch_bounds__(kThreads)
    pq_scan_kernel(const void* __restrict__ lut,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const CodeT* __restrict__ codes,
                   const int* __restrict__ sizes, float* __restrict__ out,
                   int C, int M, int CB) {
  scan_task<CodeT, kKind, kVec16>(lut, scale, bias, codes, sizes, nullptr,
                                  out, gridDim.x, C, M, CB);
}

// The slot form: task t reads slot slots[t] of P.
template <typename CodeT, int kKind, bool kVec16>
__global__ void __launch_bounds__(kThreads)
    pq_scan_kernel(const void* __restrict__ lut,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const CodeT* __restrict__ codes,
                   const int* __restrict__ sizes,
                   const int* __restrict__ slots, float* __restrict__ out,
                   int P, int C, int M, int CB) {
  scan_task<CodeT, kKind, kVec16>(lut, scale, bias, codes, sizes, slots,
                                  out, P, C, M, CB);
}

size_t smem_bytes(int kind, int M, int CB) {
  return pqrow::table_smem_bytes(kind, M, CB);
}

// Launch one overload of the kernel on a grid of T blocks, a task each.
template <typename Kernel, typename... Args>
int run(Kernel kernel, size_t smem, int T, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<T, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename CodeT, int kKind, bool kVec16>
int launch_typed(const void* lut, const void* scale, const void* bias,
                 const void* codes, const void* sizes, const void* slots,
                 void* out, int T, int P, int C, int M, int CB,
                 void* stream) {
  const size_t smem = smem_bytes(kKind, M, CB);
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  const CodeT* co = (const CodeT*)codes;
  const int* sz = (const int*)sizes;
  if (slots == nullptr) {
    void (*dense)(const void*, const float*, const float*, const CodeT*,
                  const int*, float*, int, int, int) =
        pq_scan_kernel<CodeT, kKind, kVec16>;
    return run(dense, smem, T, stream, lut, sc, bi, co, sz, (float*)out, C,
               M, CB);
  }
  void (*by_slot)(const void*, const float*, const float*, const CodeT*,
                  const int*, const int*, float*, int, int, int, int) =
      pq_scan_kernel<CodeT, kKind, kVec16>;
  return run(by_slot, smem, T, stream, lut, sc, bi, co, sz,
             (const int*)slots, (float*)out, P, C, M, CB);
}

template <int kKind>
int launch(const void* lut, const void* scale, const void* bias,
           const void* codes, const void* sizes, const void* slots,
           void* out, int T, int P, int C, int M, int CB, int code_bytes,
           void* stream) {
  if (T == 0 || C == 0) return (int)cudaSuccess;
  if (code_bytes != 1 && code_bytes != 4)
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 4)
    return launch_typed<int32_t, kKind, false>(lut, scale, bias, codes,
                                                sizes, slots, out, T, P, C,
                                                M, CB, stream);
  if (M == 16 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch_typed<uint8_t, kKind, true>(lut, scale, bias, codes,
                                               sizes, slots, out, T, P, C,
                                               M, CB, stream);
  return launch_typed<uint8_t, kKind, false>(lut, scale, bias, codes, sizes,
                                              slots, out, T, P, C, M, CB,
                                              stream);
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 u8, 2 bf16 table.
size_t pq_scan_smem_bytes(int kind, int M, int CB) {
  return smem_bytes(kind, M, CB);
}

// lut (T, M, CB) f32, codes (T, C, M) u8 (code_bytes=1) or i32 (4),
// sizes (T,) i32 or NULL -> out (T, C) f32.  With slots ((T,) i32, not
// NULL) codes are (P, C, M), sizes (P,) and not NULL, and task t reads slot
// slots[t].  Returns cudaGetLastError().
int pq_scan_f32(const void* lut, const void* codes, const void* sizes,
                const void* slots, void* out, int T, int P, int C, int M,
                int CB, int code_bytes, void* stream) {
  return launch<pqrow::kF32>(lut, nullptr, nullptr, codes, sizes, slots, out,
                             T, P, C, M, CB, code_bytes, stream);
}

// lut_q (T, M, CB) u8, scale/bias (T, M) f32, codes, sizes, slots as above.
int pq_scan_u8(const void* lut_q, const void* scale, const void* bias,
               const void* codes, const void* sizes, const void* slots,
               void* out, int T, int P, int C, int M, int CB, int code_bytes,
               void* stream) {
  return launch<pqrow::kU8>(lut_q, scale, bias, codes, sizes, slots, out, T,
                            P, C, M, CB, code_bytes, stream);
}

// lut (T, M, CB) bf16, codes, sizes, slots as above -> out (T, C) f32,
// each valid row's value a bf16 one.
int pq_scan_bf16(const void* lut, const void* codes, const void* sizes,
                 const void* slots, void* out, int T, int P, int C, int M,
                 int CB, int code_bytes, void* stream) {
  return launch<pqrow::kBF16>(lut, nullptr, nullptr, codes, sizes, slots,
                              out, T, P, C, M, CB, code_bytes, stream);
}

const char* pq_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
