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
// both overloads run one block body (scan_rows, the slot form a template
// parameter), so the dense instances are the code they were.
//
// The TPU kernels turned the gather into a one-hot MXU contraction,
// because a lane gather is slow there.  On Hopper a gather out of shared
// memory is cheap, so this is the paper's own loop: table lookups + adds.
//
// What bounds it on an H100: bytes.  Per task it reads the table (16 KB
// f32, 8 KB bf16 or 4 KB u8 at M=16, CB=256) and 16 bytes of codes per
// valid row, and writes 4 bytes per row; the adds are ~1 op per byte
// read.  The design:
//
//   * grid (T, ceil(C / 1024)): a block stages its task's table in
//     shared memory once and scores up to 1024 rows with 256 threads;
//   * a thread reads a row's M=16 u8 codes as one 16-byte load (generic
//     loop for other M and for int32 codes), then M lookups out of shared
//     memory, summed in order m = 0..M-1;
//   * rows past the task's size are not read: they are written +inf.
//
// The staging and the row distance live in pq_row.cuh, shared with the
// fused DC+TS kernels (pq_scan_topk.cu).  The kernels allocate nothing and
// never synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pq_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 1024;

// One block of kernel C: stage task t's table, then score the block's
// rows of the task's slot (slot t in the dense form).
template <typename CodeT, int kKind, bool kVec16, bool kSlots>
__device__ __forceinline__ void scan_rows(const void* __restrict__ lut,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          const CodeT* __restrict__ codes,
                                          const int* __restrict__ sizes,
                                          const int* __restrict__ slots,
                                          float* __restrict__ out, int P,
                                          int C, int M, int CB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  pqrow::stage_table<kKind, kThreads>(lut, scale, bias, t, M, CB, smem);
  const pqrow::Table tab = pqrow::table_view(smem, M, CB);

  int s = t, size;
  if constexpr (kSlots)
    size = pqrow::task_rows(slots, sizes, t, P, C, &s);
  else
    size = sizes == nullptr ? C : min(sizes[t], C);
  const int c0 = blockIdx.y * kRowsPerBlock;
  const int c1 = min(c0 + kRowsPerBlock, C);
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
    out[(size_t)t * C + c] =
        c < size ? pqrow::row_dist<CodeT, kKind, kVec16>(
                       codes + ((size_t)s * C + c) * M, tab, M, CB)
                 : INFINITY;
  }
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
  scan_rows<CodeT, kKind, kVec16, false>(lut, scale, bias, codes, sizes,
                                         nullptr, out, 0, C, M, CB);
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
  scan_rows<CodeT, kKind, kVec16, true>(lut, scale, bias, codes, sizes,
                                        slots, out, P, C, M, CB);
}

size_t smem_bytes(int kind, int M, int CB) {
  return pqrow::table_smem_bytes(kind, M, CB);
}

// Launch one overload of the kernel on a (T, ceil(C / kRowsPerBlock)) grid.
template <typename Kernel, typename... Args>
int run(Kernel kernel, size_t smem, int T, int C, void* stream,
        Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(T, (C + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args...);
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
    return run(dense, smem, T, C, stream, lut, sc, bi, co, sz, (float*)out,
               C, M, CB);
  }
  void (*by_slot)(const void*, const float*, const float*, const CodeT*,
                  const int*, const int*, float*, int, int, int, int) =
      pq_scan_kernel<CodeT, kKind, kVec16>;
  return run(by_slot, smem, T, C, stream, lut, sc, bi, co, sz,
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
