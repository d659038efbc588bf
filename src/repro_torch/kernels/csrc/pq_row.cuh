// One PQ code row against one task's lookup table, shared by the DC
// kernels (pq_scan.cu) and the fused DC+TS kernels (pq_scan_topk.cu), and
// the slot convention they and TS by slot (ts_topk.cu) read slots by
// (slot_rows, task_rows).  Included by pq_scan.cu, pq_scan_topk.cu and
// ts_topk.cu.
//
// Both score a row by summing its terms in order m = 0..M-1 (row_sum,
// then the u8 path's bias sum, or the bf16 path's one rounding), so the
// fused and the unfused scans give the same float for every row.  Both
// copy a task's table in with stage_table_async, which other blocks'
// scans overlap, and sum the u8 path's biases themselves (bias_sum).
//
// Three kinds of table (the template parameter kKind):
//   kF32   f32 entries, summed in f32;
//   kU8    u8 entries with a scale and a bias per subspace;
//   kBF16  bf16 entries, each widened to f32 and summed in f32, the row's
//          sum rounded once to bf16 (round to nearest even) and widened
//          back: the reference's jnp.sum over a bf16 gather.
//
// Shared-memory layout of one staged table: f32 (M, CB); bf16 (M, CB); or
// u8 (M, CB) padded to 16 bytes and followed by the M scales, one float
// no kernel writes, and the M biases.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace pqrow {

// Table kinds; the values are those of the C entry points' `kind`
// arguments (the f32 / u8 ones were `quant` 0 / 1).
constexpr int kF32 = 0;
constexpr int kU8 = 1;
constexpr int kBF16 = 2;

inline size_t table_smem_bytes(int kind, int M, int CB) {
  const size_t mcb = (size_t)M * CB;
  if (kind == kF32) return mcb * sizeof(float);
  if (kind == kBF16) return mcb * sizeof(__nv_bfloat16);
  return ((mcb + 15) & ~(size_t)15) + (2 * M + 1) * sizeof(float);
}

// An u8 table entry as a float, exactly (the bits of 2^23 + q, minus
// 2^23): two full-rate instructions in place of a conversion.
__device__ __forceinline__ float u8_float(uint32_t q) {
  return __uint_as_float(0x4b000000u | q) - 8388608.0f;
}

// A row's f32 sum of bf16 entries as the bf16 path scores it: rounded
// once to bf16 (nearest even) and widened back.
__device__ __forceinline__ float round_bf16(float acc) {
  return __bfloat162float(__float2bfloat16_rn(acc));
}

// The views of a staged table: f32 entries, u8 entries, bf16 entries, the
// scales (sc[0..M-1]) and, from sc[M + 1] on, the biases.
struct Table {
  const float* lut_f;
  const uint8_t* lut_q;
  const __nv_bfloat16* lut_h;
  const float* sc;
};

template <int kKind, typename Scales>
__device__ __forceinline__ float add_entry(float acc, int m, int code,
                                           const Table& tab,
                                           const Scales& sc, int CB) {
  if constexpr (kKind == kU8)
    return fmaf(sc[m], u8_float(tab.lut_q[m * CB + code]), acc);
  else if constexpr (kKind == kBF16)
    return acc + __bfloat162float(tab.lut_h[m * CB + code]);
  else
    return acc + tab.lut_f[m * CB + code];
}

// The M=16 u8 codes of one row, loaded as one 16-byte word, against the
// table: the terms summed in order m = 0..15, without the u8 bias sum
// (bf16: the sum rounded once).  `sc` is the staged scales or a copy of
// them in registers; kCB > 0 fixes CB at compile time (the table offsets
// become immediates).
template <int kKind, int kCB = 0, typename Scales>
__device__ __forceinline__ float row_sum_vec16(uint4 v, const Table& tab,
                                               const Scales& sc, int CB) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const int cb = kCB > 0 ? kCB : CB;
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int code = __byte_perm(w[m >> 2], 0, 0x4440 + (m & 3));  // byte m
    acc = add_entry<kKind>(acc, m, code, tab, sc, cb);
  }
  if constexpr (kKind == kBF16) acc = round_bf16(acc);
  return acc;
}

// One code row of any M and code type: the terms summed in order m =
// 0..M-1, without the u8 bias sum (bf16: the sum rounded once).
template <typename CodeT, int kKind>
__device__ __forceinline__ float row_sum(const CodeT* row, const Table& tab,
                                         const float* sc, int M, int CB) {
  float acc = 0.0f;
  for (int m = 0; m < M; ++m)
    acc = add_entry<kKind>(acc, m, (int)row[m], tab, sc, CB);
  if constexpr (kKind == kBF16) acc = round_bf16(acc);
  return acc;
}

// The valid rows of slot s: its size clamped to [0, C], 0 for a slot
// outside [0, P) (-1: no task).
__device__ __forceinline__ int slot_rows(const int* sizes, int s, int P,
                                         int C) {
  return (s >= 0 && s < P) ? max(0, min(sizes[s], C)) : 0;
}

// Task t's slot and its number of valid rows (0: no slot or no rows):
// slots == NULL reads slot t (the dense form).
__device__ __forceinline__ int task_rows(const int* slots, const int* sizes,
                                         int t, int P, int C, int* slot) {
  const int s = slots == nullptr ? t : slots[t];
  *slot = s;
  return slot_rows(sizes, s, P, C);
}

// The u8 path's bias sum from a staged table's biases, in order m =
// 0..M-1, added to each row's sum last.
__device__ __forceinline__ float bias_sum(const float* sc, int M) {
  float b = 0.0f;
  for (int m = 0; m < M; ++m) b += sc[M + 1 + m];
  return b;
}

// Asynchronous copies from device memory into shared memory (cp.async):
// issued by each thread, awaited by cp_async_wait_all (all of this
// thread's copies), visible to the block after a barrier that follows it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copy of `bytes` bytes with the whole block: 16 bytes a copy
// where the size and both addresses allow it, else 4 bytes a copy, else
// (a byte-sized table) plain loads and stores, which a barrier makes
// visible like the rest.
template <int kThreads>
__device__ __forceinline__ void copy_in_async(unsigned char* dst,
                                              const unsigned char* src,
                                              size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) | bytes;
  if (a % 16 == 0) {
    for (size_t i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
      cp_async16(dst + i, src + i);
  } else if (a % 4 == 0) {
    for (size_t i = threadIdx.x * 4; i < bytes; i += kThreads * 4)
      cp_async4(dst + i, src + i);
  } else {
    for (size_t i = threadIdx.x; i < bytes; i += kThreads) dst[i] = src[i];
  }
}

// Issue the copy of task t's table into shared memory (the layout above)
// without waiting for it.  Once the copy has landed, the caller sums the
// biases sc[M+1..2M] in order m = 0..M-1 itself (bias_sum).
template <int kKind, int kThreads>
__device__ __forceinline__ void stage_table_async(const void* lut,
                                                  const float* scale,
                                                  const float* bias, int t,
                                                  int M, int CB,
                                                  unsigned char* smem) {
  const size_t mcb = (size_t)M * CB;
  if constexpr (kKind == kU8) {
    float* sc = reinterpret_cast<float*>(smem + ((mcb + 15) & ~(size_t)15));
    copy_in_async<kThreads>(
        smem, static_cast<const uint8_t*>(lut) + (size_t)t * mcb, mcb);
    for (int i = threadIdx.x; i < M; i += kThreads) {
      cp_async4(sc + i, scale + (size_t)t * M + i);
      cp_async4(sc + M + 1 + i, bias + (size_t)t * M + i);
    }
  } else if constexpr (kKind == kBF16) {
    copy_in_async<kThreads>(
        smem,
        reinterpret_cast<const unsigned char*>(static_cast<const uint16_t*>(
                                                   lut) + (size_t)t * mcb),
        mcb * sizeof(uint16_t));
  } else {
    copy_in_async<kThreads>(
        smem,
        reinterpret_cast<const unsigned char*>(static_cast<const float*>(lut) +
                                               (size_t)t * mcb),
        mcb * sizeof(float));
  }
}

// A staged table's views (the one of its kind is read).
__device__ __forceinline__ Table table_view(const unsigned char* smem, int M,
                                            int CB) {
  const int mcb = M * CB;
  return {reinterpret_cast<const float*>(smem), smem,
          reinterpret_cast<const __nv_bfloat16*>(smem),
          reinterpret_cast<const float*>(smem + ((mcb + 15) & ~15))};
}

}  // namespace pqrow
