// One PQ code row against one task's lookup table, shared by the DC
// kernels (pq_scan.cu) and the fused DC+TS kernels (pq_scan_topk.cu).
//
// Both stage a task's table in shared memory with stage_table and score a
// row with row_dist, summing the terms in order m = 0..M-1, so the fused
// and the unfused scans give the same float for every row.
//
// Shared-memory layout of one staged table: f32 (M, CB), or u8 (M, CB)
// padded to 16 bytes and followed by the M scales, the bias sum and the
// M biases it was summed from.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace pqrow {

inline size_t table_smem_bytes(bool quant, int M, int CB) {
  const size_t mcb = (size_t)M * CB;
  if (!quant) return mcb * sizeof(float);
  return ((mcb + 15) & ~(size_t)15) + (2 * M + 1) * sizeof(float);
}

template <bool kQuant>
__device__ __forceinline__ float add_entry(float acc, int m, int code,
                                           const float* lut_f,
                                           const uint8_t* lut_q,
                                           const float* sc, int CB) {
  if constexpr (kQuant) return fmaf(sc[m], (float)lut_q[m * CB + code], acc);
  return acc + lut_f[m * CB + code];
}

// Distance of one code row, summed in order m = 0..M-1.  kVec16: M == 16
// u8 codes read as one 16-byte load (the row must be 16-byte aligned).
template <typename CodeT, bool kQuant, bool kVec16>
__device__ __forceinline__ float row_dist(const CodeT* row, const float* lut_f,
                                          const uint8_t* lut_q,
                                          const float* sc, int M, int CB) {
  float acc = 0.0f;
  if constexpr (kVec16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 16; ++m)
      acc = add_entry<kQuant>(acc, m, (w[m >> 2] >> (8 * (m & 3))) & 0xff,
                              lut_f, lut_q, sc, CB);
  } else {
    for (int m = 0; m < M; ++m)
      acc = add_entry<kQuant>(acc, m, (int)row[m], lut_f, lut_q, sc, CB);
  }
  if constexpr (kQuant) acc += sc[M];
  return acc;
}

// Copy n elements of T from device memory into shared memory with the
// whole block: 16 bytes a thread per load where the size and the source
// allow it, so a thread keeps several loads in flight (the stride is a
// compile-time constant, so the loop unrolls).
template <typename T, int kThreads>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int n) {
  const size_t bytes = (size_t)n * sizeof(T);
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int n16 = (int)(bytes / 16);
#pragma unroll 4
    for (int i = threadIdx.x; i < n16; i += kThreads) d[i] = s[i];
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// Copy task t's table into shared memory with the whole block; ends with
// a barrier.  The bias sum sc[M] is taken in order m = 0..M-1 by one
// thread, from biases staged in shared memory first.
template <bool kQuant, int kThreads>
__device__ __forceinline__ void stage_table(const void* lut,
                                            const float* scale,
                                            const float* bias, int t, int M,
                                            int CB, unsigned char* smem) {
  const int mcb = M * CB;
  if constexpr (kQuant) {
    float* sc = reinterpret_cast<float*>(smem + ((mcb + 15) & ~15));
    copy_in<uint8_t, kThreads>(
        smem, static_cast<const uint8_t*>(lut) + (size_t)t * mcb, mcb);
    for (int i = threadIdx.x; i < M; i += kThreads) {
      sc[i] = scale[(size_t)t * M + i];
      sc[M + 1 + i] = bias[(size_t)t * M + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = 0.0f;
      for (int m = 0; m < M; ++m) b += sc[M + 1 + m];
      sc[M] = b;
    }
  } else {
    copy_in<float, kThreads>(reinterpret_cast<float*>(smem),
                             static_cast<const float*>(lut) + (size_t)t * mcb,
                             mcb);
  }
  __syncthreads();
}

// Views of a staged table: the f32 entries, the u8 entries, the scales
// (sc[0..M-1]) with the bias sum at sc[M].
struct Table {
  const float* lut_f;
  const uint8_t* lut_q;
  const float* sc;
};

__device__ __forceinline__ Table table_view(const unsigned char* smem, int M,
                                            int CB) {
  const int mcb = M * CB;
  return {reinterpret_cast<const float*>(smem), smem,
          reinterpret_cast<const float*>(smem + ((mcb + 15) & ~15))};
}

}  // namespace pqrow
