// LC phase on Hopper: batched ADC lookup-table construction.
//
// Replaces the Pallas TPU kernels `lut_build_pallas` and
// `lut_build_q_pallas` (src/repro/kernels/lut_build.py).  For every task t
// (a (query, probe) pair) and subspace m:
//
//     lut[t, m, cb] = max(||r_tm||^2 + ||C_m,cb||^2 - 2 r_tm . C_m,cb, 0)
//
// and, for the quantized variant, per (t, m) row:
//
//     lo = min_cb lut, hi = max_cb lut
//     scale = hi > lo ? (hi - lo) / 255 : 1,  bias = lo
//     q = clamp(rint((lut - lo) / scale), 0, 255)   (round half to even)
//
// What bounds it on an H100: bytes.  At T=8192, M=16, CB=256, dsub=8 the
// f32 table written is 134 MB against ~0.64 GFLOP of FMAs, so the store
// stream sets the time (~41 us at 3.35 TB/s); the u8 variant writes 4x
// less.  The design keeps everything except that store on chip:
//
//   * grid (ceil(T / 32), M): one block per 32 tasks of one subspace, so
//     the block stages the subspace's codebook slice (CB x dsub f32, 8 KB
//     at dsub=8, transposed to (dsub, CB) so lanes reading consecutive cb
//     hit consecutive banks), its squared norms and the 32 residual rows
//     in shared memory once;
//   * one warp per (t, m) row; lane j computes entries cb = j, j+32, ...
//     with IEEE f32 FMAs (never TF32: the rtol 1e-4 bar needs full f32),
//     so each warp store is 32 consecutive floats (coalesced along CB);
//   * the quantized variant parks the f32 row in a per-warp shared
//     buffer, reduces min/max with warp shuffles and writes only u8 plus
//     two floats per row: the f32 table never reaches device memory.
//
// Both variants compute the f32 entry with one __device__ function, so
// the u8 table equals the host quantization of the f32 kernel's output.
// Build without --use_fast_math: the quantize step relies on IEEE division
// and rintf.  The kernels allocate nothing and never synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTasksPerBlock = 32;

__device__ __forceinline__ float lut_entry(const float* r, float rsq,
                                           const float* cbT,
                                           const float* sqn, int cb, int CB,
                                           int dsub) {
  float cross = 0.0f;
  for (int d = 0; d < dsub; ++d) cross = fmaf(r[d], cbT[d * CB + cb], cross);
  return fmaxf(rsq + sqn[cb] - 2.0f * cross, 0.0f);
}

template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
    lut_build_kernel(const float* __restrict__ res,
                     const float* __restrict__ books,
                     const float* __restrict__ sqnorms,
                     float* __restrict__ out, uint8_t* __restrict__ out_q,
                     float* __restrict__ out_scale,
                     float* __restrict__ out_bias, int T, int M, int CB,
                     int dsub) {
  extern __shared__ float smem[];
  float* cbT = smem;                          // (dsub, CB)
  float* sqn = cbT + dsub * CB;               // (CB,)
  float* rtile = sqn + CB;                    // (kTasksPerBlock, dsub)
  float* rowbuf = rtile + kTasksPerBlock * dsub;  // (kWarps, CB), u8 only

  const int m = blockIdx.y;
  const int t0 = blockIdx.x * kTasksPerBlock;
  const int nt = min(kTasksPerBlock, T - t0);
  const float* book = books + (size_t)m * CB * dsub;
  for (int i = threadIdx.x; i < CB * dsub; i += kThreads)
    cbT[(i % dsub) * CB + i / dsub] = book[i];
  for (int i = threadIdx.x; i < CB; i += kThreads)
    sqn[i] = sqnorms[(size_t)m * CB + i];
  for (int i = threadIdx.x; i < nt * dsub; i += kThreads)
    rtile[i] = res[((size_t)(t0 + i / dsub) * M + m) * dsub + i % dsub];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int tl = warp; tl < nt; tl += kWarps) {
    const float* r = rtile + tl * dsub;
    float rsq = 0.0f;
    for (int d = 0; d < dsub; ++d) rsq = fmaf(r[d], r[d], rsq);
    const size_t row = (size_t)(t0 + tl) * M + m;   // (t, m) row
    if (!kQuant) {
      float* o = out + row * CB;
      for (int cb = lane; cb < CB; cb += 32)
        o[cb] = lut_entry(r, rsq, cbT, sqn, cb, CB, dsub);
    } else {
      // each lane reads back only the entries it wrote: no barrier needed
      float* buf = rowbuf + warp * CB;
      float lo = INFINITY, hi = -INFINITY;
      for (int cb = lane; cb < CB; cb += 32) {
        const float v = lut_entry(r, rsq, cbT, sqn, cb, CB, dsub);
        buf[cb] = v;
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      const float scale = hi > lo ? (hi - lo) / 255.0f : 1.0f;
      uint8_t* q = out_q + row * CB;
      for (int cb = lane; cb < CB; cb += 32) {
        const float v = rintf((buf[cb] - lo) / scale);
        q[cb] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
      }
      if (lane == 0) {
        out_scale[row] = scale;
        out_bias[row] = lo;
      }
    }
  }
}

size_t smem_bytes(bool quant, int CB, int dsub) {
  size_t floats = (size_t)dsub * CB + CB + (size_t)kTasksPerBlock * dsub;
  if (quant) floats += (size_t)kWarps * CB;
  return floats * sizeof(float);
}

template <bool kQuant>
int launch(const void* res, const void* books, const void* sqnorms,
           void* out, void* out_q, void* out_scale, void* out_bias, int T,
           int M, int CB, int dsub, void* stream) {
  if (T == 0 || M == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(kQuant, CB, dsub);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lut_build_kernel<kQuant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T + kTasksPerBlock - 1) / kTasksPerBlock, M);
  lut_build_kernel<kQuant><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)res, (const float*)books, (const float*)sqnorms,
      (float*)out, (uint8_t*)out_q, (float*)out_scale, (float*)out_bias, T,
      M, CB, dsub);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, so the caller can refuse a shape that
// does not fit the card before launching.
size_t lut_build_smem_bytes(int quant, int CB, int dsub) {
  return smem_bytes(quant != 0, CB, dsub);
}

// res (T, M, dsub) f32, books (M, CB, dsub) f32, sqnorms (M, CB) f32
// -> out (T, M, CB) f32.  Returns cudaGetLastError().
int lut_build_f32(const void* res, const void* books, const void* sqnorms,
                  void* out, int T, int M, int CB, int dsub, void* stream) {
  return launch<false>(res, books, sqnorms, out, nullptr, nullptr, nullptr,
                       T, M, CB, dsub, stream);
}

// Same inputs -> out_q (T, M, CB) u8, scale (T, M) f32, bias (T, M) f32.
int lut_build_u8(const void* res, const void* books, const void* sqnorms,
                 void* out_q, void* scale, void* bias, int T, int M, int CB,
                 int dsub, void* stream) {
  return launch<true>(res, books, sqnorms, nullptr, out_q, scale, bias, T, M,
                      CB, dsub, stream);
}

const char* lut_build_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
