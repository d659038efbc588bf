// LC phase on Hopper: batched ADC lookup-table construction.
//
// Replaces the Pallas TPU kernels `lut_build_pallas` and
// `lut_build_q_pallas` (src/repro/kernels/lut_build.py).  For every task t
// (a (query, probe) pair) and subspace m:
//
//     lut[t, m, cb] = max(||r_tm||^2 + ||C_m,cb||^2 - 2 r_tm . C_m,cb, 0)
//
// with ||r||^2 and r . C each an fmaf chain over d = 0..dsub-1 from 0, in
// IEEE f32 (no TF32, no fast-math), and, for the quantized variant, per
// (t, m) row:
//
//     lo = min_cb lut, hi = max_cb lut
//     scale = hi > lo ? (hi - lo) / 255 : 1,  bias = lo
//     q = clamp(rint((lut - lo) / scale), 0, 255)   (round half to even)
//
// with IEEE divisions (never a multiply by a reciprocal).  A third variant
// writes the table in bf16, the reference's `lut.astype(bfloat16)` under
// `_shard_tasks_fn(lut_dtype=bf16)` (src/repro/core/sharded_search.py):
//
//     lut_h[t, m, cb] = bf16_rn(lut[t, m, cb])    (round to nearest even)
//
// All variants compute the f32 entry with one __device__ function
// (`entry`), so the u8 table equals the host quantization of the f32
// kernel's output, the bf16 table the f32 table cast to bf16, and every
// instance below gives the same bits as every other.
//
// What bounds it on an H100: bytes for the f32 table, operations for the
// u8 one.  At the sharded step (T=65,536, M=16, CB=256, dsub=8) A writes
// 1.07 GB (~0.33 ms at 3.35 TB/s) against ~5.4 G operations (~0.08 ms at
// 67 TFLOP/s, an FMA counting two); B writes a quarter of that and adds an
// IEEE division per entry; the bf16 variant writes half of A's bytes.
// Everything but the tables stays on chip, and an entry costs dsub FMAs
// out of registers and shared memory:
//
//   * dsub is a template parameter (1, 2, 4, 8, 16), so the d-loops
//     unroll and a task's residual subvector and ||r||^2 live in
//     registers.  Any other dsub, a CB that is not a multiple of 4 or above
//     32 * 4 * kGroups, or an output pointer the vector stores cannot take
//     runs the generic instance (DSUB = 0: runtime dsub, the residual read
//     from global memory inside the d-loop, scalar stores, and B computing
//     each entry twice, for min/max and then to quantize, instead of
//     holding the row);
//   * the grid is persistent: as many blocks as fit on the card, split
//     evenly over the M subspaces (blockIdx.y = m; fewer blocks when T is
//     small), so each block loads its subspace's codebook slice once and a
//     warp then walks T / (warps on m) tasks t0, t0 + stride, ...;
//   * a warp computes kRowsF32 (A and bf16) or kRowsU8 (B) (t, m) rows at
//     once, each codebook read serving all of them; lane j owns the quads of
//     4 consecutive entries q = j and j + 32, i.e. cb 4j..4j+3 and
//     128+4j..128+4j+3 at CB = 256 (quads past CB masked out of
//     everything).  Below dsub kStageDsub a lane holds its 8 codebook
//     entries and their norms in registers (8 x dsub floats).  From dsub 8
//     on the slice is staged once per block in shared memory as float4
//     quads laid out [d][quad], so lane j's float4 read of quad j + 32g is
//     a 512-B contiguous warp access, free of bank conflicts: at dsub 8 the
//     64 registers a lane would hold cost more warps per SM than the
//     shared-memory reads do (PERF.md lists what was measured);
//   * a warp's residuals come in 32 tasks at a time, one row a lane, by
//     cp.async into two per-warp tile buffers, the next 32 landing while
//     this 32 is computed; every lane then reads a row as one broadcast;
//   * stores are vectors: A writes a lane's quad as one float4 (512 B a
//     warp instruction, a 1 KB row in two) with __stcs (evict-first: the
//     table streams past L2), the bf16 variant as 4 bf16 in one uint2 the
//     same way; B packs a quad's 4 u8 into one uint32 (a 256-B row in two
//     instructions) after the row's min and max come from
//     registers by __shfl_xor_sync (no shared row buffer, no barrier).
//     Lanes 0 and 1 write scale and bias in one instruction: a warp owns
//     one subspace, so its rows are M floats apart in those two arrays and
//     their 8 B a row cannot coalesce across rows.
//
// The launcher picks the instance from dsub, CB and the pointers'
// alignment; it never reads the data to decide.  Offsets are size_t (the
// table passes 2^31 bytes at T = 65,536).  Build without --use_fast_math.
// The kernels allocate nothing and never synchronise with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "occupancy.cuh"

namespace {

// The table a launch writes (the template parameter kOut): f32 (A), u8
// with scale and bias (B), bf16.
constexpr int kOutF32 = 0;
constexpr int kOutU8 = 1;
constexpr int kOutBF16 = 2;

constexpr int kThreads = 128;        // 4 warps a block
// blocks an SM must hold (__launch_bounds__): with only the block size
// given, ptxas capped some instances' registers at an occupancy step and
// spilled; with this it allocates what each instance needs
constexpr int kMinBlocks = 1;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;           // quads a lane owns in a row (CB <= 256)
constexpr int kMaxCB = 32 * 4 * kGroups;
constexpr int kStreamStores = 1;     // A's stores evict-first (__stcs)
constexpr int kRowsF32 = 4;          // rows a warp computes at once: A
constexpr int kRowsU8 = 2;           // and B (the bf16 table: kRowsF32)
constexpr int kStageDsub = 8;        // least dsub whose slice is staged

// The one f32 entry every variant computes.  nvcc may contract it into
// fma(-2, cross, rsq + sqn), which rounds the same (2 * cross is exact), so
// its bits do not depend on the contraction.
__device__ __forceinline__ float entry(float rsq, float sqn, float cross) {
  return fmaxf(rsq + sqn - 2.0f * cross, 0.0f);
}

__device__ __forceinline__ float4 entries(float rsq, float4 sqn, float c0,
                                          float c1, float c2, float c3) {
  return make_float4(entry(rsq, sqn.x, c0), entry(rsq, sqn.y, c1),
                     entry(rsq, sqn.z, c2), entry(rsq, sqn.w, c3));
}

// clamp(rint((v - lo) / scale), 0, 255): the conversion rounds half to
// even and saturates (negatives and NaN to 0), as rintf then the clamp do
__device__ __forceinline__ uint32_t quantize(float v, float lo, float scale) {
  return min(__float2uint_rn((v - lo) / scale), 255u);
}

__device__ __forceinline__ uint32_t pack(float4 v, float lo, float scale) {
  return quantize(v.x, lo, scale) | quantize(v.y, lo, scale) << 8 |
         quantize(v.z, lo, scale) << 16 | quantize(v.w, lo, scale) << 24;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  if (kStreamStores)
    __stcs(reinterpret_cast<float4*>(p), v);
  else
    *reinterpret_cast<float4*>(p) = v;
}

// A quad of entries rounded to bf16 (nearest even), one 8-byte store.
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  const uint2 w = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                             *reinterpret_cast<const uint32_t*>(&hi));
  if (kStreamStores)
    __stcs(reinterpret_cast<uint2*>(p), w);
  else
    *reinterpret_cast<uint2*>(p) = w;
}

// Asynchronous copies from device memory into shared memory (cp.async),
// committed and awaited by group.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A task's residual subvector (DSUB floats) into shared memory; `vec`: the
// row is aligned for 16-byte (DSUB % 4 == 0) or 8-byte (DSUB == 2) copies.
template <int DSUB>
__device__ __forceinline__ void stage_res(float* dst, const float* src,
                                          bool vec) {
  if constexpr (DSUB % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int d = 0; d < DSUB; d += 4) cp_async<16>(dst + d, src + d);
      return;
    }
  } else if constexpr (DSUB == 2) {
    if (vec) {
      cp_async<8>(dst, src);
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < DSUB; ++d) cp_async<4>(dst + d, src + d);
}

// A staged residual (16-byte aligned for DSUB % 4 == 0) into registers; all
// lanes read the same row, so each load is one broadcast.
template <int DSUB>
__device__ __forceinline__ void read_res(const float* p, float (&r)[DSUB]) {
  if constexpr (DSUB % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DSUB; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + d);
      r[d] = x.x, r[d + 1] = x.y, r[d + 2] = x.z, r[d + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DSUB; ++d) r[d] = p[d];
  }
}

// DSUB > 0: dsub at compile time; DSUB == 0: the generic instance (runtime
// dsub and CB, scalar stores).  kSmemBook: the codebook slice in shared
// memory ([d][quad] float4, then the quads' norms) instead of registers.
// kOut: the table written; a bf16 table goes to `out` as bf16 entries.
template <int DSUB, bool kSmemBook, int kOut>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    lut_build_kernel(const float* __restrict__ res,
                     const float* __restrict__ books,
                     const float* __restrict__ sqnorms,
                     float* __restrict__ out, uint8_t* __restrict__ out_q,
                     float* __restrict__ out_scale,
                     float* __restrict__ out_bias, int T, int M, int CB,
                     int dsub_rt, int res_vec) {
  constexpr bool kGeneric = DSUB == 0;
  constexpr bool kQuant = kOut == kOutU8;
  // the f32 or bf16 table (`out` holds bf16 entries for kOutBF16)
  using OutT = std::conditional_t<kOut == kOutBF16, __nv_bfloat16, float>;
  OutT* const table = reinterpret_cast<OutT*>(out);
  constexpr int kRD = kGeneric ? 1 : DSUB;          // residual registers
  constexpr int kBD = kSmemBook ? 1 : DSUB;         // codebook registers
  static_assert(kSmemBook || !kGeneric, "the generic instance stages");
  const int dsub = kGeneric ? dsub_rt : DSUB;
  const int m = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int cbq = (CB + 3) >> 2;                    // quads in a row
  const float* book = books + (size_t)m * CB * dsub;
  const float* sqn = sqnorms + (size_t)m * CB;

  extern __shared__ float4 smem4[];
  const float4* book4 = smem4;                      // (dsub, cbq)
  const float4* norm4 = smem4 + (size_t)dsub * cbq; // (cbq,)
  float bk[kGroups][4][kBD];
  float4 nq[kGroups];
  if constexpr (kSmemBook) {
    float* s = reinterpret_cast<float*>(smem4);
    const int w = cbq * 4;
    for (int i = threadIdx.x; i < dsub * w; i += kThreads) {
      const int d = i / w, cb = i - d * w;
      s[i] = cb < CB ? __ldg(book + (size_t)cb * dsub + d) : 0.0f;
    }
    for (int i = threadIdx.x; i < w; i += kThreads)
      s[(size_t)dsub * w + i] = i < CB ? __ldg(sqn + i) : 0.0f;
    __syncthreads();
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float n[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cb = 4 * (lane + 32 * g) + i;
        const bool ok = cb < CB;
        n[i] = ok ? __ldg(sqn + cb) : 0.0f;
#pragma unroll
        for (int d = 0; d < kBD; ++d)
          bk[g][i][d] = ok ? __ldg(book + (size_t)cb * DSUB + d) : 0.0f;
      }
      nq[g] = make_float4(n[0], n[1], n[2], n[3]);
    }
  }

  // quad q = lane + 32 g of a row of the generic instance: rr its residual
  // (in global memory), rsq its ||r||^2
  auto quad_generic = [&](int q, const float* rr, float rsq) -> float4 {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    for (int d = 0; d < dsub; ++d) {
      const float x = __ldg(rr + d);
      const float4 c = book4[(size_t)d * cbq + q];
      c0 = fmaf(x, c.x, c0);
      c1 = fmaf(x, c.y, c1);
      c2 = fmaf(x, c.z, c2);
      c3 = fmaf(x, c.w, c3);
    }
    return entries(rsq, norm4[q], c0, c1, c2, c3);
  };

  const int stride = gridDim.x * kWarps;            // warps on subspace m
  const int t0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if constexpr (!kGeneric) {
    // The warp's tasks t0, t0 + stride, ... in chunks of 32: a chunk's
    // residuals come in by cp.async, one row a lane, into the warp's two
    // tile buffers, the next chunk landing while this one is computed, kR
    // rows at a time.
    constexpr int kR = kQuant ? kRowsU8 : kRowsF32;
    static_assert(32 % kR == 0, "rows a chunk");
    // quad q = lane + 32 g of kR rows (r their residuals, rsq their
    // ||r||^2) into v: each codebook float4 is read once for all of them
    auto quads = [&](int g, int q, const float (&r)[kR][kRD],
                     const float (&rsq)[kR], float4 (&v)[kR]) {
      float c[kR][4];
#pragma unroll
      for (int k = 0; k < kR; ++k) c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0;
#pragma unroll
      for (int d = 0; d < kRD; ++d) {
        float4 b;
        if constexpr (kSmemBook)
          b = book4[(size_t)d * cbq + q];
        else
          b = make_float4(bk[g][0][d], bk[g][1][d], bk[g][2][d], bk[g][3][d]);
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          c[k][0] = fmaf(r[k][d], b.x, c[k][0]);
          c[k][1] = fmaf(r[k][d], b.y, c[k][1]);
          c[k][2] = fmaf(r[k][d], b.z, c[k][2]);
          c[k][3] = fmaf(r[k][d], b.w, c[k][3]);
        }
      }
      float4 n;
      if constexpr (kSmemBook)
        n = norm4[q];
      else
        n = nq[g];
#pragma unroll
      for (int k = 0; k < kR; ++k)
        v[k] = entries(rsq[k], n, c[k][0], c[k][1], c[k][2], c[k][3]);
    };
    float* tile = reinterpret_cast<float*>(
                      smem4 + (kSmemBook ? (size_t)(dsub + 1) * cbq : 0)) +
                  (threadIdx.x >> 5) * 64 * kRD;
    auto row_of = [&](long long t) { return (size_t)t * M + m; };
    auto stage = [&](int chunk) {
      const long long t = t0 + (long long)(32 * chunk + lane) * stride;
      if (t < T)
        stage_res<kRD>(tile + ((chunk & 1) * 32 + lane) * kRD,
                       res + row_of(t) * kRD, res_vec);
      cp_async_commit();
    };
    stage(0);
    stage(1);
    for (int c = 0;; ++c) {
      const long long base = t0 + (long long)32 * c * stride;
      if (base >= T) break;
      cp_async_wait<1>();                            // chunk c has landed
      __syncwarp();
      const float* tb = tile + (c & 1) * 32 * kRD;
      for (int j = 0; j < 32 && base + (long long)j * stride < T; j += kR) {
        // rows j..j+kR-1 of the chunk; one past T repeats row j (computed,
        // never stored)
        bool ok[kR];
        size_t row[kR];
        float r[kR][kRD], rsq[kR];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const long long t = base + (long long)(j + k) * stride;
          ok[k] = t < T;
          row[k] = row_of(ok[k] ? t : base + (long long)j * stride);
          read_res<kRD>(tb + (ok[k] ? j + k : j) * kRD, r[k]);
          rsq[k] = 0.0f;
#pragma unroll
          for (int d = 0; d < kRD; ++d)
            rsq[k] = fmaf(r[k][d], r[k][d], rsq[k]);
        }
        if constexpr (!kQuant) {
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int q = lane + 32 * g;
            if (q >= cbq) continue;
            float4 v[kR];
            quads(g, q, r, rsq, v);
#pragma unroll
            for (int k = 0; k < kR; ++k)
              if (ok[k]) store4(table + row[k] * CB + 4 * q, v[k]);
          }
        } else {
          float4 v[kGroups][kR];
          float lo[kR], hi[kR];
#pragma unroll
          for (int k = 0; k < kR; ++k) lo[k] = INFINITY, hi[k] = -INFINITY;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int q = lane + 32 * g;
            if (q >= cbq) continue;
            quads(g, q, r, rsq, v[g]);
#pragma unroll
            for (int k = 0; k < kR; ++k) {
              const float4 x = v[g][k];
              lo[k] = fminf(lo[k], fminf(fminf(x.x, x.y), fminf(x.z, x.w)));
              hi[k] = fmaxf(hi[k], fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int k = 0; k < kR; ++k) {
              lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
              hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
            }
          }
#pragma unroll
          for (int k = 0; k < kR; ++k) {
            if (!ok[k]) break;
            const float scale =
                hi[k] > lo[k] ? (hi[k] - lo[k]) / 255.0f : 1.0f;
#pragma unroll
            for (int g = 0; g < kGroups; ++g) {
              const int q = lane + 32 * g;
              if (q < cbq)
                *reinterpret_cast<uint32_t*>(out_q + row[k] * CB + 4 * q) =
                    pack(v[g][k], lo[k], scale);
            }
            if (lane < 2)
              (lane ? out_bias : out_scale)[row[k]] = lane ? lo[k] : scale;
          }
        }
      }
      __syncwarp();                                  // done with buffer c & 1
      stage(c + 2);
    }
  } else {
    // generic: one row at a time, the residual read from global memory
    for (int t = t0; t < T; t += stride) {
      const size_t row = (size_t)t * M + m;
      const float* rr = res + row * dsub;
      float rsq = 0.0f;
      for (int d = 0; d < dsub; ++d) {
        const float x = __ldg(rr + d);
        rsq = fmaf(x, x, rsq);
      }
      if constexpr (kOut == kOutF32) {
        float* o = out + row * CB;
        for (int q = lane; q < cbq; q += 32) {
          const float4 v = quad_generic(q, rr, rsq);
          const int cb = 4 * q;
          o[cb] = v.x;
          if (cb + 1 < CB) o[cb + 1] = v.y;
          if (cb + 2 < CB) o[cb + 2] = v.z;
          if (cb + 3 < CB) o[cb + 3] = v.w;
        }
      } else if constexpr (kOut == kOutBF16) {
        __nv_bfloat16* o = table + row * CB;
        for (int q = lane; q < cbq; q += 32) {
          const float4 v = quad_generic(q, rr, rsq);
          const int cb = 4 * q;
          o[cb] = __float2bfloat16_rn(v.x);
          if (cb + 1 < CB) o[cb + 1] = __float2bfloat16_rn(v.y);
          if (cb + 2 < CB) o[cb + 2] = __float2bfloat16_rn(v.z);
          if (cb + 3 < CB) o[cb + 3] = __float2bfloat16_rn(v.w);
        }
      } else {
        float lo = INFINITY, hi = -INFINITY;
        for (int q = lane; q < cbq; q += 32) {
          const float4 x = quad_generic(q, rr, rsq);
          const int cb = 4 * q;
          lo = fminf(lo, x.x), hi = fmaxf(hi, x.x);
          if (cb + 1 < CB) lo = fminf(lo, x.y), hi = fmaxf(hi, x.y);
          if (cb + 2 < CB) lo = fminf(lo, x.z), hi = fmaxf(hi, x.z);
          if (cb + 3 < CB) lo = fminf(lo, x.w), hi = fmaxf(hi, x.w);
        }
        for (int off = 16; off > 0; off >>= 1) {
          lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
          hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        const float scale = hi > lo ? (hi - lo) / 255.0f : 1.0f;
        uint8_t* o = out_q + row * CB;
        // the entries again, computed as in the first pass
        for (int q = lane; q < cbq; q += 32) {
          const float4 x = quad_generic(q, rr, rsq);
          const int cb = 4 * q;
          o[cb] = (uint8_t)quantize(x.x, lo, scale);
          if (cb + 1 < CB) o[cb + 1] = (uint8_t)quantize(x.y, lo, scale);
          if (cb + 2 < CB) o[cb + 2] = (uint8_t)quantize(x.z, lo, scale);
          if (cb + 3 < CB) o[cb + 3] = (uint8_t)quantize(x.w, lo, scale);
        }
        if (lane < 2) (lane ? out_bias : out_scale)[row] = lane ? lo : scale;
      }
    }
  }
}

// Shared memory of a block: the staged codebook slice and norms, and the
// compiled instances' residual tiles (two of 32 rows a warp).
size_t book_bytes(int CB, int dsub) {
  const size_t cbq = ((size_t)CB + 3) / 4;
  return ((size_t)dsub + 1) * cbq * sizeof(float4);
}

size_t tile_bytes(int dsub) {
  return (size_t)kWarps * 64 * dsub * sizeof(float);
}

template <int DSUB, bool kSmemBook, int kOut>
int launch_instance(const void* res, const void* books, const void* sqnorms,
                    void* out, void* out_q, void* out_scale, void* out_bias,
                    int T, int M, int CB, int dsub, bool res_vec,
                    void* stream) {
  auto kernel = lut_build_kernel<DSUB, kSmemBook, kOut>;
  const size_t smem = (kSmemBook ? book_bytes(CB, dsub) : 0) +
                      (DSUB ? tile_bytes(DSUB) : 0);
  static occupancy::Resident resident;
  int blocks = 0;
  const cudaError_t e =
      occupancy::resident_blocks(resident, kernel, kThreads, smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  // the resident blocks split over the M subspaces; no more than the tasks
  // need (kWarps tasks a block)
  int per_m = blocks / M;
  if (per_m < 1) per_m = 1;
  const int need = (T + kWarps - 1) / kWarps;
  dim3 grid(need < per_m ? need : per_m, M);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)res, (const float*)books, (const float*)sqnorms,
      (float*)out, (uint8_t*)out_q, (float*)out_scale, (float*)out_bias, T,
      M, CB, dsub, (int)res_vec);
  return (int)cudaGetLastError();
}

// dsub and CB that a compiled instance takes (an output pointer it cannot
// store to sends the launch to the generic instance as well)
bool compiled_shape(int CB, int dsub) {
  return CB % 4 == 0 && CB <= kMaxCB &&
         (dsub == 1 || dsub == 2 || dsub == 4 || dsub == 8 || dsub == 16);
}

template <int kOut>
int launch(const void* res, const void* books, const void* sqnorms,
           void* out, void* out_q, void* out_scale, void* out_bias, int T,
           int M, int CB, int dsub, void* stream) {
  if (T < 0 || M < 0 || CB < 1 || dsub < 1 || M > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || M == 0) return (int)cudaSuccess;
  const uintptr_t o = (uintptr_t)(kOut == kOutU8 ? out_q : out);
  const uintptr_t rp = (uintptr_t)res;
  // the vector stores: 4 u8, 4 bf16 or 4 f32 a quad
  const int align = kOut == kOutU8 ? 4 : kOut == kOutBF16 ? 8 : 16;
  const bool whole = compiled_shape(CB, dsub) && o % align == 0;
  // the instance for dsub kD (0: generic); vec: the residuals are aligned
  // for 16-byte (8-byte at dsub 2) copies
  auto go = [&](auto d, bool vec) {
    constexpr int kD = decltype(d)::value;
    return launch_instance<kD, kD == 0 || kD >= kStageDsub, kOut>(
        res, books, sqnorms, out, out_q, out_scale, out_bias, T, M, CB, dsub,
        vec, stream);
  };
  using std::integral_constant;
  switch (whole ? dsub : 0) {
    case 1: return go(integral_constant<int, 1>(), false);
    case 2: return go(integral_constant<int, 2>(), rp % 8 == 0);
    case 4: return go(integral_constant<int, 4>(), rp % 16 == 0);
    case 8: return go(integral_constant<int, 8>(), rp % 16 == 0);
    case 16: return go(integral_constant<int, 16>(), rp % 16 == 0);
    default: return go(integral_constant<int, 0>(), false);
  }
}

}  // namespace

extern "C" {

// Shared memory one block may need (a staged codebook slice and norms,
// residual tiles), so the caller can refuse a shape that does not fit the
// card before launching.  The same for every table kind (0 f32, 1 u8, 2
// bf16).
size_t lut_build_smem_bytes(int kind, int CB, int dsub) {
  (void)kind;
  const size_t generic = book_bytes(CB, dsub);
  if (!compiled_shape(CB, dsub)) return generic;
  const size_t compiled =
      (dsub >= kStageDsub ? generic : 0) + tile_bytes(dsub);
  return compiled > generic ? compiled : generic;
}

// res (T, M, dsub) f32, books (M, CB, dsub) f32, sqnorms (M, CB) f32
// -> out (T, M, CB) f32.  Returns cudaGetLastError().
int lut_build_f32(const void* res, const void* books, const void* sqnorms,
                  void* out, int T, int M, int CB, int dsub, void* stream) {
  return launch<kOutF32>(res, books, sqnorms, out, nullptr, nullptr, nullptr,
                         T, M, CB, dsub, stream);
}

// Same inputs -> out_q (T, M, CB) u8, scale (T, M) f32, bias (T, M) f32.
int lut_build_u8(const void* res, const void* books, const void* sqnorms,
                 void* out_q, void* scale, void* bias, int T, int M, int CB,
                 int dsub, void* stream) {
  return launch<kOutU8>(res, books, sqnorms, nullptr, out_q, scale, bias, T,
                        M, CB, dsub, stream);
}

// Same inputs -> out (T, M, CB) bf16: each entry of lut_build_f32's table
// rounded to bf16 (nearest even).
int lut_build_bf16(const void* res, const void* books, const void* sqnorms,
                   void* out, int T, int M, int CB, int dsub, void* stream) {
  return launch<kOutBF16>(res, books, sqnorms, out, nullptr, nullptr,
                          nullptr, T, M, CB, dsub, stream);
}

const char* lut_build_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
