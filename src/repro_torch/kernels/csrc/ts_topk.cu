// TS by slot on Hopper: each query's top-k over its probed clusters' real
// rows, read where DC wrote them.
//
// Replaces no Pallas kernel.  The reference's TS is `jax.lax.top_k`
// (`topk_smallest`, src/repro/core/topk.py:19) over every candidate of a
// query, then the gathered ids; `torch.topk` over the (Qc, P * C) padded
// distances, then the winners' ids by (probe, row), is the port's plain
// version.  This kernel computes the same selection from what DC by slot
// leaves (pq_scan.cu):
//
//     for query q and probe j (task t = q * P + j): s = slots[t], rows
//     r < sizes[s] (a slot outside [0, nslots) has size 0)
//     out[q]  = the k smallest (dists[t, r], j * C + r) of those rows,
//               ascending, as (distance, ids[s, r]); past the query's real
//               rows (+inf, -1).
//
// The selection is warp_topk.cuh's, with the flat position j * C + r as a
// key's position: ties go to the lower position, and the output is a
// function of the inputs alone.  The distances out are the f32 values DC
// wrote; nothing is recomputed.  No row at or past its task's size is read
// (pq_row.cuh slot_rows), so C's padded output may hold anything.
//
// What bounds it on an H100: bytes.  It reads the real rows' distances
// once (4 B a row), each task's slot and size, and the winners' ids, and
// writes Qc * k * 8 bytes.  At the benchmark's chunk (256 queries x 96
// probes, C = 6,200, a quarter of the rows real) that is ~150 MB, 0.045 ms
// at 3.35 TB/s; torch.topk read all 609 MB with a radix select over them.
// The design:
//
//   * stage 1, ts_topk_select_kernel: a warp per (query, group) works
//     alone (no block barrier).  The groups per query come from the card:
//     as many warps as fit on it at once over Qc queries, capped at
//     kMaxMergeKeys / k_pad and at P (two or four waves' worth were
//     slower on the H100).  A query's real rows, in task order, are split
//     evenly between its groups by the prefix sums of its tasks' sizes (a
//     warp scans 32 sizes at a time with shuffles), so every warp reads
//     about the same bytes whatever the sizes, and the grid is one wave;
//   * a warp reads its rows with 16-byte loads (kUnroll a lane in flight)
//     where the row's address allows, scalar loads at the ragged edges;
//   * each warp keeps a running top list (warp_topk.cuh) and its k_pad-th
//     key on every lane.  A round of rows costs one compare against that
//     key's distance and one vote; only a round with a candidate builds
//     keys and updates the list: up to kInsertMax kept keys one at a time,
//     each followed by a new vote against the new k_pad-th key, else all
//     32 merged in at once;
//   * a warp writes its k_pad keys to the scratch the wrapper allocated;
//   * stage 2, ts_topk_merge_kernel: a warp per query folds its groups'
//     keys into one list the same way and writes the first k, looking each
//     winner's id up by (slot of its probe, row).
//
// k_pad = k_pad_of(k) is at most kMaxKPad.  The kernels allocate nothing
// and never synchronise with the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "occupancy.cuh"
#include "pq_row.cuh"
#include "warp_topk.cuh"

namespace {

using namespace wtopk;

constexpr int kWarps = 4;                 // stage 1 and 2: warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;                // 16-byte loads a lane in flight
constexpr int kMaxMergeKeys = 2048;       // stage 2's keys a query, at most
// Kept keys in a round up to which they are inserted one at a time; more
// are merged in at once.
constexpr int kInsertMax = 16;

// The warp's running list: the L smallest keys offered so far, sorted in
// the order i = j*32 + lane, and its k_pad-th key (thr) on every lane.
template <int KPL>
struct TopList {
  u64 v[KPL];
  u64 thr;
  float thr_d;   // thr's distance: a row above it is never a candidate

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KPL; ++j) v[j] = kNone;
    thr = kNone;
    thr_d = INFINITY;
  }

  __device__ __forceinline__ void refresh(int kp) {
    thr = kth<KPL>(v, kp);
    thr_d = key_dist(thr);
  }

  // Every lane offers one key (kNone: nothing); the whole warp calls it.
  __device__ __forceinline__ void offer(u64 key, int kp, int lane) {
    unsigned kept = __ballot_sync(kAll, key < thr);
    if (kept == 0) return;
    if (__popc(kept) > kInsertMax) {
      merge32<KPL>(v, key < thr ? key : kNone, lane);
      refresh(kp);
      return;
    }
    do {
      const int src = __ffs(kept) - 1;
      insert1<KPL>(v, __shfl_sync(kAll, key, src), lane);
      refresh(kp);
      // the lanes after src whose key is still below the new thr
      kept = __ballot_sync(kAll, key < thr) & ~((2u << src) - 1u);
    } while (kept);
  }

  // V rows a lane (ok: the row exists); one compare a row unless a lane
  // holds a candidate.
  template <int V>
  __device__ __forceinline__ void offer_rows(const float (&d)[V],
                                             const uint32_t (&pos)[V],
                                             const bool (&ok)[V], int kp,
                                             int lane) {
    bool hit = false;
#pragma unroll
    for (int u = 0; u < V; ++u) hit |= ok[u] && d[u] <= thr_d;
    if (!__any_sync(kAll, hit)) return;
#pragma unroll
    for (int u = 0; u < V; ++u)
      offer(ok[u] && d[u] <= thr_d ? make_key(d[u], pos[u], u64()) : kNone,
            kp, lane);
  }
};

// Sum and inclusive prefix sum of one value a lane.
__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
  return x;
}

__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Offer rows [a, e) of one task (row r at base[r], position pos0 + r).
template <int KPL>
__device__ __forceinline__ void scan_task(TopList<KPL>& list,
                                          const float* __restrict__ base,
                                          uint32_t pos0, int a, int e,
                                          int kp, int lane) {
  // scalar rows up to the first 16-byte boundary
  const int head = min(
      e - a, (int)(((16u - ((uintptr_t)(base + a) & 15u)) & 15u) >> 2));
  if (head > 0) {
    const int r = a + lane;
    const bool ok[1] = {lane < head};
    const float d[1] = {ok[0] ? __ldg(base + r) : 0.0f};
    const uint32_t pos[1] = {pos0 + (uint32_t)r};
    list.offer_rows(d, pos, ok, kp, lane);
  }
  a += head;
  const int n4 = (e - a) >> 2;
  const float4* b4 = reinterpret_cast<const float4*>(base + a);
  for (int i0 = 0; i0 < n4; i0 += 32 * kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32 + lane;
      x[u] = i < n4 ? __ldg(b4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float d[4 * kUnroll];
    uint32_t pos[4 * kUnroll];
    bool ok[4 * kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32 + lane;
      const uint32_t p = pos0 + (uint32_t)(a + 4 * i);
      d[4 * u] = x[u].x, d[4 * u + 1] = x[u].y;
      d[4 * u + 2] = x[u].z, d[4 * u + 3] = x[u].w;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pos[4 * u + c] = p + c;
        ok[4 * u + c] = i < n4;
      }
    }
    list.offer_rows(d, pos, ok, kp, lane);
  }
  // the scalar tail (at most 3 rows)
  a += 4 * n4;
  if (a < e) {
    const int r = a + lane;
    const bool ok[1] = {r < e};
    const float d[1] = {ok[0] ? __ldg(base + r) : 0.0f};
    const uint32_t pos[1] = {pos0 + (uint32_t)r};
    list.offer_rows(d, pos, ok, kp, lane);
  }
}

// Stage 1: warp w takes query w / G and its group w % G, the rows
// [total * g / G, total * (g + 1) / G) of the query's real rows in task
// order, and writes its list's first k_pad keys to part[w].
template <int KPL>
__global__ void __launch_bounds__(kThreads)
    ts_topk_select_kernel(const float* __restrict__ dists,
                          const int* __restrict__ slots,
                          const int* __restrict__ sizes,
                          u64* __restrict__ part, int qc, int P, int C,
                          int nslots, int G, int kp) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= qc * G) return;                 // the whole warp (G <= P)
  const int q = w / G, g = w % G;
  const int* qslots = slots + (size_t)q * P;

  int total = 0;
  for (int j0 = 0; j0 < P; j0 += 32) {
    const int j = j0 + lane;
    total +=
        warp_sum(j < P ? pqrow::slot_rows(sizes, qslots[j], nslots, C) : 0);
  }
  // floor(total * g / G) in 32 bits: total = a * G + b
  const int a = total / G, b = total % G;
  const int r0 = a * g + b * g / G, r1 = a * (g + 1) + b * (g + 1) / G;

  TopList<KPL> list;
  list.init();
  int carry = 0;                           // real rows of the tasks before
  for (int j0 = 0; j0 < P && carry < r1; j0 += 32) {
    const int j = j0 + lane;
    const int n = j < P ? pqrow::slot_rows(sizes, qslots[j], nslots, C) : 0;
    const int incl = warp_scan(n, lane);
    const int lo = carry + incl - n;       // task j's rows: [lo, lo + n)
    unsigned mine = __ballot_sync(kAll, n > 0 && lo < r1 && lo + n > r0);
    while (mine) {
      const int src = __ffs(mine) - 1;
      mine &= mine - 1;
      const int jt = j0 + src;
      const int lo_t = __shfl_sync(kAll, lo, src);
      const int n_t = __shfl_sync(kAll, n, src);
      scan_task(list, dists + ((size_t)q * P + jt) * C, (uint32_t)jt * C,
                max(r0 - lo_t, 0), min(r1 - lo_t, n_t), kp, lane);
    }
    carry += __shfl_sync(kAll, incl, 31);
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int i = j * 32 + lane;
    if (i < kp) part[(size_t)w * kp + i] = list.v[j];
  }
}

// Stage 2: warp q folds the G * k_pad keys of its query's groups into one
// list and writes the first k as (distance, id).
template <int KPL>
__global__ void __launch_bounds__(kThreads)
    ts_topk_merge_kernel(const u64* __restrict__ part,
                         const int* __restrict__ slots,
                         const int* __restrict__ ids,
                         float* __restrict__ out_d, int* __restrict__ out_i,
                         int qc, int P, int C, int G, int kp, int k) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= qc) return;                     // the whole warp
  const u64* keys = part + (size_t)q * G * kp;
  const int n = G * kp;
  TopList<KPL> list;
  list.init();
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    list.offer(i < n ? keys[i] : kNone, kp, lane);
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int i = j * 32 + lane;
    if (i < k) {
      const u64 key = list.v[j];
      const uint32_t pos = (uint32_t)key;
      const bool none = key == kNone;
      const int probe = none ? 0 : (int)(pos / (uint32_t)C);
      const int row = none ? 0 : (int)(pos % (uint32_t)C);
      out_d[(size_t)q * k + i] = none ? INFINITY : key_dist(key);
      out_i[(size_t)q * k + i] =
          none ? -1 : ids[(size_t)slots[(size_t)q * P + probe] * C + row];
    }
  }
}

// Groups a query may be split into, whatever the card.
int max_groups(int P, int kp) {
  return max(1, min(P, kMaxMergeKeys / kp));
}

template <int KPL>
int launch_typed(const float* dists, const int* slots, const int* sizes,
                 const int* ids, u64* part, float* out_d, int* out_i, int qc,
                 int P, int C, int nslots, int k, int kp,
                 cudaStream_t stream) {
  // Stage 1's warps that fit on the card at once.
  static occupancy::Resident resident;
  int blocks = 0;
  cudaError_t e = occupancy::resident_blocks(
      resident, ts_topk_select_kernel<KPL>, kThreads, 0, &blocks);
  if (e != cudaSuccess) return (int)e;
  const int warps = blocks * kWarps;
  const int G = max(1, min(max_groups(P, kp), warps / qc));
  const int blocks1 = (int)(((long long)qc * G + kWarps - 1) / kWarps);
  ts_topk_select_kernel<KPL><<<blocks1, kThreads, 0, stream>>>(
      dists, slots, sizes, part, qc, P, C, nslots, G, kp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ts_topk_merge_kernel<KPL><<<(qc + kWarps - 1) / kWarps, kThreads, 0,
                              stream>>>(part, slots, ids, out_d, out_i, qc,
                                        P, C, G, kp, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch ts_topk_f32 needs for Qc queries of P probes at k.
size_t ts_topk_scratch_bytes(int qc, int P, int k) {
  if (qc < 0 || P < 1 || k < 1 || k > kMaxKPad) return 0;
  const int kp = k_pad_of(k);
  return (size_t)qc * max_groups(P, kp) * kp * sizeof(u64);
}

// dists (qc * P, C) f32 as DC by slot writes it (task t = query t / P,
// probe t % P), slots (qc * P,) i32, sizes (nslots,) i32, ids (nslots, C)
// i32, scratch of ts_topk_scratch_bytes(qc, P, k) bytes -> out_d (qc, k)
// f32 ascending, out_i (qc, k) i32.  1 <= k <= 256, P * C < 2^31.
// Returns cudaGetLastError() after the two launches.
int ts_topk_f32(const void* dists, const void* slots, const void* sizes,
                const void* ids, void* scratch, void* out_d, void* out_i,
                int qc, int P, int C, int nslots, int k, void* stream) {
  if (qc < 0 || P < 1 || C < 1 || nslots < 0 || k < 1 || k > kMaxKPad ||
      (long long)P * C >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (qc == 0) return (int)cudaSuccess;
  const int kp = k_pad_of(k);
  const float* d = (const float*)dists;
  const int *sl = (const int*)slots, *sz = (const int*)sizes;
  const int* id = (const int*)ids;
  u64* part = (u64*)scratch;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  switch (keys_per_lane(kp)) {
    case 1:
      return launch_typed<1>(d, sl, sz, id, part, od, oi, qc, P, C, nslots,
                             k, kp, s);
    case 2:
      return launch_typed<2>(d, sl, sz, id, part, od, oi, qc, P, C, nslots,
                             k, kp, s);
    case 4:
      return launch_typed<4>(d, sl, sz, id, part, od, oi, qc, P, C, nslots,
                             k, kp, s);
    default:
      return launch_typed<8>(d, sl, sz, id, part, od, oi, qc, P, C, nslots,
                             k, kp, s);
  }
}

const char* ts_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
