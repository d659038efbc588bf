// The warp-level top-k selection of the fused DC+TS kernels
// (pq_scan_topk.cu) and of TS by slot (ts_topk.cu): a warp keeps the
// smallest keys it has been offered in a sorted list in registers.
//
// A candidate is a key: (order-preserving bits of its distance, its
// position), smaller key = smaller distance, ties by position.  Keys are
// unique and the selection is exact, so its output is a function of the
// inputs alone.  64-bit keys: the f32 distance's 32 bits, then the
// position (kNone: +inf, position 0xffffffff).  32-bit keys (bf16
// distances, at most kMaxRowsKey32 rows): a bf16 distance has 16 bits, so
// its f32 ordered bits are its bf16 ordered bits in the high half; the row
// takes the low half (kNone32: +inf, row 0xffff), and the order is the
// 64-bit key's.  A 32-bit key moves one register a shuffle, not two.
//
// The list: L = max(32, k_pad) keys, KPL = keys_per_lane(k_pad) a lane,
// sorted ascending in the order i = j*32 + lane, where k_pad = k_pad_of(k)
// = next_pow2(max(k, 8)) is at most kMaxKPad.  A warp offers a round of one
// key a lane and keeps a key only below the list's k_pad-th key (kth, which
// a shuffle broadcasts).  A few kept keys are inserted one by one (insert1,
// a shuffle shift); more are sorted across the warp (warp_sort32) and
// folded in by a reversed min against the list's last 32 keys and a bitonic
// merge over __shfl_xor_sync (merge32).  Two lists merge the same way
// (reversed min, then bitonic_merge).  No block barrier runs inside.  How
// many kept keys go in one by one, and when the k_pad-th key is read again,
// is each kernel's own round policy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wtopk {

typedef unsigned long long u64;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxKPad = 256;
constexpr u64 kNone = 0xff800000ffffffffull;   // (+inf, none)
constexpr uint32_t kNone32 = 0xff80ffffu;      // (+inf, none)
constexpr int kMaxRowsKey32 = 0xffff;          // rows 0 .. 0xfffe

// Keys a lane of a list of k_pad keys.
inline int keys_per_lane(int kp) { return kp <= 32 ? 1 : kp / 32; }

// The list length for k winners: next_pow2(max(k, 8)).
inline int k_pad_of(int k) {
  int kp = 8;
  while (kp < k) kp <<= 1;
  return kp;
}

__device__ __forceinline__ uint32_t ordered_bits(float d) {
  const uint32_t u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The key of distance d at position c; the last argument picks the width.
__device__ __forceinline__ u64 make_key(float d, int c, u64) {
  return ((u64)ordered_bits(d) << 32) | (uint32_t)c;
}

__device__ __forceinline__ uint32_t make_key(float d, int c, uint32_t) {
  return (ordered_bits(d) & 0xffff0000u) | (uint32_t)c;
}

__device__ __forceinline__ u64 none_key(u64) { return kNone; }
__device__ __forceinline__ uint32_t none_key(uint32_t) { return kNone32; }

// A key's position (none_row(Key()) for a "none" key) and distance.
__device__ __forceinline__ uint32_t key_row(u64 k) { return (uint32_t)k; }
__device__ __forceinline__ uint32_t key_row(uint32_t k) {
  return k & 0xffffu;
}

__device__ __forceinline__ uint32_t none_row(u64) { return 0xffffffffu; }
__device__ __forceinline__ uint32_t none_row(uint32_t) { return 0xffffu; }

__device__ __forceinline__ float key_dist(u64 k) {
  return from_ordered((uint32_t)(k >> 32));
}

__device__ __forceinline__ float key_dist(uint32_t k) {
  const uint32_t o = k >> 16;         // bf16 ordered bits -> bf16 bits
  return __uint_as_float(((o & 0x8000u) ? (o & 0x7fffu) : (~o & 0xffffu))
                         << 16);
}

template <typename Key>
__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }
template <typename Key>
__device__ __forceinline__ Key kmax(Key a, Key b) { return a < b ? b : a; }

// One key a lane, sorted ascending across the warp (bitonic, 15 steps).
template <typename Key>
__device__ __forceinline__ Key warp_sort32(Key x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const Key y = __shfl_xor_sync(kAll, x, j);
      const bool low = (lane & j) == 0, up = (lane & k) == 0;
      x = low == up ? kmin(x, y) : kmax(x, y);
    }
  }
  return x;
}

// Sort a bitonic sequence of L = 32 * KPL keys held as i = j*32 + lane:
// half-cleaners at distances L/2 .. 32 inside a lane, 16 .. 1 across.
template <int KPL, typename Key>
__device__ __forceinline__ void bitonic_merge(Key (&v)[KPL], int lane) {
#pragma unroll
  for (int jd = KPL / 2; jd > 0; jd >>= 1) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if ((j & jd) == 0) {
        const Key a = v[j], b = v[j + jd];
        v[j] = kmin(a, b);
        v[j + jd] = kmax(a, b);
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const Key y = __shfl_xor_sync(kAll, v[j], d);
      v[j] = (lane & d) ? kmax(v[j], y) : kmin(v[j], y);
    }
  }
}

// Fold 32 candidates (one a lane, none where none) into the sorted list:
// after it the list holds the L smallest of both, sorted.  The candidates
// are sorted, reversed and min-ed into the list's last 32 keys, which
// leaves a bitonic sequence.
template <int KPL, typename Key>
__device__ __forceinline__ void merge32(Key (&v)[KPL], Key cand, int lane) {
  cand = warp_sort32(cand, lane);
  v[KPL - 1] = kmin(v[KPL - 1], __shfl_sync(kAll, cand, 31 - lane));
  bitonic_merge<KPL>(v, lane);
}

// Insert one key (not none) into the sorted list; the largest key drops.
template <int KPL, typename Key>
__device__ __forceinline__ void insert1(Key (&v)[KPL], Key x, int lane) {
  Key prev[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const Key up = __shfl_up_sync(kAll, v[j], 1);
    const Key last = j > 0 ? __shfl_sync(kAll, v[j > 0 ? j - 1 : 0], 31) : 0;
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
template <int KPL, typename Key>
__device__ __forceinline__ Key kth(const Key (&v)[KPL], int kp) {
  if constexpr (KPL == 1) return __shfl_sync(kAll, v[0], kp - 1);
  return __shfl_sync(kAll, v[KPL - 1], 31);
}

}  // namespace wtopk
