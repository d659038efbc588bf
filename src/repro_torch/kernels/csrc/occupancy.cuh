// Host code shared by the launchers of the persistent-grid kernels
// (lut_build.cu, pq_scan_topk.cu, ts_topk.cu): how many blocks of one
// kernel instance fit on the current device at once, which each launcher
// turns into its grid.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

namespace occupancy {

constexpr int kMaxDevices = 64;   // devices whose answer is remembered

// One kernel instance's answers, a device each: (smem << 32) | blocks, 0
// until looked up.  Each instance's launcher keeps its own, static.
struct Resident {
  std::atomic<unsigned long long> seen[kMaxDevices];
};

// The blocks of `kernel`, at `threads` a block and `smem` bytes of dynamic
// shared memory, that fit on the current device at once, into *blocks.
// Looked up on the first launch per device and shared-memory size (which
// also lets the kernel take more than 48 KB) and kept in `resident`.
// Returns the first failing CUDA call's error, or
// cudaErrorInvalidConfiguration if no block fits.  (The kernel is an
// argument, not a template argument: as one, it changed how nvcc compiled
// a kernel.)
template <typename Kernel>
cudaError_t resident_blocks(Resident& resident, Kernel kernel, int threads,
                            size_t smem, int* blocks) {
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const unsigned long long seen =
      dev < kMaxDevices ? resident.seen[dev].load(std::memory_order_relaxed)
                        : 0;
  if (seen != 0 && (seen >> 32) == smem) {
    *blocks = (int)(seen & 0xffffffffull);
    return cudaSuccess;
  }
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices)
    resident.seen[dev].store(
        ((unsigned long long)smem << 32) | (unsigned)*blocks,
        std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace occupancy
