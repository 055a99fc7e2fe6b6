// What the port's grouped elementwise kernels (sophia_update.cu,
// fused_agg.cu) share: a launch covers a list of leaves described by a
// table of per-leaf records, passed by value as the kernel's
// __grid_constant__ parameter (no host-to-device copy, nothing to
// outlive the launch).  Each record holds the first unit of work (chunk
// or work item) of its leaf in the launch's global index; a block finds
// the leaf of a unit by binary search over those starts, staged in shared
// memory.  The host side is kernels/grouped.py.
#pragma once

#include <cuda_runtime.h>

namespace grouped {

// bytes of kernel parameters a launch may take on Hopper (CUDA >= 12.1)
constexpr int PARAM_LIMIT = 32764;
constexpr int MAX_DEVICES = 64;

// The last entry whose start is <= x: starts ascend, starts[0] == 0.
__device__ __forceinline__ int find(const int* starts, int count, int x) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Blocks of `kernel` resident on the current device at once (SMs x blocks
// per SM), cached per device in `cache` (zero until the device is seen).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int* cache,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

}  // namespace grouped
