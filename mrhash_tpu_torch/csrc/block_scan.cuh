// The one-CTA exclusive prefix sum of K8, K9 (csrc/alloc_blocks.cu) and
// K10 (csrc/coarsen_blocks.cu): their ordered compactions, ranked heap
// draws and pushes.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kScanCta = 1024;

// Exclusive prefix sum of v over a kScanCta-thread CTA; *total gets the
// sum.  Every thread of the CTA calls it.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sum[kScanCta / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[kScanCta / 32 - 1];
  __syncthreads();
  return before + x - v;
}

}  // namespace
