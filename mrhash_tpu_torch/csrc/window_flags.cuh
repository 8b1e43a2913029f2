// The per-entry flags of K1 and K3 (csrc/fused_integrate.cu,
// csrc/fused_integrate_points.cu): min |sdf| over weighted voxels, max
// weight, weight sum and sumsq sum over weighted voxels of an entry's
// window, the four lanes that ops/integrate.py::window_decisions reads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFar = 3e38f;
constexpr unsigned kAll = 0xffffffffu;

// One entry's flags, accumulated voxel by voxel from no_flags().  (A plain
// aggregate: it also lives in shared memory.)
struct Flags {
  float min_sdf, ssq;
  int max_w, sum_w;
  __device__ __forceinline__ void add(float sdf, float ssq_v, int32_t w) {
    min_sdf = fminf(min_sdf, (w > 0) ? fabsf(sdf) : kFar);
    ssq += (w > 0) ? ssq_v : 0.0f;
    max_w = max(max_w, w);
    sum_w += w;
  }
  __device__ __forceinline__ void add(const Flags& o) {
    min_sdf = fminf(min_sdf, o.min_sdf);
    ssq += o.ssq;
    max_w = max(max_w, o.max_w);
    sum_w += o.sum_w;
  }
  // combines the flags of kWidth consecutive lanes (a power of two up to
  // 32); every lane of the warp takes part, and each group of kWidth
  // lanes ends with its own total
  template <int kWidth>
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int o = kWidth / 2; o > 0; o >>= 1) {
      min_sdf = fminf(min_sdf, __shfl_xor_sync(kAll, min_sdf, o));
      ssq += __shfl_xor_sync(kAll, ssq, o);
      max_w = max(max_w, __shfl_xor_sync(kAll, max_w, o));
      sum_w += __shfl_xor_sync(kAll, sum_w, o);
    }
  }
  __device__ __forceinline__ void warp_reduce() { reduce<32>(); }
  __device__ __forceinline__ void store(float* f) const {
    f[0] = min_sdf;
    f[1] = (float)max_w;
    f[2] = (float)sum_w;
    f[3] = ssq;
  }
};

__device__ __forceinline__ Flags no_flags() { return {kFar, 0.0f, 0, 0}; }

}  // namespace
