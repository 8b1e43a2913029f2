// K3: fused projective LiDAR update over the compacted block window
// (single resolution).
//
// Replaces mrhash_tpu/ops/fused_integrate.py::_kernel_sph (plain branch),
// the Pallas kernel launched by fused_integrate_points_pallas.  One CTA per
// window entry, one thread per voxel of its 8^3 block.  The spherical
// projection (atan2/asin) runs in torch before the launch
// (ops/integrate.py::project_window_sph), so the kernel and its plain twin
// ops/fused_integrate_points.py::fused_integrate_points_rows_ref see the
// same per-lane (pix, r_vox) and no libdevice/libm ulp difference can move
// a voxel to another pixel (PORT_NOTES.md P15).  Each thread:
//   1. loads the f32 range at its own pixel of the unpadded min-range
//      image (no 3-channel bf16 split, no one-hot MXU sampling, no
//      1/2048 m quantisation, no patch window: P13, P14);
//   2. gates the projective update on the truncation band on both sides,
//      pix >= 0 & r_px > 0 & r_px <= max_int & -trunc < sdf < trunc, so
//      nothing is carved (the reference's deviation D19);
//   3. merges with the reference 3D kernel's Welford quirk: curr_mean is 0
//      for never-touched voxels (fused_integrate.py:661-667), and writes
//      sdf / sumsq / weight of its updated lane in place.  rgbp is not
//      touched.  Window rows are unique at one resolution, so no two CTAs
//      write the same row.
// The CTA then block-reduces the GC flags of its row: min |sdf| over
// weighted lanes and max weight.
//
// Bound: bytes.  Per voxel 16 B read (pix, r_vox, sdf, weight), per
// updated voxel 4 B more (sumsq) and 12 B written; the range image
// (256 KB at 64x1024) stays in L2.
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 512;
constexpr int kWarps = kLanes / 32;
constexpr float kFar = 3e38f;

__global__ void __launch_bounds__(kLanes) fused_integrate_points_kernel(
    const float* __restrict__ img, const int32_t* __restrict__ pix,
    const float* __restrict__ r_vox, const int32_t* __restrict__ prow,
    float t0, float t1, float max_int, float w_samp, float w_max, float vvs,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, float* __restrict__ flags) {
  __shared__ float s_min[kWarps];
  __shared__ int s_max[kWarps];

  const int lane = threadIdx.x;
  const int64_t a = blockIdx.x;
  const int64_t i = a * kLanes + lane;

  const int32_t p = pix[i];
  const float r_px = (p >= 0) ? img[p] : 0.0f;
  float s = r_px - r_vox[i];
  const float trunc = t0 + t1 * r_px;
  const bool update = p >= 0 && r_px > 0.0f && r_px <= max_int &&
                      s > -trunc && s < trunc;
  s = fminf(fmaxf(s, -trunc), trunc);

  const int64_t off = (int64_t)prow[a] * kLanes + lane;
  float out_sdf = sdf[off];
  int32_t out_w = weight[off];
  if (update) {
    const float sdf0 = out_sdf;
    const float ssq0 = sumsq[off];
    const float w0f = (float)out_w;
    const float half = vvs * 0.5f;
    const float curr_mean = (out_w > 0) ? sdf0 : 0.0f;
    const float delta = (s - curr_mean) / half;
    const float m_sdf = (sdf0 * w0f + s * w_samp) / (w0f + w_samp);
    const float delta2 = (s - m_sdf) / half;
    out_sdf = m_sdf;
    out_w = (int32_t)fminf(w_max, w0f + w_samp);
    sdf[off] = out_sdf;
    sumsq[off] = ssq0 + delta * delta2;
    weight[off] = out_w;
  }

  // ---- GC flags of the updated row ---------------------------------------
  float v_min = (out_w > 0) ? fabsf(out_sdf) : kFar;
  int v_max = out_w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v_min = fminf(v_min, __shfl_xor_sync(0xffffffffu, v_min, o));
    v_max = max(v_max, __shfl_xor_sync(0xffffffffu, v_max, o));
  }
  const int warp = lane >> 5;
  if ((lane & 31) == 0) {
    s_min[warp] = v_min;
    s_max[warp] = v_max;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kWarps;
    v_min = has ? s_min[lane] : kFar;
    v_max = has ? s_max[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v_min = fminf(v_min, __shfl_xor_sync(0xffffffffu, v_min, o));
      v_max = max(v_max, __shfl_xor_sync(0xffffffffu, v_max, o));
    }
    if (lane == 0) {
      flags[2 * a + 0] = v_min;
      flags[2 * a + 1] = (float)v_max;
    }
  }
}

}  // namespace

// Launches K3 on `stream` over n_blocks window entries; returns
// cudaGetLastError() (0 on success).  Pointers: img f32[H,W], pix
// i32[A,512] (row * W + col, or -1), r_vox f32[A,512], prow i32[A], pool
// fields [N,512], flags f32[A,2].  The wrapper checks -1 <= pix < H*W and
// 0 <= prow < N; the caller guarantees distinct rows.
extern "C" int mrhash_fused_integrate_points_rows(
    const void* img, const void* pix, const void* r_vox, const void* prow,
    int64_t n_blocks, float t0, float t1, float max_int, float w_samp,
    float w_max, float vvs, void* sdf, void* sumsq, void* weight,
    void* flags, void* stream) {
  if (n_blocks > 0) {
    fused_integrate_points_kernel<<<(unsigned)n_blocks, kLanes, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)img, (const int32_t*)pix, (const float*)r_vox,
        (const int32_t*)prow, t0, t1, max_int, w_samp, w_max, vvs,
        (float*)sdf, (float*)sumsq, (int32_t*)weight, (float*)flags);
  }
  return (int)cudaGetLastError();
}
