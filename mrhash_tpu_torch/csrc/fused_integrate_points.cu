// K3: fused projective LiDAR update over the compacted block window, both
// resolutions.
//
// Replaces mrhash_tpu/ops/fused_integrate.py::_kernel_sph (plain branch and
// packed res-1 branch), the Pallas kernel launched by
// fused_integrate_points_pallas.  The kernel works per window ENTRY: a
// 512-thread CTA takes one res-0 entry (its 512 voxels, the whole row) or
// 8 res-1 entries of any rows, 64 threads each (the entry's window
// [ptr, ptr + 64) of a row its siblings share).  Entries own disjoint
// windows, so no two threads write the same voxel, and the TPU's row
// packing has no counterpart.  The spherical projection (atan2/asin) runs
// in torch before the launch (ops/integrate.py::project_window_sph), so the
// kernel and its plain twin
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
//      sdf / sumsq / weight of its updated voxel in place at ptr + local.
//      rgbp is not touched.
// Each entry then reduces its flags over its own window: min |sdf| over
// weighted lanes, max weight, weight sum, sumsq sum over weighted lanes.
//
// Bound: bytes.  Per voxel of the window 16 B read (pix, r_vox, sdf,
// weight), per updated voxel 4 B more (sumsq) and 12 B written; the range
// image (256 KB at 64x1024) stays in L2.
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 512;   // lanes per entry of pix / r_vox
constexpr int kWarps = kThreads / 32;
constexpr float kFar = 3e38f;

// kVox voxels per entry: 512 (res 0) or 64 (res 1)
template <int kVox>
__global__ void __launch_bounds__(kThreads) fused_integrate_points_kernel(
    const float* __restrict__ img, const int32_t* __restrict__ pix,
    const float* __restrict__ r_vox, const int32_t* __restrict__ ptr,
    const int64_t* __restrict__ entries, int64_t n_entries, float t0,
    float t1, float max_int, float w_samp, float w_max, float vvs,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, float* __restrict__ flags) {
  constexpr int kGroups = kThreads / kVox;
  constexpr int kGroupWarps = kVox / 32;
  __shared__ float s_min[kWarps];
  __shared__ float s_ssq[kWarps];
  __shared__ int s_max[kWarps];
  __shared__ int s_sum[kWarps];

  const int tid = threadIdx.x;
  const int local = tid % kVox;
  const int64_t slot = (int64_t)blockIdx.x * kGroups + tid / kVox;
  // a group past the last entry stays for the barrier and writes nothing;
  // groups are whole warps, so the shuffles below see uniform warps
  const bool active = slot < n_entries;
  const int64_t a = active ? entries[slot] : 0;

  float out_sdf = 0.0f, out_ssq = 0.0f;
  int32_t out_w = 0;
  if (active) {
    const int64_t i = a * kLanes + local;
    const int32_t p = pix[i];
    const float r_px = (p >= 0) ? img[p] : 0.0f;
    float s = r_px - r_vox[i];
    const float trunc = t0 + t1 * r_px;
    const bool update = p >= 0 && r_px > 0.0f && r_px <= max_int &&
                        s > -trunc && s < trunc;
    s = fminf(fmaxf(s, -trunc), trunc);

    const int64_t off = (int64_t)ptr[a] + local;
    out_sdf = sdf[off];
    out_w = weight[off];
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
      out_ssq = ssq0 + delta * delta2;
      out_w = (int32_t)fminf(w_max, w0f + w_samp);
      sdf[off] = out_sdf;
      sumsq[off] = out_ssq;
      weight[off] = out_w;
    } else if (out_w > 0) {
      out_ssq = sumsq[off];   // the flags sum sumsq over weighted lanes
    }
  }

  // ---- flags of the entry's window after the update ----------------------
  float v_min = (out_w > 0) ? fabsf(out_sdf) : kFar;
  float v_ssq = (out_w > 0) ? out_ssq : 0.0f;
  int v_max = out_w;
  int v_sum = out_w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v_min = fminf(v_min, __shfl_xor_sync(0xffffffffu, v_min, o));
    v_ssq += __shfl_xor_sync(0xffffffffu, v_ssq, o);
    v_max = max(v_max, __shfl_xor_sync(0xffffffffu, v_max, o));
    v_sum += __shfl_xor_sync(0xffffffffu, v_sum, o);
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    s_min[warp] = v_min;
    s_ssq[warp] = v_ssq;
    s_max[warp] = v_max;
    s_sum[warp] = v_sum;
  }
  __syncthreads();
  if (active && local == 0) {   // `warp` is the group's first warp here
    for (int k = 1; k < kGroupWarps; ++k) {
      v_min = fminf(v_min, s_min[warp + k]);
      v_ssq += s_ssq[warp + k];
      v_max = max(v_max, s_max[warp + k]);
      v_sum += s_sum[warp + k];
    }
    flags[4 * a + 0] = v_min;
    flags[4 * a + 1] = (float)v_max;
    flags[4 * a + 2] = (float)v_sum;
    flags[4 * a + 3] = v_ssq;
  }
}

}  // namespace

// Launches K3 on `stream` over the n_entries window entries listed in
// `entries`, all of resolution `res` (0 or 1); returns cudaGetLastError()
// (0 on success).  Pointers: img f32[H,W], pix i32[A,512] (row * W + col,
// or -1; a res-1 entry's lanes 0..63), r_vox f32[A,512], ptr i32[A],
// entries i64[n_entries], pool fields [N,512], flags f32[A,4].  The wrapper
// checks -1 <= pix < H*W and each ptr against the pool and its alignment;
// entries own disjoint windows.
extern "C" int mrhash_fused_integrate_points_window(
    const void* img, const void* pix, const void* r_vox, const void* ptr,
    const void* entries, int64_t n_entries, int res, float t0, float t1,
    float max_int, float w_samp, float w_max, float vvs, void* sdf,
    void* sumsq, void* weight, void* flags, void* stream) {
  if (n_entries > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (res == 0) {
      fused_integrate_points_kernel<512>
          <<<(unsigned)n_entries, kThreads, 0, s>>>(
              (const float*)img, (const int32_t*)pix, (const float*)r_vox,
              (const int32_t*)ptr, (const int64_t*)entries, n_entries, t0,
              t1, max_int, w_samp, w_max, vvs, (float*)sdf, (float*)sumsq,
              (int32_t*)weight, (float*)flags);
    } else {
      fused_integrate_points_kernel<64>
          <<<(unsigned)((n_entries + 7) / 8), kThreads, 0, s>>>(
              (const float*)img, (const int32_t*)pix, (const float*)r_vox,
              (const int32_t*)ptr, (const int64_t*)entries, n_entries, t0,
              t1, max_int, w_samp, w_max, vvs, (float*)sdf, (float*)sumsq,
              (int32_t*)weight, (float*)flags);
    }
  }
  return (int)cudaGetLastError();
}
