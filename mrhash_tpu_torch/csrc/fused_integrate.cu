// K1: fused TSDF integrate over the compacted block window (single
// resolution).
//
// Replaces mrhash_tpu/ops/fused_integrate.py::_kernel (res-0 branch), the
// Pallas kernel launched by fused_integrate_pallas.  One CTA per window
// entry, one thread per voxel of its 8^3 block.  Each thread:
//   1. projects its voxel lattice -> world -> camera -> pixel from the cam
//      vector (the same f32 operations, in the same order, as the plain
//      twin ops/fused_integrate.py::fused_integrate_rows_ref);
//   2. loads depth (f32) and packed RGB (i32) at its OWN pixel of the
//      unpadded frame — no patch, no one-hot sampling, no 1/2048 m depth
//      quantisation (PORT_NOTES.md P1, P2);
//   3. applies truncation, combineVoxel and the Welford sum_squared update
//      (voxel_data_structures.cu:1162-1180) and writes its pool lanes in
//      place.  Window rows are unique at one resolution, so no two CTAs
//      touch the same row; this replaces the TPU's pack -> kernel -> row
//      scatter round trip.
// The CTA then block-reduces the GC flags of its row: min |sdf| over
// weighted lanes, max weight, weight sum, sumsq sum over weighted lanes.
//
// Bound: bytes.  Per voxel 12 B of pool read (sdf, sumsq, weight), per
// updated voxel 4 B more (rgbp) and 16 B written (only updated lanes are
// loaded for colour and stored); the frame (depth + rgb) read once;
// ~60 flops per voxel.  A 512-thread CTA reads its row with fully
// coalesced 2 KB loads per field; the frame reads are gathers, but
// neighbouring voxels land on neighbouring pixels, so they hit L2/L1
// (the 1200x680 frame is 6.5 MB and stays in the 50 MB L2).
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 512;
constexpr int kWarps = kLanes / 32;
constexpr int kCamLen = 32;
constexpr float kFar = 3e38f;

__global__ void __launch_bounds__(kLanes) fused_integrate_rows_kernel(
    const float* __restrict__ depth_img, const int32_t* __restrict__ rgb_img,
    int img_cols, const float* __restrict__ cam,
    const int32_t* __restrict__ bpos, const int64_t* __restrict__ prow,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, int32_t* __restrict__ rgbp,
    float* __restrict__ flags) {
  __shared__ float s_cam[kCamLen];
  __shared__ float s_min[kWarps];
  __shared__ float s_ssq[kWarps];
  __shared__ int s_max[kWarps];
  __shared__ int s_sum[kWarps];

  const int lane = threadIdx.x;
  const int64_t a = blockIdx.x;
  if (lane < kCamLen) s_cam[lane] = cam[lane];
  __syncthreads();

  // cam vector layout: ops/fused_integrate.py::make_cam_vec
  const float fx = s_cam[0], fy = s_cam[1], cx = s_cam[2], cy = s_cam[3];
  const float min_d = s_cam[4], max_d = s_cam[5];
  const float r00 = s_cam[6], r01 = s_cam[7], r02 = s_cam[8];
  const float r10 = s_cam[9], r11 = s_cam[10], r12 = s_cam[11];
  const float r20 = s_cam[12], r21 = s_cam[13], r22 = s_cam[14];
  const float tx = s_cam[15], ty = s_cam[16], tz = s_cam[17];
  const float vvs = s_cam[18], t0 = s_cam[19], t1 = s_cam[20];
  const float max_int = s_cam[21], w_samp = s_cam[22], w_max = s_cam[23];
  const float rows_f = s_cam[24], cols_f = s_cam[25];

  // ---- lattice -> world -> camera -> pixel -------------------------------
  const float bx = (float)bpos[3 * a + 0];
  const float by = (float)bpos[3 * a + 1];
  const float bz = (float)bpos[3 * a + 2];
  const float offx = (float)(lane & 7);
  const float offy = (float)((lane >> 3) & 7);
  const float offz = (float)(lane >> 6);
  const float pwx = (bx * 8.0f + offx) * vvs - tx;
  const float pwy = (by * 8.0f + offy) * vvs - ty;
  const float pwz = (bz * 8.0f + offz) * vvs - tz;
  // world_to_cam: (pw - t) @ rot, rot is cam->world, row-major
  const float pcx = pwx * r00 + pwy * r10 + pwz * r20;
  const float pcy = pwx * r01 + pwy * r11 + pwz * r21;
  const float pcz = pwx * r02 + pwy * r12 + pwz * r22;

  const bool depth_ok = (pcz > min_d) && (pcz <= max_d);
  const float zs = (pcz == 0.0f) ? 1.0f : pcz;
  // C truncation toward zero (camera.cuh projectPoint): a row in (-1, 0)
  // becomes 0 and passes the row >= 0 test, the reference's exact quirk.
  // The conversion saturates, so off-image values stay off-image.
  const int row = (int)(fy * pcy / zs + cy + 0.5f);
  const int col = (int)(fx * pcx / zs + cx + 0.5f);
  const bool ok = depth_ok && row >= 0 && col >= 0 &&
                  (float)row < rows_f && (float)col < cols_f;

  float depth = 0.0f;
  int32_t pk = 0;
  if (ok) {
    const int64_t p = (int64_t)row * img_cols + col;
    depth = depth_img[p];
    pk = rgb_img[p];
  }

  // ---- TSDF fuse + Welford variance --------------------------------------
  const int64_t off = prow[a] * kLanes + lane;
  const float sdf0 = sdf[off];
  const float ssq0 = sumsq[off];
  const int32_t w0 = weight[off];

  const bool depth_ok2 = ok && depth != 0.0f && depth <= max_int;
  float s = depth - pcz;
  const float trunc = t0 + t1 * depth;
  const bool inside = s > -trunc;
  s = fminf(fmaxf(s, -trunc), trunc);
  const bool update = depth_ok2 && inside;

  float out_sdf = sdf0, out_ssq = ssq0;
  int32_t out_w = w0;
  if (update) {
    const float w0f = (float)w0;
    const float half = vvs * 0.5f;
    const float curr_mean = (w0 > 0) ? sdf0 : s;
    const float delta = (s - curr_mean) / half;
    // combineVoxel (voxel_hash_utils.cuh:167-181): weighted SDF merge,
    // 50/50 colour blend; the first observation takes the new colour
    const float r_new = (float)(pk & 255);
    const float g_new = (float)((pk >> 8) & 255);
    const float b_new = (float)((pk >> 16) & 255);
    const bool first = w0 == 0;
    const int32_t rgbp0 = rgbp[off];   // read only where the lane updates
    const float r_old = first ? r_new : (float)(rgbp0 & 255);
    const float g_old = first ? g_new : (float)((rgbp0 >> 8) & 255);
    const float b_old = first ? b_new : (float)((rgbp0 >> 16) & 255);
    const float r_m = floorf(0.5f * r_old + 0.5f * r_new + 0.5f);
    const float g_m = floorf(0.5f * g_old + 0.5f * g_new + 0.5f);
    const float b_m = floorf(0.5f * b_old + 0.5f * b_new + 0.5f);
    const float m_sdf = (sdf0 * w0f + s * w_samp) / (w0f + w_samp);
    const float delta2 = (s - m_sdf) / half;
    out_sdf = m_sdf;
    out_ssq = ssq0 + delta * delta2;
    out_w = (int32_t)fminf(w_max, w0f + w_samp);
    sdf[off] = out_sdf;
    sumsq[off] = out_ssq;
    weight[off] = out_w;
    rgbp[off] = (int32_t)(r_m + g_m * 256.0f + b_m * 65536.0f);
  }

  // ---- GC flags of the updated row ---------------------------------------
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
  const int warp = lane >> 5;
  if ((lane & 31) == 0) {
    s_min[warp] = v_min;
    s_ssq[warp] = v_ssq;
    s_max[warp] = v_max;
    s_sum[warp] = v_sum;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kWarps;
    v_min = has ? s_min[lane] : kFar;
    v_ssq = has ? s_ssq[lane] : 0.0f;
    v_max = has ? s_max[lane] : 0;
    v_sum = has ? s_sum[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v_min = fminf(v_min, __shfl_xor_sync(0xffffffffu, v_min, o));
      v_ssq += __shfl_xor_sync(0xffffffffu, v_ssq, o);
      v_max = max(v_max, __shfl_xor_sync(0xffffffffu, v_max, o));
      v_sum += __shfl_xor_sync(0xffffffffu, v_sum, o);
    }
    if (lane == 0) {
      flags[4 * a + 0] = v_min;
      flags[4 * a + 1] = (float)v_max;
      flags[4 * a + 2] = (float)v_sum;
      flags[4 * a + 3] = v_ssq;
    }
  }
}

}  // namespace

// Launches K1 on `stream` over n_blocks window entries; returns
// cudaGetLastError() (0 on success).  Pointers: depth f32[H,W],
// rgb i32[H,W], cam f32[32], bpos i32[A,3], prow i64[A], pool fields
// [N,512], flags f32[A,4].  The wrapper checks 0 <= prow < N; the caller
// guarantees distinct rows.
extern "C" int mrhash_fused_integrate_rows(
    const void* depth, const void* rgb, int cols, const void* cam,
    const void* bpos, const void* prow, int64_t n_blocks, void* sdf,
    void* sumsq, void* weight, void* rgbp, void* flags, void* stream) {
  if (n_blocks > 0) {
    fused_integrate_rows_kernel<<<(unsigned)n_blocks, kLanes, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)depth, (const int32_t*)rgb, cols, (const float*)cam,
        (const int32_t*)bpos, (const int64_t*)prow, (float*)sdf,
        (float*)sumsq, (int32_t*)weight, (int32_t*)rgbp, (float*)flags);
  }
  return (int)cudaGetLastError();
}
