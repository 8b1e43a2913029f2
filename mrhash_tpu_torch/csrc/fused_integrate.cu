// K1: fused TSDF integrate over the compacted block window, both
// resolutions.
//
// Replaces mrhash_tpu/ops/fused_integrate.py::_kernel, the Pallas kernel
// launched by fused_integrate_pallas: its plain res-0 branch and its packed
// res-1 branch.  The kernel works per window ENTRY, not per pool row: a
// 512-thread CTA takes one res-0 entry (its 8^3 voxels, the whole row
// [ptr, ptr + 512)) or 8 res-1 entries of any rows, 64 threads each (a
// 4^3 lattice at twice the voxel spacing, the window [ptr, ptr + 64) that
// up to 7 siblings' windows share a row with).  Entries own disjoint
// windows, so no two threads write the same voxel and the TPU's row
// packing (pack_window_rows: VMEM patches, XLA's per-element scatter cost,
// Mosaic's per-slot branches) has no counterpart.  The wrapper launches the
// res-0 and the res-1 instantiation over the entry lists of each kind.
// Each thread:
//   1. projects its voxel lattice -> world -> camera -> pixel from the cam
//      vector (the same f32 operations, in the same order, as the plain
//      twin ops/fused_integrate.py::fused_integrate_rows_ref);
//   2. loads depth (f32) and packed RGB (i32) at its OWN pixel of the
//      unpadded frame — no patch, no one-hot sampling, no 1/2048 m depth
//      quantisation (PORT_NOTES.md P1, P2);
//   3. applies truncation, combineVoxel and the Welford sum_squared update
//      (voxel_data_structures.cu:1162-1180) and writes its voxel in place
//      at ptr + local.
// Each entry then reduces its flags over its own window (warp shuffles,
// then the entry's warps through shared memory): min |sdf| over weighted
// lanes, max weight, weight sum, sumsq sum over weighted lanes.
//
// Bound: bytes.  Per voxel of the window 12 B of pool read (sdf, sumsq,
// weight), per updated voxel 4 B more (rgbp) and 16 B written (only
// updated lanes are loaded for colour and stored); the frame (depth + rgb)
// read once; ~60 flops per voxel.  A group reads its window with coalesced
// loads (2 KB per field for res 0, 256 B for res 1); the frame reads are
// gathers, but neighbouring voxels land on neighbouring pixels, so they hit
// L2/L1 (the 1200x680 frame is 6.5 MB and stays in the 50 MB L2).
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCamLen = 32;
constexpr float kFar = 3e38f;

// kVox voxels per entry: 512 (res 0, 8^3) or 64 (res 1, 4^3 at 2x spacing)
template <int kVox>
__global__ void __launch_bounds__(kThreads) fused_integrate_kernel(
    const float* __restrict__ depth_img, const int32_t* __restrict__ rgb_img,
    int img_cols, const float* __restrict__ cam,
    const int32_t* __restrict__ bpos, const int32_t* __restrict__ ptr,
    const int64_t* __restrict__ entries, int64_t n_entries,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, int32_t* __restrict__ rgbp,
    float* __restrict__ flags) {
  constexpr int kGroups = kThreads / kVox;
  constexpr int kGroupWarps = kVox / 32;
  __shared__ float s_cam[kCamLen];
  __shared__ float s_min[kWarps];
  __shared__ float s_ssq[kWarps];
  __shared__ int s_max[kWarps];
  __shared__ int s_sum[kWarps];

  const int tid = threadIdx.x;
  const int local = tid % kVox;
  const int64_t slot = (int64_t)blockIdx.x * kGroups + tid / kVox;
  // a group past the last entry stays for the barriers and writes nothing;
  // groups are whole warps, so the shuffles below see uniform warps
  const bool active = slot < n_entries;
  const int64_t a = active ? entries[slot] : 0;
  if (tid < kCamLen) s_cam[tid] = cam[tid];
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

  float out_sdf = 0.0f, out_ssq = 0.0f;
  int32_t out_w = 0;
  if (active) {
    // ---- lattice -> world -> camera -> pixel -----------------------------
    const float bx = (float)bpos[3 * a + 0];
    const float by = (float)bpos[3 * a + 1];
    const float bz = (float)bpos[3 * a + 2];
    float offx, offy, offz;
    if (kVox == 512) {
      offx = (float)(local & 7);
      offy = (float)((local >> 3) & 7);
      offz = (float)(local >> 6);
    } else {  // res-1 carve: 4^3 samples at 2x spacing
      offx = (float)((local & 3) * 2);
      offy = (float)(((local >> 2) & 3) * 2);
      offz = (float)((local >> 4) * 2);
    }
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

    // ---- TSDF fuse + Welford variance ------------------------------------
    const int64_t off = (int64_t)ptr[a] + local;
    const float sdf0 = sdf[off];
    const float ssq0 = sumsq[off];
    const int32_t w0 = weight[off];

    const bool depth_ok2 = ok && depth != 0.0f && depth <= max_int;
    float s = depth - pcz;
    const float trunc = t0 + t1 * depth;
    const bool inside = s > -trunc;
    s = fminf(fmaxf(s, -trunc), trunc);
    const bool update = depth_ok2 && inside;

    out_sdf = sdf0;
    out_ssq = ssq0;
    out_w = w0;
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

// Launches K1 on `stream` over the n_entries window entries listed in
// `entries`, all of resolution `res` (0 or 1); returns cudaGetLastError()
// (0 on success).  Pointers: depth f32[H,W], rgb i32[H,W], cam f32[32],
// bpos i32[A,3], ptr i32[A], entries i64[n_entries] (indices into the
// window), pool fields [N,512], flags f32[A,4].  The wrapper checks each
// ptr against the pool and its alignment (512 for res 0, 64 for res 1);
// entries own disjoint windows.
extern "C" int mrhash_fused_integrate_window(
    const void* depth, const void* rgb, int cols, const void* cam,
    const void* bpos, const void* ptr, const void* entries,
    int64_t n_entries, int res, void* sdf, void* sumsq, void* weight,
    void* rgbp, void* flags, void* stream) {
  if (n_entries > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (res == 0) {
      fused_integrate_kernel<512><<<(unsigned)n_entries, kThreads, 0, s>>>(
          (const float*)depth, (const int32_t*)rgb, cols, (const float*)cam,
          (const int32_t*)bpos, (const int32_t*)ptr, (const int64_t*)entries,
          n_entries, (float*)sdf, (float*)sumsq, (int32_t*)weight,
          (int32_t*)rgbp, (float*)flags);
    } else {
      const unsigned grid = (unsigned)((n_entries + 7) / 8);
      fused_integrate_kernel<64><<<grid, kThreads, 0, s>>>(
          (const float*)depth, (const int32_t*)rgb, cols, (const float*)cam,
          (const int32_t*)bpos, (const int32_t*)ptr, (const int64_t*)entries,
          n_entries, (float*)sdf, (float*)sumsq, (int32_t*)weight,
          (int32_t*)rgbp, (float*)flags);
    }
  }
  return (int)cudaGetLastError();
}
