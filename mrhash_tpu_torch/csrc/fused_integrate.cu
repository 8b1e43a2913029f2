// K1: fused TSDF integrate over the compacted block window, both
// resolutions.
//
// Replaces mrhash_tpu/ops/fused_integrate.py::_kernel, the Pallas kernel
// launched by fused_integrate_pallas: its plain res-0 branch and its packed
// res-1 branch.  The kernels work per window ENTRY, not per pool row, and
// write each entry's window in place at ptr + local.  Entries own disjoint
// windows, so no two threads write the same voxel and the TPU's row
// packing (pack_window_rows: VMEM patches, XLA's per-element scatter cost,
// Mosaic's per-slot branches) has no counterpart.  The wrapper launches the
// res-0 and the res-1 kernel over the entry lists of each kind.
// For each voxel, the same f32 operations in the same order as the plain
// twin ops/fused_integrate.py::fused_integrate_rows_ref:
//   1. project the voxel lattice -> world -> camera -> pixel from the cam
//      vector;
//   2. load depth (f32) and packed RGB (i32) at its OWN pixel of the
//      unpadded frame — no patch, no one-hot sampling, no 1/2048 m depth
//      quantisation (PORT_NOTES.md P1, P2);
//   3. apply truncation, combineVoxel and the Welford sum_squared update
//      (voxel_data_structures.cu:1162-1180).
// Each entry then reduces its flags over its own window (warp shuffles,
// then the entry's warps through shared memory): min |sdf| over weighted
// voxels, max weight, weight sum, sumsq sum over weighted voxels.
//
// res 0 (every RGB-D frame): a chain of dependent round trips (entry index
// -> bpos, ptr -> pool and frame -> rgbp -> stores -> a serial tail over
// 16 warps) made the first design, one 512-thread CTA per entry and one
// voxel per thread, latency-bound at ~4 CTAs per SM.  Now:
//   - 128 threads per entry, 4 x-consecutive voxels each: every field of
//     the 2 KB row is one 16-byte load (and store) per thread, coalesced;
//   - all four fields (rgbp too) are loaded as soon as ptr is known, before
//     the projection, so the pool and frame round trips overlap;
//   - a CTA walks kRes0Entries (2) entries, the next one's bpos and ptr in
//     flight while it fuses the current one, and 8 CTAs fit an SM
//     (64 registers); 1, 4 or 8 entries per CTA, or no register cap, timed
//     2-8 % slower on the card (PERF.md);
//   - a thread whose 4 voxels include an update stores all 4 (the others
//     as read); the flags take warp shuffles and one 4-warp combine, with
//     a shared buffer per entry parity, so one barrier per entry.
// res 1 (multi-res frames): a 512-thread CTA takes 8 entries, 64 threads
// each (a 4^3 lattice at twice the voxel spacing, the window [ptr, ptr +
// 64) that up to 7 siblings' windows share a row with), one voxel per
// thread, rgbp read and the voxel written only where it updates.
//
// Bound: bytes.  Per voxel of the window 12 B of pool read (sdf, sumsq,
// weight), per updated voxel 4 B more (rgbp) and 16 B written; the frame
// (depth + rgb) read once; ~60 flops per voxel.  The frame reads are
// gathers, but neighbouring voxels land on neighbouring pixels, so they hit
// L2/L1 (the 1200x680 frame is 6.5 MB and stays in the 50 MB L2).  The
// res-0 kernel moves more than that count (rgbp of every voxel, whole
// 4-voxel groups written back) for fewer dependent round trips.
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_flags.cuh"

namespace {

constexpr int kCamLen = 32;

// res 0: 128 threads per entry, 4 x-consecutive voxels each, and
// kRes0Entries entries per CTA walked in turn
constexpr int kRes0Threads = 128;
constexpr int kRes0Warps = kRes0Threads / 32;
constexpr int kRes0Entries = 2;
constexpr int kRes0CtasPerSm = 8;   // caps registers at 64, no spills
// res 1: 512 threads, 8 entries of 64 voxels
constexpr int kRes1Threads = 512;
constexpr int kRes1Warps = kRes1Threads / 32;
constexpr int kRes1Vox = 64;

// cam vector layout: ops/fused_integrate.py::make_cam_vec
struct Cam {
  float fx, fy, cx, cy, min_d, max_d;
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
  float tx, ty, tz;
  float vvs, t0, t1, max_int, w_samp, w_max, rows_f, cols_f;
};
static_assert(sizeof(Cam) <= kCamLen * sizeof(float), "cam vector");

// lattice -> world -> camera -> pixel, the same f32 operations in the same
// order as the plain twin ops/fused_integrate.py::fused_integrate_rows_ref
__device__ __forceinline__ void project(const Cam& c, float bx, float by,
                                        float bz, float offx, float offy,
                                        float offz, float& pcz, int& row,
                                        int& col, bool& ok) {
  const float pwx = (bx * 8.0f + offx) * c.vvs - c.tx;
  const float pwy = (by * 8.0f + offy) * c.vvs - c.ty;
  const float pwz = (bz * 8.0f + offz) * c.vvs - c.tz;
  // world_to_cam: (pw - t) @ rot, rot is cam->world, row-major
  const float pcx = pwx * c.r00 + pwy * c.r10 + pwz * c.r20;
  const float pcy = pwx * c.r01 + pwy * c.r11 + pwz * c.r21;
  pcz = pwx * c.r02 + pwy * c.r12 + pwz * c.r22;

  const bool depth_ok = (pcz > c.min_d) && (pcz <= c.max_d);
  const float zs = (pcz == 0.0f) ? 1.0f : pcz;
  // C truncation toward zero (camera.cuh projectPoint): a row in (-1, 0)
  // becomes 0 and passes the row >= 0 test, the reference's exact quirk.
  // The conversion saturates, so off-image values stay off-image.
  row = (int)(c.fy * pcy / zs + c.cy + 0.5f);
  col = (int)(c.fx * pcx / zs + c.cx + 0.5f);
  ok = depth_ok && row >= 0 && col >= 0 && (float)row < c.rows_f &&
       (float)col < c.cols_f;
}

// truncation: the clamped sdf sample `s` and whether the voxel updates
__device__ __forceinline__ bool truncate(const Cam& c, bool ok, float depth,
                                         float pcz, float& s) {
  const bool depth_ok2 = ok && depth != 0.0f && depth <= c.max_int;
  s = depth - pcz;
  const float trunc = c.t0 + c.t1 * depth;
  const bool inside = s > -trunc;
  s = fminf(fmaxf(s, -trunc), trunc);
  return depth_ok2 && inside;
}

// combineVoxel (voxel_hash_utils.cuh:167-181) and the Welford sum_squared
// update (voxel_data_structures.cu:1162-1180) of an updating voxel:
// weighted SDF merge, 50/50 colour blend; the first observation takes the
// new colour
__device__ __forceinline__ void combine(const Cam& c, float s, int32_t pk,
                                        float& sdf, float& ssq, int32_t& w,
                                        int32_t& rgbp) {
  const float sdf0 = sdf;
  const int32_t w0 = w;
  const float w0f = (float)w0;
  const float half = c.vvs * 0.5f;
  const float curr_mean = (w0 > 0) ? sdf0 : s;
  const float delta = (s - curr_mean) / half;
  const float r_new = (float)(pk & 255);
  const float g_new = (float)((pk >> 8) & 255);
  const float b_new = (float)((pk >> 16) & 255);
  const bool first = w0 == 0;
  const float r_old = first ? r_new : (float)(rgbp & 255);
  const float g_old = first ? g_new : (float)((rgbp >> 8) & 255);
  const float b_old = first ? b_new : (float)((rgbp >> 16) & 255);
  const float r_m = floorf(0.5f * r_old + 0.5f * r_new + 0.5f);
  const float g_m = floorf(0.5f * g_old + 0.5f * g_new + 0.5f);
  const float b_m = floorf(0.5f * b_old + 0.5f * b_new + 0.5f);
  const float m_sdf = (sdf0 * w0f + s * c.w_samp) / (w0f + c.w_samp);
  const float delta2 = (s - m_sdf) / half;
  sdf = m_sdf;
  ssq = ssq + delta * delta2;
  w = (int32_t)fminf(c.w_max, w0f + c.w_samp);
  rgbp = (int32_t)(r_m + g_m * 256.0f + b_m * 65536.0f);
}

__device__ __forceinline__ void load_cam(const float* __restrict__ cam,
                                         Cam* s_cam) {
  if (threadIdx.x < sizeof(Cam) / sizeof(float))
    reinterpret_cast<float*>(s_cam)[threadIdx.x] = cam[threadIdx.x];
}

// res 0: one entry is 128 threads x 4 x-consecutive voxels of its 8^3 row
// [ptr, ptr + 512); thread q holds voxels 4q .. 4q + 3, one 16-byte load
// or store per field.  A CTA walks kRes0Entries entries in turn; the next
// entry's bpos and ptr (and the index after it) are in flight while the
// current one is fused, and each field of the current one is loaded (rgbp
// too) before its frame samples, so the pool and the frame round trips
// overlap.
__global__ void __launch_bounds__(kRes0Threads, kRes0CtasPerSm)
fused_integrate_res0_kernel(
    const float* __restrict__ depth_img, const int32_t* __restrict__ rgb_img,
    int img_cols, const float* __restrict__ cam,
    const int32_t* __restrict__ bpos, const int32_t* __restrict__ ptr,
    const int64_t* __restrict__ entries, int64_t n_entries,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, int32_t* __restrict__ rgbp,
    float* __restrict__ flags) {
  __shared__ Cam s_cam;
  __shared__ Flags s_flags[2][kRes0Warps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int64_t first = (int64_t)blockIdx.x * kRes0Entries;
  const int n = (int)min((int64_t)kRes0Entries, n_entries - first);
  load_cam(cam, &s_cam);

  const int q = tid * 4;              // the thread's first voxel
  const float offx0 = (float)(q & 7);
  const float offy = (float)((q >> 3) & 7);
  const float offz = (float)(q >> 6);

  int64_t a = entries[first];
  int64_t a_next = n > 1 ? entries[first + 1] : a;
  int3 b = make_int3(bpos[3 * a], bpos[3 * a + 1], bpos[3 * a + 2]);
  int32_t p = ptr[a];
  __syncthreads();
  const Cam& c = s_cam;

  for (int e = 0; e < n; ++e) {
    // the current entry's window, all four fields
    const int64_t off = (int64_t)p + q;
    float4 v_sdf = *reinterpret_cast<const float4*>(sdf + off);
    float4 v_ssq = *reinterpret_cast<const float4*>(sumsq + off);
    int4 v_w = *reinterpret_cast<const int4*>(weight + off);
    int4 v_rgb = *reinterpret_cast<const int4*>(rgbp + off);
    // the next entry's bpos and ptr, and the index after it
    const int3 b_next = make_int3(bpos[3 * a_next], bpos[3 * a_next + 1],
                                  bpos[3 * a_next + 2]);
    const int32_t p_next = ptr[a_next];
    const int64_t a_after = e + 2 < n ? entries[first + e + 2] : a_next;

    const float bx = (float)b.x, by = (float)b.y, bz = (float)b.z;
    float pcz[4], depth[4];
    int32_t pk[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int row, col;
      project(c, bx, by, bz, offx0 + (float)j, offy, offz, pcz[j], row, col,
              ok[j]);
      depth[j] = 0.0f;
      pk[j] = 0;
      if (ok[j]) {
        const int64_t px = (int64_t)row * img_cols + col;
        depth[j] = depth_img[px];
        pk[j] = rgb_img[px];
      }
    }

    float* f_sdf = &v_sdf.x;
    float* f_ssq = &v_ssq.x;
    int32_t* f_w = &v_w.x;
    int32_t* f_rgb = &v_rgb.x;
    bool any = false;
    Flags fl = no_flags();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s;
      if (truncate(c, ok[j], depth[j], pcz[j], s)) {
        combine(c, s, pk[j], f_sdf[j], f_ssq[j], f_w[j], f_rgb[j]);
        any = true;
      }
      fl.add(f_sdf[j], f_ssq[j], f_w[j]);
    }
    if (any) {   // the voxels that did not update are written back as read
      *reinterpret_cast<float4*>(sdf + off) = v_sdf;
      *reinterpret_cast<float4*>(sumsq + off) = v_ssq;
      *reinterpret_cast<int4*>(weight + off) = v_w;
      *reinterpret_cast<int4*>(rgbp + off) = v_rgb;
    }

    // flags: warp shuffles, then the entry's 4 warps (buffers alternate by
    // entry, so one barrier per entry suffices)
    fl.warp_reduce();
    if ((tid & 31) == 0) s_flags[e & 1][warp] = fl;
    __syncthreads();
    if (tid == 0) {
      Flags t = s_flags[e & 1][0];
      for (int k = 1; k < kRes0Warps; ++k) t.add(s_flags[e & 1][k]);
      t.store(flags + 4 * a);
    }
    a = a_next;
    b = b_next;
    p = p_next;
    a_next = a_after;
  }
}

// res 1: a 512-thread CTA takes 8 entries, 64 threads each (a 4^3 lattice
// at twice the voxel spacing, the window [ptr, ptr + 64) that up to 7
// siblings' windows share a row with), one voxel per thread; rgbp is read
// only where the voxel updates
__global__ void __launch_bounds__(kRes1Threads) fused_integrate_res1_kernel(
    const float* __restrict__ depth_img, const int32_t* __restrict__ rgb_img,
    int img_cols, const float* __restrict__ cam,
    const int32_t* __restrict__ bpos, const int32_t* __restrict__ ptr,
    const int64_t* __restrict__ entries, int64_t n_entries,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, int32_t* __restrict__ rgbp,
    float* __restrict__ flags) {
  constexpr int kGroups = kRes1Threads / kRes1Vox;
  constexpr int kGroupWarps = kRes1Vox / 32;
  __shared__ Cam s_cam;
  __shared__ Flags s_flags[kRes1Warps];

  const int tid = threadIdx.x;
  const int local = tid % kRes1Vox;
  const int64_t slot = (int64_t)blockIdx.x * kGroups + tid / kRes1Vox;
  // a group past the last entry stays for the barrier and writes nothing;
  // groups are whole warps, so the shuffles below see uniform warps
  const bool active = slot < n_entries;
  const int64_t a = active ? entries[slot] : 0;
  load_cam(cam, &s_cam);
  __syncthreads();
  const Cam c = s_cam;   // in registers, as the first design held them

  float out_sdf = 0.0f, out_ssq = 0.0f;
  int32_t out_w = 0;
  if (active) {
    int row, col;
    bool ok;
    float pcz;
    project(c, (float)bpos[3 * a + 0], (float)bpos[3 * a + 1],
            (float)bpos[3 * a + 2], (float)((local & 3) * 2),
            (float)(((local >> 2) & 3) * 2), (float)((local >> 4) * 2), pcz,
            row, col, ok);
    float depth = 0.0f;
    int32_t pk = 0;
    if (ok) {
      const int64_t p = (int64_t)row * img_cols + col;
      depth = depth_img[p];
      pk = rgb_img[p];
    }
    const int64_t off = (int64_t)ptr[a] + local;
    out_sdf = sdf[off];
    out_ssq = sumsq[off];
    out_w = weight[off];
    float s;
    if (truncate(c, ok, depth, pcz, s)) {
      int32_t out_rgb = rgbp[off];
      combine(c, s, pk, out_sdf, out_ssq, out_w, out_rgb);
      sdf[off] = out_sdf;
      sumsq[off] = out_ssq;
      weight[off] = out_w;
      rgbp[off] = out_rgb;
    }
  }

  // flags of the entry's window after the update
  Flags fl = no_flags();
  fl.add(out_sdf, out_ssq, out_w);
  fl.warp_reduce();
  const int warp = tid >> 5;
  if ((tid & 31) == 0) s_flags[warp] = fl;
  __syncthreads();
  if (active && local == 0) {   // `warp` is the group's first warp here
    for (int k = 1; k < kGroupWarps; ++k) fl.add(s_flags[warp + k]);
    fl.store(flags + 4 * a);
  }
}

}  // namespace

// Launches K1 on `stream` over the n_entries window entries listed in
// `entries`, all of resolution `res` (0 or 1); returns cudaGetLastError()
// (0 on success).  Pointers: depth f32[H,W], rgb i32[H,W], cam f32[32],
// bpos i32[A,3], ptr i32[A], entries i64[n_entries] (indices into the
// window), pool fields [N,512] (16-byte aligned), flags f32[A,4].  The
// wrapper checks each ptr against the pool and its alignment (512 for res
// 0, 64 for res 1); entries own disjoint windows.
extern "C" int mrhash_fused_integrate_window(
    const void* depth, const void* rgb, int cols, const void* cam,
    const void* bpos, const void* ptr, const void* entries,
    int64_t n_entries, int res, void* sdf, void* sumsq, void* weight,
    void* rgbp, void* flags, void* stream) {
  if (n_entries > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (res == 0) {
      const unsigned grid =
          (unsigned)((n_entries + kRes0Entries - 1) / kRes0Entries);
      fused_integrate_res0_kernel<<<grid, kRes0Threads, 0, s>>>(
          (const float*)depth, (const int32_t*)rgb, cols, (const float*)cam,
          (const int32_t*)bpos, (const int32_t*)ptr, (const int64_t*)entries,
          n_entries, (float*)sdf, (float*)sumsq, (int32_t*)weight,
          (int32_t*)rgbp, (float*)flags);
    } else {
      const unsigned grid = (unsigned)((n_entries + 7) / 8);
      fused_integrate_res1_kernel<<<grid, kRes1Threads, 0, s>>>(
          (const float*)depth, (const int32_t*)rgb, cols, (const float*)cam,
          (const int32_t*)bpos, (const int32_t*)ptr, (const int64_t*)entries,
          n_entries, (float*)sdf, (float*)sumsq, (int32_t*)weight,
          (int32_t*)rgbp, (float*)flags);
    }
  }
  return (int)cudaGetLastError();
}
