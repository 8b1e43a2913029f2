// K3: fused projective LiDAR update over the compacted block window, both
// resolutions in one launch.
//
// Replaces mrhash_tpu/ops/fused_integrate.py::_kernel_sph (plain branch and
// packed res-1 branch), the Pallas kernel launched by
// fused_integrate_points_pallas.  The kernel works per window ENTRY and
// writes each entry's window [ptr, ptr + 512) (res 0) or [ptr, ptr + 64)
// (res 1, a window of a row its siblings share) in place.  Entries own
// disjoint windows, so no two threads write the same voxel, and the TPU's
// row packing has no counterpart.  The spherical projection (atan2/asin)
// runs before the launch, in kernel K14 on the card (csrc/scan_raster.cu,
// bit-equal to its torch twin there; PORT_NOTES.md P15), so the kernel and
// its plain twin ops/fused_integrate_points.py::fused_integrate_points_rows_ref
// see the same per-lane (pix, r_vox) and no libdevice/libm ulp difference
// can move a voxel to another pixel.  For each voxel, the twin's f32
// operations in its order:
//   1. the f32 range at the voxel's own pixel of the unpadded min-range
//      image (no 3-channel bf16 split, no one-hot MXU sampling, no
//      1/2048 m quantisation, no patch window: P13, P14);
//   2. the projective update gated on the truncation band on both sides,
//      pix >= 0 & r_px > 0 & r_px <= max_int & -trunc < sdf < trunc, so
//      nothing is carved (the reference's deviation D19);
//   3. the reference 3D kernel's Welford quirk: curr_mean is 0 for
//      never-touched voxels (fused_integrate.py:661-667).  rgbp is not
//      touched.
// Each entry then reduces its flags over its own window (window_flags.cuh).
//
// What holds it back is latency, not bytes: each voxel is a chain of
// dependent round trips (entry -> ptr and pix -> img -> the pool), and a
// multi-res window is a few thousand entries, under a wave of the card.
// So (each choice timed on the card against the others in one call,
// PERF.md):
//   - one launch serves both resolutions: the wrapper's entry list holds
//     the n0 res-0 entries first; CTA b < n0 is res-0 entry b, the rest
//     take kRes1Entries res-1 entries each;
//   - a res-0 thread moves 2 consecutive voxels per 8-byte access of pix,
//     r_vox, sdf, sumsq and weight (1 per access timed 30 % slower; 4 per
//     16-byte access as fast alone but 27 % slower on a multi-res window,
//     whose ~130 res-0 entries set its tail); a res-1 thread moves one
//     voxel (2 or 4 timed 12-25 % slower: few entries fill the card with
//     little work per thread only this way); rows are 2 KB and windows
//     start at multiples of 64 lanes, so every access is aligned (the
//     wrapper checks the bases);
//   - all five loads are issued as soon as ptr is known, the range
//     gathers right after pix; a thread whose voxels include an update
//     writes them all back (the others as read), invisible since entries
//     own their windows (P43, P45);
//   - the flags take a per-thread sum, shuffles over the warp, then the
//     entry's warps through shared memory, one barrier per CTA.
//
// Bound: bytes.  Per voxel of the window 16 B read (pix, r_vox, sdf,
// weight), per weighted voxel 4 B more (sumsq) and 12 B written per
// updated voxel; the range image (256 KB at 64x1024) stays in L2.  The
// kernel reads sumsq for every voxel and writes whole voxel pairs at res
// 0, more than that count, for fewer dependent round trips.
//
// Build: -fmad=false and no fast math (see ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_flags.cuh"

namespace {

constexpr int kLanes = 512;          // lanes per row of pix / r_vox
constexpr int kThreads = 256;        // CTA: one res-0 entry, or res-1 ones
constexpr int kRes0Vec = kLanes / kThreads;   // voxels per thread, res 0
constexpr int kRes1Vec = 1;                   // voxels per thread, res 1
constexpr int kRes1Threads = 64 / kRes1Vec;   // threads per res-1 entry
constexpr int kRes1Entries = kThreads / kRes1Threads;   // per CTA

struct Consts {
  float t0, t1, max_int, w_samp, w_max, vvs;
};

// V consecutive values of T in one access
template <class T, int V> struct Packed;
template <> struct Packed<float, 1> { using type = float; };
template <> struct Packed<float, 2> { using type = float2; };
template <> struct Packed<int32_t, 1> { using type = int32_t; };
template <> struct Packed<int32_t, 2> { using type = int2; };

template <int V, class T>
__device__ __forceinline__ void load_v(const T* __restrict__ p, T (&v)[V]) {
  const auto q = *reinterpret_cast<const typename Packed<T, V>::type*>(p);
  memcpy(v, &q, sizeof(q));
}

template <int V, class T>
__device__ __forceinline__ void store_v(T* __restrict__ p, const T (&v)[V]) {
  typename Packed<T, V>::type q;
  memcpy(&q, v, sizeof(q));
  *reinterpret_cast<typename Packed<T, V>::type*>(p) = q;
}

// The projective update of one voxel at range r_px (0 off the image) on
// its pool values; returns whether it updated.  The twin's operations in
// its order.
__device__ __forceinline__ bool update_voxel(const Consts& c, int32_t p,
                                             float r_px, float rv,
                                             float& sdf, float& ssq,
                                             int32_t& w) {
  float s = r_px - rv;
  const float trunc = c.t0 + c.t1 * r_px;
  const bool update = p >= 0 && r_px > 0.0f && r_px <= c.max_int &&
                      s > -trunc && s < trunc;
  if (!update) return false;
  s = fminf(fmaxf(s, -trunc), trunc);
  const float sdf0 = sdf;
  const float w0f = (float)w;
  const float half = c.vvs * 0.5f;
  const float curr_mean = (w > 0) ? sdf0 : 0.0f;
  const float delta = (s - curr_mean) / half;
  const float m_sdf = (sdf0 * w0f + s * c.w_samp) / (w0f + c.w_samp);
  const float delta2 = (s - m_sdf) / half;
  sdf = m_sdf;
  ssq = ssq + delta * delta2;
  w = (int32_t)fminf(c.w_max, w0f + c.w_samp);
  return true;
}

// V consecutive voxels of one entry: lanes [row, row + V) of pix / r_vox
// and pool voxels [off, off + V).  The five loads are issued together,
// then the V range gathers; the group is written back where any voxel
// updated.  Returns the group's flags.
template <int V>
__device__ __forceinline__ Flags update_group(
    const Consts& c, const float* __restrict__ img,
    const int32_t* __restrict__ pix, const float* __restrict__ r_vox,
    int64_t row, int64_t off, float* __restrict__ sdf,
    float* __restrict__ sumsq, int32_t* __restrict__ weight) {
  int32_t p[V], w[V];
  float rv[V], sd[V], sq[V], r_px[V];
  load_v<V>(pix + row, p);
  load_v<V>(r_vox + row, rv);
  load_v<V>(sdf + off, sd);
  load_v<V>(sumsq + off, sq);
  load_v<V>(weight + off, w);
#pragma unroll
  for (int j = 0; j < V; ++j) r_px[j] = (p[j] >= 0) ? img[p[j]] : 0.0f;
  bool any = false;
  Flags fl = no_flags();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    any |= update_voxel(c, p[j], r_px[j], rv[j], sd[j], sq[j], w[j]);
    fl.add(sd[j], sq[j], w[j]);
  }
  if (any) {   // the voxels that did not update are written back as read
    store_v<V>(sdf + off, sd);
    store_v<V>(sumsq + off, sq);
    store_v<V>(weight + off, w);
  }
  return fl;
}

// An entry's flags from its G threads' (consecutive, from a multiple of
// G): shuffles within the warp, then through shared memory across the
// entry's warps; the entry's first thread stores them.
template <int G>
__device__ __forceinline__ void entry_flags(Flags fl, bool active,
                                            int64_t a, Flags* s_flags,
                                            float* __restrict__ flags) {
  fl.reduce<(G < 32 ? G : 32)>();
  const int tid = threadIdx.x;
  if constexpr (G > 32) {
    if ((tid & 31) == 0) s_flags[tid >> 5] = fl;
    __syncthreads();
    if (active && tid % G == 0)
      for (int k = 1; k < G / 32; ++k) fl.add(s_flags[(tid >> 5) + k]);
  }
  if (active && tid % G == 0) fl.store(flags + 4 * a);
}

__global__ void __launch_bounds__(kThreads) fused_integrate_points_kernel(
    const float* __restrict__ img, const int32_t* __restrict__ pix,
    const float* __restrict__ r_vox, const int32_t* __restrict__ ptr,
    const int64_t* __restrict__ entries, int64_t n0, int64_t n1, Consts c,
    float* __restrict__ sdf, float* __restrict__ sumsq,
    int32_t* __restrict__ weight, float* __restrict__ flags) {
  __shared__ Flags s_flags[kThreads / 32];
  const int tid = threadIdx.x;
  if (blockIdx.x < n0) {
    // res 0: the CTA is one entry, kRes0Vec voxels per thread of its 8^3
    // row
    const int64_t a = entries[blockIdx.x];
    const int q = tid * kRes0Vec;
    const Flags fl = update_group<kRes0Vec>(
        c, img, pix, r_vox, a * kLanes + q, (int64_t)ptr[a] + q, sdf, sumsq,
        weight);
    entry_flags<kThreads>(fl, true, a, s_flags, flags);
    return;
  }
  // res 1: kRes1Entries entries of kRes1Threads threads, kRes1Vec voxels
  // each, of the entry's 64-lane window; a group past the last entry adds
  // no flags and writes nothing
  const int j = (tid % kRes1Threads) * kRes1Vec;
  const int64_t slot =
      n0 + (blockIdx.x - n0) * kRes1Entries + tid / kRes1Threads;
  const bool active = slot < n0 + n1;
  Flags fl = no_flags();
  int64_t a = 0;
  if (active) {
    a = entries[slot];
    fl = update_group<kRes1Vec>(c, img, pix, r_vox, a * kLanes + j,
                                (int64_t)ptr[a] + j, sdf, sumsq, weight);
  }
  entry_flags<kRes1Threads>(fl, active, a, s_flags, flags);
}

// The same grid and block with no work: the launch floor of a grid.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

unsigned grid(int64_t n0, int64_t n1) {
  return (unsigned)(n0 + (n1 + kRes1Entries - 1) / kRes1Entries);
}

}  // namespace

// Launches K3 on `stream` over the n0 + n1 window entries listed in
// `entries`: n0 res-0 entries, then n1 res-1 entries; returns
// cudaGetLastError() (0 on success).  Pointers: img f32[H,W], pix
// i32[A,512] (row * W + col, or -1; a res-1 entry's lanes 0..63), r_vox
// f32[A,512], ptr i32[A], entries i64[n0 + n1], pool fields [N,512],
// flags f32[A,4]; pix, r_vox and the pool fields 8-byte aligned.  The
// wrapper checks -1 <= pix < H*W, each ptr against the pool and its
// alignment, and the bases; entries own disjoint windows.
extern "C" int mrhash_fused_integrate_points_window(
    const void* img, const void* pix, const void* r_vox, const void* ptr,
    const void* entries, int64_t n0, int64_t n1, float t0, float t1,
    float max_int, float w_samp, float w_max, float vvs, void* sdf,
    void* sumsq, void* weight, void* flags, void* stream) {
  if (n0 + n1 > 0) {
    fused_integrate_points_kernel<<<grid(n0, n1), kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)img, (const int32_t*)pix, (const float*)r_vox,
        (const int32_t*)ptr, (const int64_t*)entries, n0, n1,
        Consts{t0, t1, max_int, w_samp, w_max, vvs}, (float*)sdf,
        (float*)sumsq, (int32_t*)weight, (float*)flags);
  }
  return (int)cudaGetLastError();
}

// Launches an empty kernel over K3's grid for n0 res-0 and n1 res-1
// entries on `stream` (the floor a launch of that grid costs); returns
// cudaGetLastError().
extern "C" int mrhash_fused_integrate_points_floor(int64_t n0, int64_t n1,
                                                   void* stream) {
  if (n0 + n1 > 0)
    empty_kernel<<<grid(n0, n1), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
