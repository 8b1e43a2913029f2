// K13: a LiDAR scan's elevation mapping and its min-range raster; K14:
// the spherical projection of every lane of the compacted block window.
//
// Replace the torch ops of ops/scan_raster.py's twins (scan_raster_mapping
// + rasterize_scan, project_window_sph), which were ~145 eager launches a
// scan, with four launches and no host read.  K3
// (csrc/fused_integrate_points.cu) takes their operands unchanged: the
// range image f32[rows, cols] (0 where no return), and each window lane's
// pixel pix i32[A,512] (row * cols + col, or -1) and camera range r_vox
// f32[A,512].
//
// Bit-equal to the twins run on the card.  Every product, sum, quotient
// and square root below is one of the __f*_rn intrinsics, which are
// rounded on their own and never contracted, in the twin's order: torch
// runs each of them as a kernel of its own.  atan2f and asinf are
// libdevice's, as torch's atan2 and asin kernels call them (PORT_NOTES.md
// P15 says how this was checked on the card).  Torch's Python scalars are
// f32 (math.pi, cols / 2 pi, 1e-6, 0.5), its float -> int32 casts truncate
// toward zero and saturate (__float2int_rz), its clamp keeps a NaN, and
// `(rows - 1) / t` is t.reciprocal() * (rows - 1).
//
// K13, three launches:
//   1. raster_prepare: the image cleared to +inf; each point's elevation
//      where its range exceeds 1e-6, reduced to the CTA's min and max as
//      order-preserving int keys, one pair a CTA;
//   2. raster_scatter: every CTA reduces the pairs to the mapping (el_lo,
//      s_el; CTA 0 stores it for K14), then each point's (row, col) and
//      range; an in-rows point within [min_depth, max_depth] takes the
//      min range into its pixel by atomicMin on the float's bits (ranges
//      are not negative, so their bits order as they do);
//   3. raster_finish: the +inf left in empty pixels turned into 0, four
//      pixels a thread.  (Left to raster_scatter's last CTA alone, the
//      clear held K13 at 28.6 us a 64x1024 scan on an H100, against 12.9
//      us as a launch of its own.)
// K14, one launch of a thread per window lane: the lane's virtual voxel
// (the 8^3 lattice at res 0, the 4^3 lattice at twice the spacing at res
// 1, lanes past 64 clamped to voxel 63 as the twin's), to world and camera
// coordinates, its range, and where the lane is a voxel within the depth
// range its atan2 / asin pixel under the mapping.
//
// Bound: bytes, and latency at these sizes.  K13 reads 12 B a point and
// writes the 4 B a pixel image twice (256 KB at 64x1024); K14 reads 16 B an
// entry and writes 8 B a lane.  Build: -fmad=false and no fast math (see
// ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 512;          // lanes of a window entry
constexpr int kThreads = 256;
constexpr int kMaxCtas = 1024;       // K13's grid cap (its grid strides)
constexpr int kInfBits = 0x7f800000; // +inf
constexpr float kPi = 3.14159265358979323846f;   // math.pi as f32

// aux i32[mrhash_raster_scan_aux_words()]: the mapping (el_lo, s_el as
// f32 bits), then one (min, max) key pair per raster_prepare CTA
constexpr int kMap = 0, kParts = 2;

// float -> int key whose signed order is the float order (no NaN)
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// coords.norm3: sqrt(x * x + y * y + z * z), summed in order
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z)));
}

struct Sph {
  int rows, cols;
  float col_scale;     // cols / (2 pi) as f32
};

// _sph_rowcol's (row, col) of a camera-frame point at range rng under the
// mapping; returns whether the row lies in the image
__device__ __forceinline__ bool sph_rowcol(const Sph& s, float x, float y,
                                           float z, float rng, float el_lo,
                                           float s_el, int& row, int& col) {
  const float safe = (rng == 0.0f) ? 1.0f : rng;
  const float az = atan2f(y, x);
  const float el = asinf(clamp_nan(__fdiv_rn(z, safe), -1.0f, 1.0f));
  const float colf = __fmul_rn(__fadd_rn(az, kPi), s.col_scale);
  col = min(max(__float2int_rz(colf), 0), s.cols - 1);
  row = __float2int_rz(
      floorf(__fadd_rn(__fmul_rn(__fsub_rn(el, el_lo), s_el), 0.5f)));
  return row >= 0 && row < s.rows;
}

// the CTA's min and max of (lo, hi); thread 0 ends with them
__device__ __forceinline__ void cta_min_max(int& lo, int& hi) {
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    s_lo[tid >> 5] = lo;
    s_hi[tid >> 5] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      lo = min(lo, s_lo[k]);
      hi = max(hi, s_hi[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) raster_prepare_kernel(
    const float* __restrict__ pts, int64_t n, int64_t hw,
    int* __restrict__ img, int* __restrict__ aux) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = t; i < hw; i += stride) img[i] = kInfBits;
  int lo = order_key(__int_as_float(kInfBits));
  int hi = order_key(-__int_as_float(kInfBits));
  for (int64_t i = t; i < n; i += stride) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float rng = norm3(x, y, z);
    const bool ok = rng > 1e-6f;
    const float el =
        asinf(clamp_nan(__fdiv_rn(z, ok ? rng : 1.0f), -1.0f, 1.0f));
    if (ok) {
      lo = min(lo, order_key(el));
      hi = max(hi, order_key(el));
    }
  }
  cta_min_max(lo, hi);
  if (threadIdx.x == 0) {
    aux[kParts + 2 * blockIdx.x] = lo;
    aux[kParts + 2 * blockIdx.x + 1] = hi;
  }
}

__global__ void __launch_bounds__(kThreads) raster_scatter_kernel(
    const float* __restrict__ pts, int64_t n, Sph s,
    const float* __restrict__ min_d, const float* __restrict__ max_d,
    int n_parts, int* __restrict__ img, int* __restrict__ aux) {
  __shared__ float s_map[2];
  const int tid = threadIdx.x;
  // the mapping (scan_raster_mapping): the elevation span of the returns
  int lo = order_key(__int_as_float(kInfBits));
  int hi = order_key(-__int_as_float(kInfBits));
  for (int j = tid; j < n_parts; j += kThreads) {
    lo = min(lo, aux[kParts + 2 * j]);
    hi = max(hi, aux[kParts + 2 * j + 1]);
  }
  cta_min_max(lo, hi);
  if (tid == 0) {
    // no return: an infinite min and max, taken as -1 and 1
    const float el_lo =
        lo == order_key(__int_as_float(kInfBits)) ? -1.0f : key_float(lo);
    const float el_hi =
        hi == order_key(-__int_as_float(kInfBits)) ? 1.0f : key_float(hi);
    const float span = fmaxf(__fsub_rn(el_hi, el_lo), 1e-6f);
    s_map[0] = el_lo;
    s_map[1] = __fmul_rn(__frcp_rn(span), (float)(s.rows - 1));
    if (blockIdx.x == 0) {
      aux[kMap] = __float_as_int(s_map[0]);
      aux[kMap + 1] = __float_as_int(s_map[1]);
    }
  }
  __syncthreads();
  const float el_lo = s_map[0], s_el = s_map[1];
  const float d_lo = *min_d, d_hi = *max_d;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n; i += stride) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float rng = norm3(x, y, z);
    int row, col;
    const bool in_rows = sph_rowcol(s, x, y, z, rng, el_lo, s_el, row, col);
    if (in_rows && rng >= d_lo && rng <= d_hi)
      atomicMin(img + (int64_t)row * s.cols + col, __float_as_int(rng));
  }
}

// what no point reached (+inf) to 0, four pixels a thread
__global__ void __launch_bounds__(kThreads) raster_finish_kernel(
    int* __restrict__ img, int64_t hw) {
  const int64_t i = 4 * ((int64_t)blockIdx.x * kThreads + threadIdx.x);
  if (i + 4 <= hw) {
    int4 v = *reinterpret_cast<const int4*>(img + i);
    v.x = v.x == kInfBits ? 0 : v.x;
    v.y = v.y == kInfBits ? 0 : v.y;
    v.z = v.z == kInfBits ? 0 : v.z;
    v.w = v.w == kInfBits ? 0 : v.w;
    *reinterpret_cast<int4*>(img + i) = v;
  } else {
    for (int64_t j = i; j < hw; ++j)
      if (img[j] == kInfBits) img[j] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) project_window_kernel(
    const int32_t* __restrict__ bpos, const int32_t* __restrict__ bres,
    int64_t n_lanes, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ min_d,
    const float* __restrict__ max_d, const float* __restrict__ map,
    float vvs, Sph s, int32_t* __restrict__ pix,
    float* __restrict__ r_vox) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_lanes) return;
  const int64_t a = g / kLanes;
  const int v = (int)(g % kLanes);
  // the lane's voxel offset in its block (_block_voxel_grid)
  const bool low = bres[a] == 1;
  int off[3];
  if (low) {
    const int l = min(v, 63);
    off[0] = (l % 4) * 2;
    off[1] = (l % 16 / 4) * 2;
    off[2] = (l / 16) * 2;
  } else {
    off[0] = v % 8;
    off[1] = v % 64 / 8;
    off[2] = v / 64;
  }
  // virtual voxel -> world -> camera (world_to_cam: (p - t) @ rot, summed
  // over k = 0, 1, 2)
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int pi = (int)((uint32_t)bpos[3 * a + k] * 8u + (uint32_t)off[k]);
    d[k] = __fsub_rn(__fmul_rn(__int2float_rn(pi), vvs), trans[k]);
  }
  float pc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    pc[j] = __fadd_rn(__fadd_rn(__fmul_rn(d[0], rot[j]),
                                __fmul_rn(d[1], rot[3 + j])),
                      __fmul_rn(d[2], rot[6 + j]));
  const float rng = norm3(pc[0], pc[1], pc[2]);
  int p = -1;
  // a lane of no voxel, or out of the depth range, takes no pixel: its
  // row and column are not needed
  if (v < (low ? 64 : kLanes) && rng >= *min_d && rng <= *max_d) {
    int row, col;
    if (sph_rowcol(s, pc[0], pc[1], pc[2], rng, map[0], map[1], row, col))
      p = row * s.cols + col;
  }
  pix[g] = p;
  r_vox[g] = rng;
}

int64_t ctas(int64_t n) { return (n + kThreads - 1) / kThreads; }

// K13's grids: at least one CTA, at most kMaxCtas
int raster_ctas(int64_t n) {
  const int64_t c = ctas(n);
  return (int)(c < 1 ? 1 : (c > kMaxCtas ? kMaxCtas : c));
}

}  // namespace

// The size of K13's aux buffer, in 4-byte words.
extern "C" int mrhash_raster_scan_aux_words() {
  return kParts + 2 * kMaxCtas;
}

// Launches K13's three kernels on `stream` over n camera-frame points:
// pts f32[n,3]; the image img f32[rows, cols] (16-byte aligned) and the
// mapping (aux's first two words, f32 el_lo and s_el) are written; aux
// i32[mrhash_raster_scan_aux_words()] is scratch; min_d and max_d are the
// camera's f32 depth range on the card.  Returns cudaGetLastError() (0 on
// success).
extern "C" int mrhash_raster_scan(const void* pts, int64_t n, int rows,
                                  int cols, float col_scale,
                                  const void* min_d, const void* max_d,
                                  void* img, void* aux, void* stream) {
  const int64_t hw = (int64_t)rows * cols;
  // the clear takes 4 pixels a thread at least
  const int g_prep = raster_ctas(n > hw / 4 ? n : hw / 4);
  const int g_scat = raster_ctas(n);
  const cudaStream_t st = (cudaStream_t)stream;
  raster_prepare_kernel<<<g_prep, kThreads, 0, st>>>(
      (const float*)pts, n, hw, (int*)img, (int*)aux);
  raster_scatter_kernel<<<g_scat, kThreads, 0, st>>>(
      (const float*)pts, n, Sph{rows, cols, col_scale},
      (const float*)min_d, (const float*)max_d, g_prep, (int*)img,
      (int*)aux);
  raster_finish_kernel<<<(unsigned)ctas((hw + 3) / 4), kThreads, 0, st>>>(
      (int*)img, hw);
  return (int)cudaGetLastError();
}

// Launches K14 on `stream` over the n_entries window entries: bpos
// i32[A,3] and bres i32[A]; the camera's rot f32[3,3] (cam -> world),
// trans f32[3] and depth range, and K13's mapping f32[2], all on the
// card; pix i32[A,512] and r_vox f32[A,512] written.  Returns
// cudaGetLastError() (0 on success).
extern "C" int mrhash_project_window(const void* bpos, const void* bres,
                                     int64_t n_entries, const void* rot,
                                     const void* trans, const void* min_d,
                                     const void* max_d, const void* map,
                                     float vvs, int rows, int cols,
                                     float col_scale, void* pix,
                                     void* r_vox, void* stream) {
  const int64_t n_lanes = n_entries * kLanes;
  if (n_lanes > 0) {
    project_window_kernel<<<(unsigned)ctas(n_lanes), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t*)bpos, (const int32_t*)bres, n_lanes,
        (const float*)rot, (const float*)trans, (const float*)min_d,
        (const float*)max_d, (const float*)map, vvs,
        Sph{rows, cols, col_scale}, (int32_t*)pix, (float*)r_vox);
  }
  return (int)cudaGetLastError();
}
