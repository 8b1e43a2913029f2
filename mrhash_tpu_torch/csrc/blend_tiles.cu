// K4 / K5: the 3D Gaussian Splatting tile blend, forward and backward.
//
// Replace mrhash_tpu/gs/blend_pallas.py::_fwd_kernel and ::_bwd_kernel
// (the Pallas kernels launched by blend_forward_pallas and
// blend_backward_pallas).  Those kernels walked TILE_BATCH tiles per grid
// step over K-major attribute rows, unrolled by UNROLL, because Mosaic
// needed [b, 256] vector slabs and contiguous per-step row slices in VMEM.
// Here the layout is tile-major ([T, K, 9] attributes, [T, K, 256] mask)
// and each 16x16 tile is one CTA of 256 threads, one per pixel, whose
// pixel coordinates follow from the tile index and the grid width.  The
// tile's K attribute rows are staged once in shared memory; every thread
// then walks them in order with the reference's gates (forward.cu:249-356):
// valid, power <= 0, alpha >= 1/255, T >= 1e-4 and T(1 - alpha) >= 1e-4.
//
// K5 walks k = K-1..0 and recovers the transmittance before step k as
// T_after / (1 - alpha_k) wherever K4's blended bit is set (renderBackwards
// CUDA, backward.cu:386-594; DESIGN D16).  That division needs alpha_k
// bit-identical to K4's, so both kernels compute it in one __device__
// function and the library is built with -fmad=false.  The 9 per-(tile, k)
// gradient sums over the tile's 256 pixels are reduced by warp shuffles;
// each warp's lane 0 stores its partial in shared memory (K x 8 x 9 floats,
// 18 KB at K = 64), and the 8 partials of each sum are added once after
// the walk, so the walk has no barrier per step.
//
// Bound on the card: per valid (tile, k, pixel) ~30 f32 operations (one
// exp) in K4, ~70 in K5; bytes: the attributes, the i8 mask (T x K x 256,
// written by K4 and read by K5), T and C per pixel.  At 1200x680 and
// K = 64 each kernel moves 70-85 MB: K4 is bound by its bytes, K5 by its
// operations, both near the line between the two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per CTA, pixels per tile
constexpr int kWarps = kPix / 32;
constexpr int kAttr = 9;                // x, y, conic a/b/c, opacity, r, g, b
constexpr int kGrad = 9;                // d x, y, conic a/b/c, opacity, r, g, b
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kAlphaMin = 1e-4f;

// Falloff and alpha of one Gaussian at one pixel (forward.cu:300-318),
// evaluated in the same order as the plain twins in gs/blend.py.
__device__ __forceinline__ void alpha_terms(const float* a, float px,
                                            float py, float& dx, float& dy,
                                            float& power, float& e,
                                            float& alpha) {
  dx = a[0] - px;
  dy = a[1] - py;
  power = -0.5f * a[2] * dx * dx - 0.5f * a[4] * dy * dy - a[3] * dx * dy;
  e = expf(power);
  alpha = fminf(0.99f, a[5] * e);
}

__device__ __forceinline__ void stage_attrs(const float* __restrict__ attr,
                                            int tile, int K, float* s) {
  const float* src = attr + (int64_t)tile * K * kAttr;
  for (int i = threadIdx.x; i < K * kAttr; i += kPix) s[i] = src[i];
}

__global__ void __launch_bounds__(kPix) blend_forward_kernel(
    const float* __restrict__ attr, const uint8_t* __restrict__ valid,
    int K, int grid_x, float* __restrict__ tfin, float* __restrict__ cfin,
    int8_t* __restrict__ mask) {
  extern __shared__ float smem[];
  float* sa = smem;                                  // [K, 9]
  uint8_t* sv = (uint8_t*)(smem + K * kAttr);        // [K]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  stage_attrs(attr, t, K, sa);
  for (int k = p; k < K; k += kPix) sv[k] = valid[(int64_t)t * K + k];
  __syncthreads();

  const float px = (float)((t % grid_x) * kBlock + p % kBlock);
  const float py = (float)((t / grid_x) * kBlock + p / kBlock);
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int8_t* m = mask + (int64_t)t * K * kPix + p;
  for (int k = 0; k < K; ++k) {
    const float* a = sa + k * kAttr;
    float dx, dy, power, e, alpha;
    alpha_terms(a, px, py, dx, dy, power, e, alpha);
    const bool use = sv[k] && power <= 0.0f && alpha >= kAlphaThreshold &&
                     T >= kAlphaMin;
    const float test_T = T * (1.0f - alpha);
    const bool blended = use && test_T >= kAlphaMin;
    if (blended) {
      const float w = alpha * T;
      cr = cr + w * a[6];
      cg = cg + w * a[7];
      cb = cb + w * a[8];
      T = test_T;
    }
    m[(int64_t)k * kPix] = blended ? 1 : 0;
  }
  tfin[(int64_t)t * kPix + p] = T;
  float* c = cfin + ((int64_t)t * kPix + p) * 3;
  c[0] = cr;
  c[1] = cg;
  c[2] = cb;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kPix) blend_backward_kernel(
    const float* __restrict__ attr, int K, int grid_x,
    const float* __restrict__ tfin, const int8_t* __restrict__ mask,
    const float* __restrict__ gt, const float* __restrict__ gc,
    float* __restrict__ gout) {
  extern __shared__ float smem[];
  float* sa = smem;                                  // [K, 9]
  float* part = smem + K * kAttr;                    // [K, 8 warps, 9]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  stage_attrs(attr, t, K, sa);
  __syncthreads();

  const float px = (float)((t % grid_x) * kBlock + p % kBlock);
  const float py = (float)((t / grid_x) * kBlock + p / kBlock);
  const int64_t pix = (int64_t)t * kPix + p;
  const float Tfin = tfin[pix];
  const float gT = gt[pix];
  const float gr = gc[pix * 3], gg = gc[pix * 3 + 1], gb = gc[pix * 3 + 2];
  float T_after = Tfin, sr = 0.0f, sg = 0.0f, sb = 0.0f;
  const int8_t* m = mask + (int64_t)t * K * kPix + p;
  for (int k = K - 1; k >= 0; --k) {
    const float* a = sa + k * kAttr;
    float dx, dy, power, e, alpha;
    alpha_terms(a, px, py, dx, dy, power, e, alpha);
    const bool bl = m[(int64_t)k * kPix] != 0;
    const float one_m = bl ? 1.0f - alpha : 1.0f;
    const float T_before = T_after / one_m;
    const float w = bl ? alpha * T_before : 0.0f;

    const float gdot_rgb = gr * a[6] + gg * a[7] + gb * a[8];
    const float gdot_S = gr * sr + gg * sg + gb * sb;
    const float d_alpha =
        bl ? gdot_rgb * T_before - (gdot_S + gT * Tfin) / one_m : 0.0f;
    // alpha = min(0.99, opacity * e^power): clamped pixels get no gradient
    const bool live = a[5] * e < 0.99f;
    const float d_op = live ? d_alpha * e : 0.0f;
    const float d_power = live ? d_alpha * alpha : 0.0f;

    float g[kGrad];
    g[0] = d_power * (-a[2] * dx - a[3] * dy);
    g[1] = d_power * (-a[4] * dy - a[3] * dx);
    g[2] = d_power * (-0.5f * dx * dx);
    g[3] = d_power * (-dx * dy);
    g[4] = d_power * (-0.5f * dy * dy);
    g[5] = d_op;
    g[6] = gr * w;
    g[7] = gg * w;
    g[8] = gb * w;
#pragma unroll
    for (int j = 0; j < kGrad; ++j) {
      const float s = warp_sum(g[j]);
      if (lane == 0) part[(k * kWarps + warp) * kGrad + j] = s;
    }

    sr = sr + w * a[6];
    sg = sg + w * a[7];
    sb = sb + w * a[8];
    T_after = T_before;
  }
  __syncthreads();
  float* out = gout + (int64_t)t * K * kGrad;
  for (int i = p; i < K * kGrad; i += kPix) {
    const int k = i / kGrad, j = i % kGrad;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[(k * kWarps + w) * kGrad + j];
    out[i] = s;
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Launches K4 on `stream`; returns cudaGetLastError() (0 on success).
// attr f32[T,K,9]; valid u8[T,K] (torch.bool); out: tfin f32[T,256],
// cfin f32[T,256,3], mask i8[T,K,256].  Tile t covers pixels
// x = (t % grid_x) * 16 + p % 16, y = (t / grid_x) * 16 + p / 16.
extern "C" int mrhash_blend_forward(const void* attr, const void* valid,
                                    int n_tiles, int K, int grid_x,
                                    void* tfin, void* cfin, void* mask,
                                    void* stream) {
  if (n_tiles > 0) {
    const size_t smem = (size_t)K * kAttr * sizeof(float) + (size_t)K;
    const int rc = set_smem((const void*)blend_forward_kernel, smem);
    if (rc != 0) return rc;
    blend_forward_kernel<<<n_tiles, kPix, smem, (cudaStream_t)stream>>>(
        (const float*)attr, (const uint8_t*)valid, K, grid_x, (float*)tfin,
        (float*)cfin, (int8_t*)mask);
  }
  return (int)cudaGetLastError();
}

// Launches K5 on `stream`; returns cudaGetLastError() (0 on success).
// attr f32[T,K,9]; tfin f32[T,256] and mask i8[T,K,256] from K4; gt
// f32[T,256] and gc f32[T,256,3], the cotangents of tfin and cfin; out:
// gout f32[T,K,9], the gradient of attr.
extern "C" int mrhash_blend_backward(const void* attr, int n_tiles, int K,
                                     int grid_x, const void* tfin,
                                     const void* mask, const void* gt,
                                     const void* gc, void* gout,
                                     void* stream) {
  if (n_tiles > 0) {
    const size_t smem = (size_t)K * (kAttr + kWarps * kGrad) * sizeof(float);
    const int rc = set_smem((const void*)blend_backward_kernel, smem);
    if (rc != 0) return rc;
    blend_backward_kernel<<<n_tiles, kPix, smem, (cudaStream_t)stream>>>(
        (const float*)attr, K, grid_x, (const float*)tfin,
        (const int8_t*)mask, (const float*)gt, (const float*)gc,
        (float*)gout);
  }
  return (int)cudaGetLastError();
}
