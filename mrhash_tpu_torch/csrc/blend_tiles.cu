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
// function and the library is built with -fmad=false.  K5's walk is shaped
// by what it does per step for each warp:
//   - it starts at the tile's last valid slot (valid is a prefix per tile
//     on the rasterizer's path, and K4 blends no invalid slot), so the
//     rows past it are written as zeros without a walk;
//   - before the walk each warp packs K4's i8 mask rows (8 B per lane) into
//     one 32-bit word per (k, warp) in shared memory, so the walk reads no
//     global memory;
//   - a warp whose word is 0 at step k skips the step and stores zero
//     partials: T_before = T_after / 1 and S + 0 * rgb are unchanged and
//     every gradient term is 0 * finite, so the skip is exact;
//   - otherwise the 9 gradient sums over the warp's 32 pixels take a
//     transpose (reduce-scatter) butterfly, 12 shuffles instead of 45, and
//     9 lanes store the warp's partials with one instruction.
// The attributes sit in shared memory in 48-byte rows (three 16-byte
// loads per step); the walk has no barrier per step, and the 8 warp
// partials of each sum (K x 8 x 9 floats, 37 KB at K = 128) are added in
// warp order once after it.
//
// Bound on the card: per valid (tile, k, pixel) ~30 f32 operations (one
// exp) in K4, ~70 in K5; bytes: the attributes, the i8 mask (T x K x 256,
// written by K4 and read by K5), T and C per pixel.  At 1200x680 and
// K = 64 each kernel moves 70-85 MB: K4 is bound by its bytes, K5 by its
// operations, both near the line between the two.  With -fmad=false no
// multiply and add fuse, so K5's instruction issue, not its memory, is
// what the design above cuts: the shuffles (a quarter-rate pipe) and the
// steps in which a warp has nothing to add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per CTA, pixels per tile
constexpr int kWarps = kPix / 32;
constexpr int kAttr = 9;                // x, y, conic a/b/c, opacity, r, g, b
constexpr int kGrad = 9;                // d x, y, conic a/b/c, opacity, r, g, b
constexpr int kRow = 12;                // K5's attribute rows, padded to 48 B
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

// The blended bits of one step for the eight 32-pixel warps of a tile, read
// from K4's i8 mask row (256 B) by one warp, 8 B per lane: lane l covers
// pixels 8l .. 8l + 7, which are byte l % 4 of warp l / 4's 32-bit word.
// `bits` is [8] words; bit i of word w is pixel 32 w + i.
__device__ __forceinline__ void pack_mask_row(const int8_t* __restrict__ row,
                                              int lane, uint32_t* bits) {
  const uint2 v = *reinterpret_cast<const uint2*>(row + lane * 8);
  uint32_t b = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b |= ((v.x >> (8 * i)) & 0xffu) ? (1u << i) : 0u;
    b |= ((v.y >> (8 * i)) & 0xffu) ? (1u << (4 + i)) : 0u;
  }
  reinterpret_cast<uint8_t*>(bits)[lane] = (uint8_t)b;
}

// Which of the 9 sums lane 2q (and 2q + 1) holds after reduce9: 4 bits per
// q, 0xf for none.
constexpr uint64_t kReduceSlot = 0xfff8f765ff43f210ull;

// Sums each of the 9 values over the warp's 32 lanes with 12 shuffles, a
// transpose (reduce-scatter) butterfly: at each halving of the lane
// distance a lane keeps about half of its values and adds its partner's
// copies of those.  Lane l returns the total of value
// (kReduceSlot >> 4 (l >> 1)) & 0xf; other lanes return a partial sum.
__device__ __forceinline__ float reduce9(const float (&v)[kGrad], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  float a[5];   // lanes 0-15: values 0-4; lanes 16-31: values 5-8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h16 ? v[i] : v[5 + i];
    a[i] = (h16 ? v[5 + i] : v[i]) + __shfl_xor_sync(kAll, send, 16);
  }
  a[4] = v[4] + __shfl_xor_sync(kAll, v[4], 16);
  float b[3];   // bit 3 clear: slots 0-2 of a; set: slots 3-4
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h8 ? a[i] : a[3 + i];
    b[i] = (h8 ? a[3 + i] : a[i]) + __shfl_xor_sync(kAll, send, 8);
  }
  b[2] = a[2] + __shfl_xor_sync(kAll, a[2], 8);
  float c[2];   // bit 2 clear: slots 0-1 of b; set: slot 2
  c[0] = (h4 ? b[2] : b[0]) + __shfl_xor_sync(kAll, h4 ? b[0] : b[2], 4);
  c[1] = b[1] + __shfl_xor_sync(kAll, b[1], 4);
  // bit 1 clear: slot 0 of c; set: slot 1
  const float d =
      (h2 ? c[1] : c[0]) + __shfl_xor_sync(kAll, h2 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(kAll, d, 1);
}

__global__ void __launch_bounds__(kPix) blend_backward_kernel(
    const float* __restrict__ attr, const uint8_t* __restrict__ valid, int K,
    int grid_x, const float* __restrict__ tfin,
    const int8_t* __restrict__ mask, const float* __restrict__ gt,
    const float* __restrict__ gc, float* __restrict__ gout) {
  extern __shared__ float4 smem16[];                 // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem16);
  float* sa = smem;                                  // [K, 12]
  float* part = smem + K * kRow;                     // [K, 8 warps, 9]
  uint32_t* sbits = (uint32_t*)(part + K * kWarps * kGrad);   // [K, 8]
  __shared__ int s_count;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;

  // the walk starts at the tile's last valid slot: K4 blends no invalid
  // one, so every row past it is zero
  if (p == 0) s_count = 0;
  __syncthreads();
  int last = 0;
  for (int k = p; k < K; k += kPix)
    if (valid[(int64_t)t * K + k]) last = k + 1;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last > 0) atomicMax(&s_count, last);
  __syncthreads();
  const int count = s_count;

  const float* src = attr + (int64_t)t * K * kAttr;
  for (int i = p; i < count * kAttr; i += kPix)
    sa[(i / kAttr) * kRow + i % kAttr] = src[i];
  const int8_t* m = mask + (int64_t)t * K * kPix;
  for (int k = warp; k < count; k += kWarps)
    pack_mask_row(m + (int64_t)k * kPix, lane, sbits + k * kWarps);
  __syncthreads();

  const float px = (float)((t % grid_x) * kBlock + p % kBlock);
  const float py = (float)((t / grid_x) * kBlock + p / kBlock);
  const int64_t pix = (int64_t)t * kPix + p;
  const float Tfin = tfin[pix];
  const float gT = gt[pix];
  const float gr = gc[pix * 3], gg = gc[pix * 3 + 1], gb = gc[pix * 3 + 2];
  // the sum this lane stores after reduce9 (>= kGrad: none)
  const int slot =
      (lane & 1) ? kGrad : (int)((kReduceSlot >> (4 * (lane >> 1))) & 0xf);
  float T_after = Tfin, sr = 0.0f, sg = 0.0f, sb = 0.0f;
  for (int k = count - 1; k >= 0; --k) {
    float* dst = part + (k * kWarps + warp) * kGrad;
    const uint32_t bits = sbits[k * kWarps + warp];
    if (bits == 0) {
      // no pixel of the warp blended step k: T, S and every gradient term
      // are unchanged or zero, exactly
      if (slot < kGrad) dst[slot] = 0.0f;
      continue;
    }
    const float4* row = reinterpret_cast<const float4*>(sa + k * kRow);
    const float4 q0 = row[0], q1 = row[1], q2 = row[2];
    const float a[kAttr] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                            q1.y, q1.z, q1.w, q2.x};
    float dx, dy, power, e, alpha;
    alpha_terms(a, px, py, dx, dy, power, e, alpha);
    const bool bl = (bits >> lane) & 1u;
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

    const float g[kGrad] = {d_power * (-a[2] * dx - a[3] * dy),
                            d_power * (-a[4] * dy - a[3] * dx),
                            d_power * (-0.5f * dx * dx),
                            d_power * (-dx * dy),
                            d_power * (-0.5f * dy * dy),
                            d_op,
                            gr * w,
                            gg * w,
                            gb * w};
    const float s = reduce9(g, lane);
    if (slot < kGrad) dst[slot] = s;

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
    if (k < count)
      for (int w = 0; w < kWarps; ++w)
        s += part[(k * kWarps + w) * kGrad + j];
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
// attr f32[T,K,9] and valid u8[T,K] (torch.bool) as given to K4; tfin
// f32[T,256] and mask i8[T,K,256] from K4 (8-byte aligned); gt f32[T,256]
// and gc f32[T,256,3], the cotangents of tfin and cfin; out: gout
// f32[T,K,9], the gradient of attr.
extern "C" int mrhash_blend_backward(const void* attr, const void* valid,
                                     int n_tiles, int K, int grid_x,
                                     const void* tfin, const void* mask,
                                     const void* gt, const void* gc,
                                     void* gout, void* stream) {
  if (n_tiles > 0) {
    const size_t smem =
        (size_t)K * (kRow + kWarps * kGrad + kWarps) * sizeof(float);
    const int rc = set_smem((const void*)blend_backward_kernel, smem);
    if (rc != 0) return rc;
    blend_backward_kernel<<<n_tiles, kPix, smem, (cudaStream_t)stream>>>(
        (const float*)attr, (const uint8_t*)valid, K, grid_x,
        (const float*)tfin, (const int8_t*)mask, (const float*)gt,
        (const float*)gc, (float*)gout);
  }
  return (int)cudaGetLastError();
}
