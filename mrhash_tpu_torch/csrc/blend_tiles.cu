// K4 / K5: the 3D Gaussian Splatting tile blend, forward and backward.
//
// Replace mrhash_tpu/gs/blend_pallas.py::_fwd_kernel and ::_bwd_kernel
// (the Pallas kernels launched by blend_forward_pallas and
// blend_backward_pallas).  Those kernels walked TILE_BATCH tiles per grid
// step over K-major attribute rows, unrolled by UNROLL, because Mosaic
// needed [b, 256] vector slabs and contiguous per-step row slices in VMEM.
// Here the layout is tile-major ([T, K, 9] attributes, [T, K, 8] mask
// words) and each 16x16 tile is one CTA, whose pixel coordinates follow
// from the tile index and the grid width.  Both kernels start from the
// tile's last valid slot `count` (a warp max and a shared atomicMax) and
// stage only the rows below it, padded to 48 bytes, so a step reads its
// row with three 16-byte shared loads.  The gates are the reference's
// (forward.cu:249-356): valid, power <= 0, alpha >= 1/255, T >= 1e-4 and
// T(1 - alpha) >= 1e-4.
//
// K4 is issue-bound under -fmad=false (each multiply and add issues
// alone), so its design cuts instructions per pixel-step:
//   - 128 threads, two pixels each, p and p + 128: one column 8 rows
//     apart, so the row's loads and the power's x terms (dx, nh2 dx dx,
//     a[3] dx) serve both; nh2 = -0.5 a[2] and h4 = 0.5 a[4], the first
//     products of the power's terms, and the validity ride in the row's
//     padding, staged once;
//   - the blended mask is bit-packed: word w of row (tile, k) holds bit i
//     for pixel 32 w + i, the __ballot_sync of the warp that holds those
//     pixels; the words go to shared memory and the tile's K x 8 words to
//     global memory once, 16 bytes per thread, zeros past `count`;
//   - a warp leaves the walk early, exactly, once fl(T * fl(1 - 1/255)) <
//     1e-4 holds for all its 64 pixels: fl(1 - alpha) does not rise as
//     alpha rises from 1/255 to 0.99 and f32 rounding is monotone, so
//     every later T(1 - alpha) fails the last gate and T never changes
//     again.  Only a step that blended can change T, so only such a step
//     is checked.  (T never falls below 1e-4 itself, so "T < 1e-4" would
//     never fire.)
//
// K5, 256 threads of one pixel each, walks k = count-1..0 and recovers
// the transmittance before step k as T_after / (1 - alpha_k) wherever
// K4's blended bit is set (renderBackwards CUDA, backward.cu:386-594;
// DESIGN D16).  That division needs alpha_k
// bit-identical to K4's, so both kernels compute it in one __device__
// function and the library is built with -fmad=false.  K5's walk is shaped
// by what it does per step for each warp:
//   - it copies K4's words of the rows below `count` into shared memory
//     (16-byte loads), so the walk reads no global memory;
//   - a warp whose word is 0 at step k skips the step and stores zero
//     partials: T_before = T_after / 1 and S + 0 * rgb are unchanged and
//     every gradient term is 0 * finite, so the skip is exact;
//   - otherwise the 9 gradient sums over the warp's 32 pixels take a
//     transpose (reduce-scatter) butterfly, 12 shuffles instead of 45, and
//     9 lanes store the warp's partials with one instruction.
// The walk has no barrier per step, and the 8 warp partials of each sum
// (K x 8 x 9 floats, 37 KB at K = 128) are added in warp order once after
// it.
//
// Bound on the card: per valid (tile, k, pixel) ~30 f32 operations (one
// exp) in K4, ~70 in K5; bytes: the attributes and validity, the mask
// (32 B per (tile, k), the least that 256 bits take), T and C per pixel.
// At 1200x680 and K = 64 K4 moves ~27 MB and K5 ~33 MB against ~0.015 and
// ~0.035 ms of operations, so both are bound by their operations.  With
// -fmad=false no multiply and add fuse, so instruction issue is what the
// designs cut: K4's steps past `count`, its byte stores and the work two
// pixels of a column share, K5's shuffles (a quarter-rate pipe) and the
// steps in which a warp has nothing to add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per CTA, pixels per tile
constexpr int kWarps = kPix / 32;        // mask words per (tile, k)
constexpr int kFwdThreads = kPix / 2;   // K4: two pixels per thread
constexpr int kAttr = 9;                // x, y, conic a/b/c, opacity, r, g, b
constexpr int kGrad = 9;                // d x, y, conic a/b/c, opacity, r, g, b
constexpr int kRow = 12;                // staged attribute rows, 48 B
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kAlphaMin = 1e-4f;
constexpr unsigned kAll = 0xffffffffu;

// The terms of a Gaussian's power that depend on x alone (forward.cu:
// 300-318): dx, nh2 * dx * dx and a[3] * dx, with nh2 = -0.5f * a[2]; the
// pixels of one column share them.
struct XTerms {
  float dx, xx, ax;
};

__device__ __forceinline__ XTerms x_terms(const float* a, float nh2,
                                          float px) {
  const float dx = a[0] - px;
  return {dx, nh2 * dx * dx, a[3] * dx};
}

// Falloff and alpha of one Gaussian at one pixel, the power evaluated as
// nh2 * dx * dx - h4 * dy * dy - a[3] * dx * dy (h4 = 0.5f * a[4]) in the
// same order as the plain twins in gs/blend.py; K4 and K5 both call it,
// so their alphas are bit-identical.
__device__ __forceinline__ void alpha_terms(const float* a, const XTerms& x,
                                            float h4, float py, float& dy,
                                            float& power, float& e,
                                            float& alpha) {
  dy = a[1] - py;
  power = x.xx - h4 * dy * dy - x.ax * dy;
  e = expf(power);
  alpha = fminf(0.99f, a[5] * e);
}

// The tile's last valid slot + 1 (0 for a tile with none), from a warp
// max and a shared atomicMax; every thread of the CTA returns it.
__device__ __forceinline__ int tile_count(const uint8_t* __restrict__ valid,
                                          int t, int K, int* s_count) {
  const int p = threadIdx.x;
  if (p == 0) *s_count = 0;
  __syncthreads();
  int last = 0;
  for (int k = p; k < K; k += blockDim.x)
    if (valid[(int64_t)t * K + k]) last = k + 1;
  last = __reduce_max_sync(kAll, last);
  if ((p & 31) == 0 && last > 0) atomicMax(s_count, last);
  __syncthreads();
  return *s_count;
}

// Stages the tile's first `count` attribute rows into 48-byte rows of `s`
// (slots 9-11 are left to the caller).
__device__ __forceinline__ void stage_rows(const float* __restrict__ attr,
                                           int t, int K, int count,
                                           float* s) {
  const float* src = attr + (int64_t)t * K * kAttr;
  for (int i = threadIdx.x; i < count * kAttr; i += blockDim.x)
    s[(i / kAttr) * kRow + i % kAttr] = src[i];
}

__global__ void __launch_bounds__(kFwdThreads) blend_forward_kernel(
    const float* __restrict__ attr, const uint8_t* __restrict__ valid,
    int K, int grid_x, float* __restrict__ tfin, float* __restrict__ cfin,
    uint32_t* __restrict__ mask) {
  extern __shared__ float4 smem16[];                 // 16-byte aligned
  float* sa = reinterpret_cast<float*>(smem16);      // [K, 12]
  uint32_t* sbits = reinterpret_cast<uint32_t*>(sa + K * kRow);   // [K, 8]
  __shared__ int s_count;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int count = tile_count(valid, t, K, &s_count);
  stage_rows(attr, t, K, count, sa);
  for (int k = p; k < count; k += kFwdThreads) {   // slots 9-11
    const float* r = attr + ((int64_t)t * K + k) * kAttr;
    sa[k * kRow + 9] = valid[(int64_t)t * K + k] ? 1.0f : 0.0f;
    sa[k * kRow + 10] = -0.5f * r[2];   // nh2
    sa[k * kRow + 11] = 0.5f * r[4];    // h4
  }
  __syncthreads();

  // pixels p and p + 128: one column, 8 rows apart, bits of words warp
  // and warp + 4
  constexpr int kHalf = kWarps / 2;
  const float px = (float)((t % grid_x) * kBlock + p % kBlock);
  const float py[2] = {
      (float)((t / grid_x) * kBlock + p / kBlock),
      (float)((t / grid_x) * kBlock + (p + kFwdThreads) / kBlock)};
  float T[2] = {1.0f, 1.0f}, cr[2] = {0.0f, 0.0f}, cg[2] = {0.0f, 0.0f},
        cb[2] = {0.0f, 0.0f};
  int k = 0;
  while (k < count) {
    const float4* row = reinterpret_cast<const float4*>(sa + k * kRow);
    const float4 q0 = row[0], q1 = row[1], q2 = row[2];
    const float a[kAttr] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                            q1.y, q1.z, q1.w, q2.x};
    const XTerms x = x_terms(a, q2.z, px);
    uint32_t bits[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float dy, power, e, alpha;
      alpha_terms(a, x, q2.w, py[j], dy, power, e, alpha);
      const bool use = q2.y != 0.0f && power <= 0.0f &&
                       alpha >= kAlphaThreshold && T[j] >= kAlphaMin;
      const float test_T = T[j] * (1.0f - alpha);
      const bool blended = use && test_T >= kAlphaMin;
      if (blended) {
        const float w = alpha * T[j];
        cr[j] = cr[j] + w * a[6];
        cg[j] = cg[j] + w * a[7];
        cb[j] = cb[j] + w * a[8];
        T[j] = test_T;
      }
      bits[j] = __ballot_sync(kAll, blended);
    }
    if (lane == 0) {
      sbits[k * kWarps + warp] = bits[0];
      sbits[k * kWarps + warp + kHalf] = bits[1];
    }
    ++k;
    // the exact early exit: none of the warp's 64 pixels can blend again
    // (only a step that blended can change T, so only such a step is
    // checked)
    if ((bits[0] | bits[1]) != 0u &&
        __all_sync(kAll, T[0] * (1.0f - kAlphaThreshold) < kAlphaMin &&
                             T[1] * (1.0f - kAlphaThreshold) < kAlphaMin))
      break;
  }
  for (int j = k + lane; j < count; j += 32) {
    sbits[j * kWarps + warp] = 0u;
    sbits[j * kWarps + warp + kHalf] = 0u;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t pix = (int64_t)t * kPix + p + kFwdThreads * j;
    tfin[pix] = T[j];
    float* c = cfin + pix * 3;
    c[0] = cr[j];
    c[1] = cg[j];
    c[2] = cb[j];
  }
  __syncthreads();
  // the tile's K x 8 words, 16 bytes per thread, zeros past count
  uint4* dst = reinterpret_cast<uint4*>(mask + (int64_t)t * K * kWarps);
  const uint4* src = reinterpret_cast<const uint4*>(sbits);
  for (int i = p; i < K * 2; i += kFwdThreads)
    dst[i] = i < count * 2 ? src[i] : make_uint4(0u, 0u, 0u, 0u);
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
    const uint32_t* __restrict__ mask, const float* __restrict__ gt,
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
  const int count = tile_count(valid, t, K, &s_count);
  stage_rows(attr, t, K, count, sa);
  const uint4* m = reinterpret_cast<const uint4*>(mask + (int64_t)t * K *
                                                  kWarps);
  for (int i = p; i < count * 2; i += kPix)
    reinterpret_cast<uint4*>(sbits)[i] = m[i];
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
    const XTerms x = x_terms(a, -0.5f * a[2], px);
    const float dx = x.dx;
    float dy, power, e, alpha;
    alpha_terms(a, x, 0.5f * a[4], py, dy, power, e, alpha);
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
// cfin f32[T,256,3], mask i32[T,K,8] (16-byte aligned; bit i of word w is
// pixel 32 w + i).  Tile t covers pixels x = (t % grid_x) * 16 + p % 16,
// y = (t / grid_x) * 16 + p / 16.
extern "C" int mrhash_blend_forward(const void* attr, const void* valid,
                                    int n_tiles, int K, int grid_x,
                                    void* tfin, void* cfin, void* mask,
                                    void* stream) {
  if (n_tiles > 0) {
    const size_t smem = (size_t)K * (kRow + kWarps) * sizeof(float);
    const int rc = set_smem((const void*)blend_forward_kernel, smem);
    if (rc != 0) return rc;
    blend_forward_kernel<<<n_tiles, kFwdThreads, smem,
                           (cudaStream_t)stream>>>(
        (const float*)attr, (const uint8_t*)valid, K, grid_x, (float*)tfin,
        (float*)cfin, (uint32_t*)mask);
  }
  return (int)cudaGetLastError();
}

// Launches K5 on `stream`; returns cudaGetLastError() (0 on success).
// attr f32[T,K,9] and valid u8[T,K] (torch.bool) as given to K4; tfin
// f32[T,256] and mask i32[T,K,8] from K4 (16-byte aligned); gt f32[T,256]
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
        (const float*)tfin, (const uint32_t*)mask, (const float*)gt,
        (const float*)gc, (float*)gout);
  }
  return (int)cudaGetLastError();
}
