// K2: per-voxel sampling of a 2-channel f32 image (the starvation
// z-buffer readback), and K6, the 5-channel bf16 sampler (below).
//
// Replaces mrhash_tpu/ops/pallas_kernels.py::_sample_kernel, the Pallas
// kernel launched by sample_image_pallas.  That kernel sliced a 24x256
// patch per block out of VMEM and selected each lane's pixel with a
// one-hot f32 matmul plus a column select; its patch origins and
// per-step `bactive` gate existed only to fit VMEM.  On Hopper each
// (block, lane) thread reads img[c, row, col] for both channels where its
// `ok` mask holds and writes 0 elsewhere, into the channel-middle
// f32[A,2,512] layout of the reference.
//
// Bound: bytes.  Per lane 9 B of index/mask read, up to 8 B of image
// gathered, 8 B written.  Lanes of one block project to neighbouring
// pixels, so the gathers hit L2 (the image is 2 x 3.3 MB at 1200x680);
// the index reads and output writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 512;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) sample_image_kernel(
    const float* __restrict__ img, int rows, int cols,
    const int32_t* __restrict__ row, const int32_t* __restrict__ col,
    const uint8_t* __restrict__ ok, int64_t n, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v0 = 0.0f, v1 = 0.0f;
  if (ok[i]) {
    const int64_t p = (int64_t)row[i] * cols + col[i];
    v0 = img[p];
    v1 = img[(int64_t)rows * cols + p];
  }
  const int64_t base = (i / kLanes) * (2 * kLanes) + (i % kLanes);
  out[base] = v0;
  out[base + kLanes] = v1;
}

// K6: the 5-channel bf16 sampler.  Replaces
// mrhash_tpu/ops/pallas_kernels.py::_sample_kernel_v2 (launched by
// sample_image_pallas_v2), which sliced a 32x256 patch per block out of a
// VMEM copy of the image at an 8- and 128-aligned origin and selected each
// lane's pixel with a bf16 one-hot MXU contraction over the column axis
// plus a masked row sum.  That contraction picks one element and is exact,
// so the function is a masked gather: out[a, ch, l] =
// img5[ch, r0' + lr, c0' + lc] for ch < 5 where 0 <= lr < 32 and
// 0 <= lc < 256, else 0, with the origin clamped like the patch slice,
// r0' = clamp(r0, 0, rows - 32) and c0' = clamp(c0, 0, cols - 256).
// Channels 5-7, which the Pallas kernel never wrote, are written 0.  One
// thread per (block, lane); a bf16 load widens to f32 exactly (its bits
// shifted up by 16).
constexpr int kPatchH = 32;
constexpr int kPatchW = 256;
constexpr int kCh5 = 5;
constexpr int kOutCh = 8;

__global__ void __launch_bounds__(kThreads) sample_image5_kernel(
    const uint16_t* __restrict__ img, int rows, int cols,
    const int32_t* __restrict__ r0, const int32_t* __restrict__ c0,
    const int32_t* __restrict__ lr, const int32_t* __restrict__ lc,
    int64_t n, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t a = i / kLanes;
  const int l = (int)(i % kLanes);
  const int r = lr[i], c = lc[i];
  float v[kCh5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (r >= 0 && r < kPatchH && c >= 0 && c < kPatchW) {
    const int rr = min(max(r0[a], 0), rows - kPatchH) + r;
    const int cc = min(max(c0[a], 0), cols - kPatchW) + c;
    const int64_t plane = (int64_t)rows * cols;
    const int64_t p = (int64_t)rr * cols + cc;
#pragma unroll
    for (int ch = 0; ch < kCh5; ++ch)
      v[ch] = __uint_as_float((uint32_t)img[ch * plane + p] << 16);
  }
  float* o = out + a * (kOutCh * kLanes) + l;
#pragma unroll
  for (int ch = 0; ch < kOutCh; ++ch) o[ch * kLanes] = ch < kCh5 ? v[ch] : 0.0f;
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// img f32[2,rows,cols]; row/col i32[A,512]; ok u8[A,512] (torch.bool);
// out f32[A,2,512].  The wrapper checks that every ok lane addresses a
// pixel inside the image.
extern "C" int mrhash_sample_image(const void* img, int rows, int cols,
                                   const void* row, const void* col,
                                   const void* ok, int64_t n_blocks,
                                   void* out, void* stream) {
  const int64_t n = n_blocks * kLanes;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    sample_image_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)img, rows, cols, (const int32_t*)row,
        (const int32_t*)col, (const uint8_t*)ok, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

// Launches K6 on `stream`; returns cudaGetLastError() (0 on success).
// img bf16[5,rows,cols] (as u16 bits); r0/c0 i32[A]; lr/lc i32[A,512];
// out f32[A,8,512].  The wrapper checks rows >= 32 and cols >= 256.
extern "C" int mrhash_sample_image5(const void* img, int rows, int cols,
                                    const void* r0, const void* c0,
                                    const void* lr, const void* lc,
                                    int64_t n_blocks, void* out,
                                    void* stream) {
  const int64_t n = n_blocks * kLanes;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    sample_image5_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)img, rows, cols, (const int32_t*)r0,
        (const int32_t*)c0, (const int32_t*)lr, (const int32_t*)lc, n,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
