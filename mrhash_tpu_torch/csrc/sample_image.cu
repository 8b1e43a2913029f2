// K2: per-voxel sampling of a 2-channel f32 image (the starvation
// z-buffer readback).
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
