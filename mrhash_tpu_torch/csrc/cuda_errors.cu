// Error-code text for the launch wrappers of ops/cuda_lib.py.

#include <cuda_runtime.h>

extern "C" const char* mrhash_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
