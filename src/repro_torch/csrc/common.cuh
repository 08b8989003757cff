// Shared helpers of the repro_torch CUDA kernels (built for sm_90a by
// kernels/_build.py, bound with ctypes).  Every C entry point returns a
// cudaError_t as int: the result of cudaGetLastError() right after its
// launches, so a refused launch (too many threads, too much shared
// memory) reaches the Python wrapper, which raises.
#pragma once

#include <cuda_runtime.h>

// Error text for a code returned by an entry point of this library.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A product rounded on its own (never contracted into an FMA), so an
// elementwise update rounds exactly as PyTorch's separate mul and sub do.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Sum of one float per thread over the whole block, in a fixed order
// (shuffles within each warp, then the warp sums in warp order), so the
// result is the same on every run.  Valid in thread 0.  blockDim.x must
// be a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  if (warp == 0) {
    v = lane < n_warps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}
