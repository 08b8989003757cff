// CG residual update fused with its squared norm — CUDA C++ for sm_90a:
//
//   r_new = r - alpha * ap,   rr = sum(float(r_new)^2)
//
// Replaces the TPU kernel repro/kernels/streams.py::fused_axpy_dot_pallas.
// Used as the fused_update of fp32 CG solves.  As in the reference the
// sum is taken in fp32 whatever the vectors' type (repro/kernels/ref.py
// fused_axpy_dot_ref), so fp64 solves keep the plain update.
//
// What bounds it on the H100: device-memory bytes — r and ap read, r_new
// written, 12 bytes per entry in fp32: 137 MB, 0.041 ms at 11.4 M entries.
// Two FLOPs per entry plus the square-and-add are nothing beside that.
//
// Design: pass 1 is a grid-stride loop of a fixed number of blocks; each
// thread keeps an fp32 partial in a register, each block reduces its
// threads in a fixed order and writes one partial to a scratch buffer.
// Pass 2 is one block that sums the partials, again in a fixed order.  No
// float atomics, so the sum is the same on every run (iteration counts do
// not drift); r is read once, in the same pass that writes r_new.  alpha
// is read from device memory, so the host never waits for it.  The
// product alpha * ap is rounded on its own (no FMA), so r_new is bitwise
// PyTorch's r - alpha * ap.
#include "common.cuh"

namespace {

template <typename T>
__global__ void axpy_dot_partials(const T* __restrict__ r, const T* __restrict__ ap,
                                  const T* __restrict__ alpha, T* __restrict__ r_new,
                                  float* __restrict__ partials, long long n) {
  const T a = *alpha;
  float acc = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T v = r[i] - mul_rn(a, ap[i]);
    r_new[i] = v;
    const float f = static_cast<float>(v);
    acc += f * f;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void sum_partials(const float* __restrict__ partials, int n_partials,
                             float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

template <typename T>
int launch(const void* r, const void* ap, const void* alpha, void* r_new, float* partials,
           float* out, long long n, int n_blocks, int threads, cudaStream_t stream) {
  axpy_dot_partials<T><<<n_blocks, threads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(ap), static_cast<const T*>(alpha),
      static_cast<T*>(r_new), partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<1, 1024, 0, stream>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, ap, r_new: (n,); alpha: one value of the same type on the device;
// partials: n_blocks floats of scratch; out: one float.  threads must be a
// multiple of 32, at most 1024.  is_double selects fp64 vectors.
extern "C" int fused_axpy_dot(const void* r, const void* ap, const void* alpha, void* r_new,
                              float* partials, float* out, long long n, int n_blocks,
                              int threads, int is_double, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(r, ap, alpha, r_new, partials, out, n, n_blocks, threads, s)
             : launch<float>(r, ap, alpha, r_new, partials, out, n, n_blocks, threads, s);
}
