// Element-local SEM operator y_L = (S_L + lam W) u — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/poisson.py::poisson_local_pallas
// (body local_body).  Used by the split assembled form and by the NekBone
// scattered baseline (lam = 0, no weights).
//
// What bounds it on the H100: device-memory bytes.  Per local node it
// reads u, six G factors and w and writes y — (1+6+1+1) words — against
// 12(N+1) + 18 FLOPs, far below the card's FLOP/byte balance at N <= 15.
// At N=7 on a 32^3 box in fp64 that is 1.21 GB, 0.361 ms at 3.35 TB/s.
//
// Design: one thread block per element (hipBone's own GPU mapping), so
// each of the nine streams is read or written exactly once, coalesced
// across the block's threads; the three contractions with D and their
// transposes run out of shared memory, which holds u, D and the
// G-weighted gradients and never goes back to device memory.  No TPU
// tiling is carried over: no element blocks, no padding, no lane tiles.
#include "poisson_body.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kElementThreads)
poisson_local_kernel(const T* __restrict__ u, const T* __restrict__ g,
                     const T* __restrict__ w, const T* __restrict__ d,
                     T* __restrict__ y, int n1, T lam) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const repro::ElementSmem<T> s = repro::carve<T>(smem_raw, n1);
  const int p = n1 * n1 * n1;
  const long long base = static_cast<long long>(blockIdx.x) * p;

  for (int i = threadIdx.x; i < n1 * n1; i += blockDim.x) s.d[i] = d[i];
  for (int i = threadIdx.x; i < p; i += blockDim.x) s.u[i] = u[base + i];
  __syncthreads();
  repro::gradient_metric(s, g + 6 * base, n1);
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    const T wi = w != nullptr ? w[base + i] : T(1);
    y[base + i] = repro::divergence(s, i, n1) + lam * (wi * s.u[i]);
  }
}

template <typename T>
int launch(const void* u, const void* g, const void* w, const void* d, void* y,
           int n_elem, int n1, double lam, cudaStream_t stream) {
  const size_t smem = repro::element_smem_bytes(n1, sizeof(T));
  cudaError_t err = repro::allow_smem(poisson_local_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  poisson_local_kernel<T><<<n_elem, repro::element_threads(n1 * n1 * n1), smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<const T*>(d), static_cast<T*>(y), n1, static_cast<T>(lam));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, w, y: (n_elem, p); g: (n_elem, 6, p); d: (n1, n1); w may be null
// (weights of 1).  is_double selects fp64, else fp32.
extern "C" int poisson_local(const void* u, const void* g, const void* w, const void* d,
                             void* y, int n_elem, int n1, double lam, int is_double,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(u, g, w, d, y, n_elem, n1, lam, s)
                   : launch<float>(u, g, w, d, y, n_elem, n1, lam, s);
}
