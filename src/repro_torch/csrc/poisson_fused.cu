// Single-pass assembled SEM operator y_G = Z^T (S_L + lam W) Z x_G —
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel
// repro/kernels/poisson_fused.py::poisson_assembled_fused_pallas (its
// "take" and "loop" gather modes alike).  The default assembled apply of
// the hipBone solve.
//
// What bounds it on the H100: device-memory bytes.  It reads x_G once,
// and per local node the l2g index, six G factors and w, and writes y_G
// once: 2 word N_G + (4 + 7 word) N_L (core/fom.py fused_apply_bytes) —
// 1.19 GB, 0.354 ms at N=7 on a 32^3 box in fp64 — against 12(N+1)^4 +
// 18(N+1)^3 FLOPs per element.
//
// Design: one thread block per element, the body of poisson.cu.  The block
// gathers its element's u straight from x_G through l2g into shared
// memory, so x_L never exists in device memory; after the local operator
// it scatter-adds each node's value into y_G with atomicAdd (native fp64
// on sm_90), so y_L never exists either.  The wrapper zeroes y_G first.
// The TPU kernel kept x_G/y_G resident in VMEM behind an 8 MB gate and
// needed no atomics because its grid runs in order; here blocks run in any
// order, x_G is read through L2, and there is no size gate.  The order of
// the atomic adds varies from run to run, so y_G agrees with the split
// form to round-off (each global node sums at most 8 element values), not
// bit for bit.  The Dirichlet mask wrap and the lam(x) screen stay outside
// the kernel (kernels/ops.py), as in the reference.
#include "poisson_body.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kElementThreads)
poisson_assembled_fused_kernel(const T* __restrict__ x, const int* __restrict__ l2g,
                               const T* __restrict__ g, const T* __restrict__ w,
                               const T* __restrict__ d, T* __restrict__ y, int n1, T lam) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const repro::ElementSmem<T> s = repro::carve<T>(smem_raw, n1);
  const int p = n1 * n1 * n1;
  const long long base = static_cast<long long>(blockIdx.x) * p;

  for (int i = threadIdx.x; i < n1 * n1; i += blockDim.x) s.d[i] = d[i];
  for (int i = threadIdx.x; i < p; i += blockDim.x) s.u[i] = x[l2g[base + i]];
  __syncthreads();
  repro::gradient_metric(s, g + 6 * base, n1);
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    const T val = repro::divergence(s, i, n1) + lam * (w[base + i] * s.u[i]);
    atomicAdd(&y[l2g[base + i]], val);
  }
}

template <typename T>
int launch(const void* x, const int* l2g, const void* g, const void* w, const void* d,
           void* y, int n_elem, int n1, double lam, cudaStream_t stream) {
  const size_t smem = repro::element_smem_bytes(n1, sizeof(T));
  cudaError_t err = repro::allow_smem(poisson_assembled_fused_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  poisson_assembled_fused_kernel<T>
      <<<n_elem, repro::element_threads(n1 * n1 * n1), smem, stream>>>(
          static_cast<const T*>(x), l2g, static_cast<const T*>(g), static_cast<const T*>(w),
          static_cast<const T*>(d), static_cast<T*>(y), n1, static_cast<T>(lam));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n_global,), y zeroed by the caller; l2g: (n_elem, p) int32;
// g: (n_elem, 6, p); w: (n_elem, p); d: (n1, n1).  is_double selects fp64.
extern "C" int poisson_assembled_fused(const void* x, const int* l2g, const void* g,
                                       const void* w, const void* d, void* y, int n_elem,
                                       int n1, double lam, int is_double, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(x, l2g, g, w, d, y, n_elem, n1, lam, s)
                   : launch<float>(x, l2g, g, w, d, y, n_elem, n1, lam, s);
}
