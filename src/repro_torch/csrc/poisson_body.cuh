// The element-local SEM operator body shared by poisson.cu (element-local
// kernel) and poisson_fused.cu (single-pass assembled kernel):
//
//   y = D_r^T wr + D_s^T ws + D_t^T wt + lam * w * u,
//   [wr ws wt] = G [D_r u, D_s u, D_t u]   (G the 6-entry symmetric metric)
//
// for ONE element per thread block, node order (t, s, r) with r fastest,
// p = (N+1)^3 nodes, any N from 1 to 15.  The element's u, D and the three
// weighted gradients sit in shared memory (4p + n1^2 words: 133,120 bytes
// at N=15 in fp64, so the launchers opt in above 48 KB); threads stride
// over the nodes, so above 512 nodes a thread owns several.  Accumulation
// is in T itself (fp32 or fp64).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kElementThreads = 512;

template <typename T>
struct ElementSmem {
  T* d;   // (n1, n1) derivative matrix
  T* u;   // (p,) element field
  T* wr;  // (p,) G-weighted gradients
  T* ws;
  T* wt;
};

template <typename T>
__device__ __forceinline__ ElementSmem<T> carve(unsigned char* raw, int n1) {
  T* base = reinterpret_cast<T*>(raw);
  const int p = n1 * n1 * n1;
  ElementSmem<T> s;
  s.d = base;
  s.u = s.d + n1 * n1;
  s.wr = s.u + p;
  s.ws = s.wr + p;
  s.wt = s.ws + p;
  return s;
}

__host__ __device__ constexpr size_t element_smem_bytes(int n1, size_t word) {
  return word * (static_cast<size_t>(n1) * n1 + 4 * static_cast<size_t>(n1) * n1 * n1);
}

// Gradient and metric: fills s.wr/ws/wt from s.u and s.d (both loaded and
// synchronised by the caller).  g_e points at this element's (6, p) factors.
template <typename T>
__device__ void gradient_metric(const ElementSmem<T>& s, const T* __restrict__ g_e, int n1) {
  const int p = n1 * n1 * n1;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    const int r = i % n1;
    const int sx = (i / n1) % n1;
    const int t = i / (n1 * n1);
    T ur = 0, us = 0, ut = 0;
    for (int a = 0; a < n1; ++a) {
      ur += s.d[r * n1 + a] * s.u[(t * n1 + sx) * n1 + a];
      us += s.d[sx * n1 + a] * s.u[(t * n1 + a) * n1 + r];
      ut += s.d[t * n1 + a] * s.u[(a * n1 + sx) * n1 + r];
    }
    const T g0 = g_e[i], g1 = g_e[p + i], g2 = g_e[2 * p + i];
    const T g3 = g_e[3 * p + i], g4 = g_e[4 * p + i], g5 = g_e[5 * p + i];
    s.wr[i] = g0 * ur + g1 * us + g2 * ut;
    s.ws[i] = g1 * ur + g3 * us + g4 * ut;
    s.wt[i] = g2 * ur + g4 * us + g5 * ut;
  }
}

// Divergence (transposed contractions) at node i, after gradient_metric
// and a __syncthreads().
template <typename T>
__device__ __forceinline__ T divergence(const ElementSmem<T>& s, int i, int n1) {
  const int r = i % n1;
  const int sx = (i / n1) % n1;
  const int t = i / (n1 * n1);
  T acc = 0;
  for (int a = 0; a < n1; ++a) {
    acc += s.d[a * n1 + r] * s.wr[(t * n1 + sx) * n1 + a];
    acc += s.d[a * n1 + sx] * s.ws[(t * n1 + a) * n1 + r];
    acc += s.d[a * n1 + t] * s.wt[(a * n1 + sx) * n1 + r];
  }
  return acc;
}

// Block size for p nodes: whole warps, at most kElementThreads.
inline int element_threads(int p) {
  const int warps = (p + 31) / 32;
  const int t = warps * 32;
  return t < kElementThreads ? t : kElementThreads;
}

// Opt a kernel in to the dynamic shared memory it needs above 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
