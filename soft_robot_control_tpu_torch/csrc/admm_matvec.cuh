// Small pieces the ADMM kernels share: the box projection, and the
// strided dot products of kernel 1's block form (admm_batched.cu), whose
// three mat-vecs all walk a matrix that sits in shared memory: A^T t down
// a column in row groups, K^-1 rhs down a column (K^-1 is symmetric), and
// A x~ along a row. clip also serves the cluster kernels
// (admm_cluster.cuh).
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace admm {

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__host__ __device__ inline int round_up_32(int n) { return (n + 31) & ~31; }

// sum_k a[k sa] v[k sv] for k < len, in four interleaved chains, so that
// an FMA waits on the one four places before it and the loads of a group
// of four are in flight together.
template <typename T>
__device__ __forceinline__ T dot(const T* a, int sa, const T* v, int sv,
                                 int len) {
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int k = 0;
  for (; k + 4 <= len; k += 4, a += 4 * sa, v += 4 * sv) {
    s0 += a[0] * v[0];
    s1 += a[sa] * v[sv];
    s2 += a[2 * sa] * v[2 * sv];
    s3 += a[3 * sa] * v[3 * sv];
  }
  for (; k < len; ++k, a += sa, v += sv) s0 += a[0] * v[0];
  return (s0 + s1) + (s2 + s3);
}

// dot(a, sa, v, 1, len) with v 16-byte aligned and read 16 bytes a load:
// the same four chains in the same order, a quarter (float) or a half
// (double) of the loads of v, which the warp reads as broadcasts.
template <typename T>
__device__ __forceinline__ T dot_v(const T* a, int sa, const T* v, int len) {
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int k = 0;
  for (; k + 4 <= len; k += 4, a += 4 * sa) {
    T x[4];
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(v + k);
      x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
    } else {
      const double2 q0 = *reinterpret_cast<const double2*>(v + k);
      const double2 q1 = *reinterpret_cast<const double2*>(v + k + 2);
      x[0] = q0.x, x[1] = q0.y, x[2] = q1.x, x[3] = q1.y;
    }
    s0 += a[0] * x[0];
    s1 += a[sa] * x[1];
    s2 += a[2 * sa] * x[2];
    s3 += a[3 * sa] * x[3];
  }
  for (; k < len; ++k, a += sa) s0 += a[0] * v[k];
  return (s0 + s1) + (s2 + s3);
}

// sum_k a[k sa] for k < len, in the same four chains.
template <typename T>
__device__ __forceinline__ T sum(const T* a, int sa, int len) {
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int k = 0;
  for (; k + 4 <= len; k += 4, a += 4 * sa) {
    s0 += a[0];
    s1 += a[sa];
    s2 += a[2 * sa];
    s3 += a[3 * sa];
  }
  for (; k < len; ++k, a += sa) s0 += a[0];
  return (s0 + s1) + (s2 + s3);
}

}  // namespace admm
