// Batched fixed-iteration ADMM (OSQP update rule), one warp per QP.
//
// Replaces the TPU kernels soft_robot_control_tpu/ops/pallas_admm.py
// _admm_chunk_kernel (entry admm_batched_pallas) and, for any n, m whose
// footprint fits shared memory, _admm_kinv_kernel (one QP per program).
// Same function: for each of B independent QPs, `iters` iterations of
//   rhs = sigma w - q + A^T (rho z - y);  x~ = K^-1 rhs;  z~ = A x~;
//   w = alpha x~ + (1-alpha) w;  z_rel = alpha z~ + (1-alpha) z;
//   z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
// from z0 = clip(A w0, l, u), with no termination check and one shared rho
// row. Returns (w, y).
//
// What bounds it on an H100: not bytes and not FLOPs. At the main path's
// n=20, m=40, B=1024, 25 iterations, the inputs are ~5.6 MB (under 2 us at
// 3.35 TB/s) and the work ~120 MFLOP (under 2 us at 67 TFLOP/s f32). Each
// iteration is a chain of three dependent mat-vecs of 20-40 terms, so the
// time is the latency of that chain times the iteration count.
//
// Design: each QP's K^-1 and A are copied into shared memory once and stay
// there for all iterations (the Pallas kernel's VMEM residency); iterates
// live in shared memory too, so device memory is touched only at the start
// and the end. A warp owns one QP: lane i computes row i of each mat-vec,
// and the phases are separated by __syncwarp only, with no block barrier.
// There is no A^T input (the Pallas kernel's was a Mosaic layout
// artifact): A is read both ways from shared memory, stored with an odd
// row stride so that both the row reads and the column reads of a warp are
// free of bank conflicts. K^-1 is symmetric, so the x-step reads it by
// columns, which are consecutive addresses across lanes. A block holds up
// to four QPs, fewer when their footprint would pass 227 KB; any B works,
// including B = 1 and a ragged last block. The launcher refuses (returns
// -1) when one QP's footprint does not fit a block's shared memory.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kQpPerBlock = 4;

__host__ __device__ inline int a_stride(int n) { return n | 1; }

// elements of one QP's shared-memory region: K^-1 (n*n), A (m*stride),
// q, w, rhs, x~ (n each), l, u, z, y, t, rho (m each)
__host__ __device__ inline size_t qp_elems(int n, int m) {
  return (size_t)n * n + (size_t)m * a_stride(n) + 4 * (size_t)n +
         6 * (size_t)m;
}

template <typename T>
__device__ inline T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

template <typename T>
__global__ void admm_batched_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int B, int n, int m, int iters, T sigma, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long b = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp leaves; no block barrier follows
  const int lda = a_stride(n);
  T* sK = reinterpret_cast<T*>(smem_raw) + (size_t)warp * qp_elems(n, m);
  T* sA = sK + (size_t)n * n;
  T* sq = sA + (size_t)m * lda;
  T* sw = sq + n;
  T* sr = sw + n;   // rhs
  T* sx = sr + n;   // x~
  T* sl = sx + n;
  T* su = sl + m;
  T* sz = su + m;
  T* sy = sz + m;
  T* st = sy + m;   // rho z - y
  T* sp = st + m;   // rho

  const T* gK = Kinv + b * n * n;
  const T* gA = A + b * m * n;
  for (int i = lane; i < n * n; i += 32) sK[i] = gK[i];
  for (int i = lane; i < m * n; i += 32) {
    const int r = i / n;
    sA[r * lda + (i - r * n)] = gA[i];
  }
  for (int i = lane; i < n; i += 32) {
    sq[i] = q[b * n + i];
    sw[i] = w0[b * n + i];
  }
  for (int j = lane; j < m; j += 32) {
    sl[j] = l[b * m + j];
    su[j] = u[b * m + j];
    sy[j] = y0[b * m + j];
    sp[j] = rho[j];
  }
  __syncwarp();
  for (int j = lane; j < m; j += 32) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += sA[j * lda + k] * sw[k];
    sz[j] = clip(acc, sl[j], su[j]);
  }
  __syncwarp();

  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    for (int j = lane; j < m; j += 32) st[j] = sp[j] * sz[j] - sy[j];
    __syncwarp();
    for (int i = lane; i < n; i += 32) {  // rhs = sigma w - q + A^T t
      T acc = 0;
      for (int j = 0; j < m; ++j) acc += sA[j * lda + i] * st[j];
      sr[i] = sigma * sw[i] - sq[i] + acc;
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) {  // x~ = K^-1 rhs (column read)
      T acc = 0;
      for (int k = 0; k < n; ++k) acc += sK[k * n + i] * sr[k];
      sx[i] = acc;
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) sw[i] = alpha * sx[i] + one_m_alpha * sw[i];
    for (int j = lane; j < m; j += 32) {
      T zt = 0;
      for (int k = 0; k < n; ++k) zt += sA[j * lda + k] * sx[k];
      const T z_rel = alpha * zt + one_m_alpha * sz[j];
      const T z_new = clip(z_rel + sy[j] / sp[j], sl[j], su[j]);
      sy[j] = sy[j] + sp[j] * (z_rel - z_new);
      sz[j] = z_new;
    }
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32) w_out[b * n + i] = sw[i];
  for (int j = lane; j < m; j += 32) y_out[b * m + j] = sy[j];
}

template <typename T>
int launch(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int B,
           int n, int m, int iters, double sigma, double alpha,
           void* stream) {
  const size_t per = qp_elems(n, m) * sizeof(T);
  if (per > kMaxSmem) return -1;
  if (B <= 0) return 0;
  int qpb = kQpPerBlock;
  while (qpb > 1 && qpb * per > kMaxSmem) --qpb;
  if (qpb > B) qpb = B;
  const size_t smem = qpb * per;
  cudaError_t err = cudaFuncSetAttribute(
      admm_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + qpb - 1) / qpb);
  admm_batched_kernel<T><<<grid, 32 * qpb, smem, (cudaStream_t)stream>>>(
      Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m, iters, (T)sigma,
      (T)alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one QP needs, for the wrapper's error message.
size_t admm_batched_qp_bytes(int n, int m, int elem_size) {
  return qp_elems(n, m) * (size_t)elem_size;
}

int admm_batched_f32(const float* Kinv, const float* A, const float* q,
                     const float* l, const float* u, const float* rho,
                     const float* w0, const float* y0, float* w_out,
                     float* y_out, int B, int n, int m, int iters,
                     double sigma, double alpha, void* stream) {
  return launch<float>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                       iters, sigma, alpha, stream);
}

int admm_batched_f64(const double* Kinv, const double* A, const double* q,
                     const double* l, const double* u, const double* rho,
                     const double* w0, const double* y0, double* w_out,
                     double* y_out, int B, int n, int m, int iters,
                     double sigma, double alpha, void* stream) {
  return launch<double>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                        iters, sigma, alpha, stream);
}

}  // extern "C"
