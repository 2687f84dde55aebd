// Fixed-iteration ADMM for one QP, the x-step applied as M1^T (M1 rhs).
//
// Replaces the TPU kernel soft_robot_control_tpu/ops/pallas_admm.py
// _admm_kernel (entry admm_pallas, wrapper admm_fixed_pallas). Same
// function: `iters` iterations of
//   rhs = sigma w - q + A^T (rho z - y);  x~ = M1^T (M1 rhs);  z~ = A x~;
//   w = alpha x~ + (1-alpha) w;  z_rel = alpha z~ + (1-alpha) z;
//   z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
// from z0 = clip(A w0, l, u), with K^-1 = M1^T M1 (M1 the scaled inverse
// Cholesky factor, far better conditioned in f32 than K^-1 itself) and a
// per-row rho vector. The wrapper clamps infinite bounds to +-1e30.
//
// What bounds it on an H100: latency. Read once, M1 and A at n=380, m=400
// are 1.19 MB (0.35 us at 3.35 TB/s), and 50 iterations are 6e7 FLOP (1 us
// at 67 TFLOP/s), but each iteration is a chain of four dependent mat-vecs
// with a block barrier between them.
//
// Design: one block of up to 1024 threads. The vectors stay in shared
// memory; M1 and A (1.19 MB, more than a block's 227 KB) are read from L2
// in every iteration, M1 twice. M1 rhs and A x walk the matrix by rows
// (one warp per row, shuffle reduction); A^T v and M1^T v walk it by
// columns (a thread owns a column, G thread groups split the rows), so
// every read is of consecutive addresses across a warp and no transposed
// copy exists. One SM's share of the L2 bandwidth sets the time; spreading
// the rows over a cooperative grid or a cluster is a later redesign.
#include "admm_matvec.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kMaxThreads = 1024;

// shared-memory elements: q, w, rhs, M1 rhs, x~ (n each), l, u, z, y, t,
// rho (m each), column partials (G*n)
inline size_t smem_elems(int n, int m, int G) {
  return (5 + (size_t)G) * n + 6 * (size_t)m;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) admm_single_kernel(
    const T* __restrict__ M1, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sw = sq + n;
  T* sr = sw + n;   // rhs
  T* sm = sr + n;   // M1 rhs
  T* sx = sm + n;   // x~
  T* sl = sx + n;
  T* su = sl + m;
  T* sz = su + m;
  T* sy = sz + m;
  T* st = sy + m;   // rho z - y
  T* sp = st + m;   // rho
  T* part = sp + m;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int i = tid; i < n; i += nthr) {
    sq[i] = q[i];
    sw[i] = w0[i];
  }
  for (int j = tid; j < m; j += nthr) {
    sl[j] = l[j];
    su[j] = u[j];
    sy[j] = y0[j];
    sp[j] = rho[j];
  }
  __syncthreads();
  admm::matvec_rows(A, m, n, sw, [&](int j, T acc) {
    sz[j] = admm::clip(acc, sl[j], su[j]);
  });
  __syncthreads();

  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    for (int j = tid; j < m; j += nthr) st[j] = sp[j] * sz[j] - sy[j];
    __syncthreads();
    admm::matvec_cols(A, m, n, st, part, G);            // A^T t
    __syncthreads();
    for (int i = tid; i < n; i += nthr)
      sr[i] = sigma * sw[i] - sq[i] + admm::cols_sum(part, n, G, i);
    __syncthreads();
    admm::matvec_rows(M1, n, n, sr, [&](int i, T acc) { sm[i] = acc; });
    __syncthreads();
    admm::matvec_cols(M1, n, n, sm, part, G);           // M1^T (M1 rhs)
    __syncthreads();
    for (int i = tid; i < n; i += nthr) {
      const T x = admm::cols_sum(part, n, G, i);
      sx[i] = x;
      sw[i] = alpha * x + one_m_alpha * sw[i];
    }
    __syncthreads();
    admm::matvec_rows(A, m, n, sx, [&](int j, T zt) {   // A x~
      const T z_rel = alpha * zt + one_m_alpha * sz[j];
      const T z_new = admm::clip(z_rel + sy[j] / sp[j], sl[j], su[j]);
      sy[j] = sy[j] + sp[j] * (z_rel - z_new);
      sz[j] = z_new;
    });
    __syncthreads();
  }
  for (int i = tid; i < n; i += nthr) w_out[i] = sw[i];
  for (int j = tid; j < m; j += nthr) y_out[j] = sy[j];
}

template <typename T>
int launch(const T* M1, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int n,
           int m, int iters, double sigma, double alpha, void* stream) {
  const int G = admm::col_groups(n, kMaxThreads);
  const size_t smem = smem_elems(n, m, G) * sizeof(T);
  if (smem > kMaxSmem) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      admm_single_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  admm_single_kernel<T><<<1, kMaxThreads, smem, (cudaStream_t)stream>>>(
      M1, A, q, l, u, rho, w0, y0, w_out, y_out, n, m, iters, (T)sigma,
      (T)alpha, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int admm_single_f32(const float* M1, const float* A, const float* q,
                    const float* l, const float* u, const float* rho,
                    const float* w0, const float* y0, float* w_out,
                    float* y_out, int n, int m, int iters, double sigma,
                    double alpha, void* stream) {
  return launch<float>(M1, A, q, l, u, rho, w0, y0, w_out, y_out, n, m, iters,
                       sigma, alpha, stream);
}

int admm_single_f64(const double* M1, const double* A, const double* q,
                    const double* l, const double* u, const double* rho,
                    const double* w0, const double* y0, double* w_out,
                    double* y_out, int n, int m, int iters, double sigma,
                    double alpha, void* stream) {
  return launch<double>(M1, A, q, l, u, rho, w0, y0, w_out, y_out, n, m,
                        iters, sigma, alpha, stream);
}

}  // extern "C"
