// Batched fixed-iteration ADMM for QPs too large for a block's or a
// cluster's shared memory: one block per QP, K^-1 and A streamed from device memory every iteration.
//
// Replaces the TPU kernel soft_robot_control_tpu/ops/pallas_admm.py
// _admm_kinv_kernel (entry _admm_batched_pallas_grid) where one QP does not
// fit a block's shared memory: the sparse LOCP at n=380, m=400, whose K^-1
// alone is 578 KB in f32 (1.16 MB in f64). Same function as admm_batched.cu: for each of B
// independent QPs, `iters` iterations of
//   rhs = sigma w - q + A^T (rho z - y);  x~ = K^-1 rhs;  z~ = A x~;
//   w = alpha x~ + (1-alpha) w;  z_rel = alpha z~ + (1-alpha) z;
//   z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
// from z0 = clip(A w0, l, u), one shared rho row, no termination check.
// Bounds may be +-inf: they are only compared against, never multiplied.
//
// What bounds it on an H100: bytes. Read once, K^-1 and A of B=1024 QPs
// are 1.19 GB (0.36 ms at 3.35 TB/s; the 2.3e10 FLOP of 25 iterations take
// about as long at 67 TFLOP/s). This design does not reach that bound: the
// TPU kernel kept one QP's matrices in 16+ MB of VMEM, a block here has
// 227 KB, so each iteration reads A twice and K^-1 once, 1.8 MB a QP, and
// the QPs in flight (over 100 MB) pass the 50 MB L2, so the reads go to
// device memory: 46 GB a launch at B=1024 and 25 iterations.
//
// Design: the iterates and q, l, u, rho stay in shared memory for the whole
// launch. A x walks A by rows, one warp per row with a shuffle reduction.
// A^T v and the symmetric K^-1 rhs walk the matrix by columns: a thread
// owns a column, so a warp reads 128 consecutive bytes of one row at a
// time, and G groups of threads split the rows and add their partial sums
// through shared memory. No A^T copy exists. A QP that fits a thread-block
// cluster's distributed shared memory (8 x 227 KB) goes to admm_cluster.cu,
// which removes the per-iteration traffic; this kernel takes the QPs beyond
// that (the sparse LOCP in f64: 2.37 MB).
#include "admm_matvec.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kMaxThreads = 1024;

// shared-memory elements: q, w, rhs, x~ (n each), l, u, z, y, t, rho (m
// each), column partials (G*n)
inline size_t smem_elems(int n, int m, int G) {
  return (4 + (size_t)G) * n + 6 * (size_t)m;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) admm_stream_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sw = sq + n;
  T* sr = sw + n;   // rhs
  T* sx = sr + n;   // x~
  T* sl = sx + n;
  T* su = sl + m;
  T* sz = su + m;
  T* sy = sz + m;
  T* st = sy + m;   // rho z - y
  T* sp = st + m;   // rho
  T* part = sp + m;
  const size_t b = blockIdx.x;
  const T* gK = Kinv + b * n * n;
  const T* gA = A + b * m * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int i = tid; i < n; i += nthr) {
    sq[i] = q[b * n + i];
    sw[i] = w0[b * n + i];
  }
  for (int j = tid; j < m; j += nthr) {
    sl[j] = l[b * m + j];
    su[j] = u[b * m + j];
    sy[j] = y0[b * m + j];
    sp[j] = rho[j];
  }
  __syncthreads();
  admm::matvec_rows(gA, m, n, sw, [&](int j, T acc) {
    sz[j] = admm::clip(acc, sl[j], su[j]);
  });
  __syncthreads();

  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    for (int j = tid; j < m; j += nthr) st[j] = sp[j] * sz[j] - sy[j];
    __syncthreads();
    admm::matvec_cols(gA, m, n, st, part, G);          // A^T t
    __syncthreads();
    for (int i = tid; i < n; i += nthr)
      sr[i] = sigma * sw[i] - sq[i] + admm::cols_sum(part, n, G, i);
    __syncthreads();
    admm::matvec_cols(gK, n, n, sr, part, G);          // K^-1 rhs (symmetric)
    __syncthreads();
    for (int i = tid; i < n; i += nthr) {
      const T x = admm::cols_sum(part, n, G, i);
      sx[i] = x;
      sw[i] = alpha * x + one_m_alpha * sw[i];
    }
    __syncthreads();
    admm::matvec_rows(gA, m, n, sx, [&](int j, T zt) {  // A x~
      const T z_rel = alpha * zt + one_m_alpha * sz[j];
      const T z_new = admm::clip(z_rel + sy[j] / sp[j], sl[j], su[j]);
      sy[j] = sy[j] + sp[j] * (z_rel - z_new);
      sz[j] = z_new;
    });
    __syncthreads();
  }
  for (int i = tid; i < n; i += nthr) w_out[b * n + i] = sw[i];
  for (int j = tid; j < m; j += nthr) y_out[b * m + j] = sy[j];
}

template <typename T>
int launch(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int B,
           int n, int m, int iters, double sigma, double alpha,
           void* stream) {
  if (B <= 0) return 0;
  const int G = admm::col_groups(n, kMaxThreads);
  const size_t smem = smem_elems(n, m, G) * sizeof(T);
  if (smem > kMaxSmem) return -1;
  int threads = G * admm::round_up_32(n);
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 128) threads = 128;
  cudaError_t err = cudaFuncSetAttribute(
      admm_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  admm_stream_kernel<T><<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, n, m, iters, (T)sigma,
      (T)alpha, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int admm_stream_f32(const float* Kinv, const float* A, const float* q,
                    const float* l, const float* u, const float* rho,
                    const float* w0, const float* y0, float* w_out,
                    float* y_out, int B, int n, int m, int iters,
                    double sigma, double alpha, void* stream) {
  return launch<float>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                       iters, sigma, alpha, stream);
}

int admm_stream_f64(const double* Kinv, const double* A, const double* q,
                    const double* l, const double* u, const double* rho,
                    const double* w0, const double* y0, double* w_out,
                    double* y_out, int B, int n, int m, int iters,
                    double sigma, double alpha, void* stream) {
  return launch<double>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                        iters, sigma, alpha, stream);
}

}  // extern "C"
