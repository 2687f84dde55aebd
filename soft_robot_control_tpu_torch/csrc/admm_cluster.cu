// Batched fixed-iteration ADMM with each QP resident across the shared
// memory of a thread-block cluster: one cluster per QP, K^-1 and A read
// from device memory once.
//
// Replaces the TPU kernel soft_robot_control_tpu/ops/pallas_admm.py
// _admm_kinv_kernel (entry _admm_batched_pallas_grid) where one QP does not
// fit a block's shared memory but fits a cluster's: the sparse LOCP at
// n=380, m=400 in f32, whose K^-1 and A are 1.19 MB. Same function as
// admm_batched.cu and admm_stream.cu: for each of B independent QPs,
// `iters` iterations of
//   rhs = sigma w - q + A^T (rho z - y);  x~ = K^-1 rhs;  z~ = A x~;
//   w = alpha x~ + (1-alpha) w;  z_rel = alpha z~ + (1-alpha) z;
//   z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
// from z0 = clip(A w0, l, u), one shared rho row, no termination check.
// Bounds may be +-inf: they are only compared against, never multiplied.
//
// What bounds it on an H100: bytes. Read once, K^-1 and A of B=1024 QPs
// are 1.19 GB (0.36 ms at 3.35 TB/s). The TPU kernel kept one QP's
// matrices in VMEM for all iterations; a Hopper block has 227 KB, and the
// streaming kernel (admm_stream.cu) therefore re-reads 1.8 MB a QP every
// iteration, 46 GB a launch. The matrices of different QPs share nothing,
// so the only reuse is across iterations, and the only memory next to the
// arithmetic that holds 1.19 MB is a cluster's: 6 blocks x 227 KB.
//
// Design (admm_cluster.cuh has the iteration): a cluster of R blocks per
// QP, each block owning a slice of the rows of A and of K^-1 in its shared
// memory; device memory is touched at the start and the end only. K^-1 is
// symmetric, so the x-step is the sum of the blocks' partials
// K^-1[rows_r, :]^T rhs[rows_r], exchanged like the A^T partials through
// distributed shared memory, as bulk copies that signal a transaction
// barrier in the receiver: two exchanges an iteration and no cluster
// barrier inside the loop. What is left per iteration is three mat-vec
// passes over a block's slice from shared memory and the latency of the
// chain of phases between them (measured on an H100: about 4 us an
// iteration, of which the three passes are under half). The card holds 15
// to 17 QPs at a time, so a launch of B QPs takes B/17 waves of that chain.
// R is the smallest cluster that holds the QP unless the caller names one:
// smaller clusters leave room for more QPs in flight (6 blocks against 8
// at the sparse LOCP's size: 17 against 15 QPs, and 7% less time). QPs
// beyond 8 blocks' shared memory stay with admm_stream.cu.
#include "admm_cluster.cuh"

namespace {

using namespace admm_cluster;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) admm_cluster_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha,
    Plan p) {
  const size_t b = blockIdx.x / (unsigned)p.R;
  solve<T, V, kKinv, kAll>(Kinv + b * n * n, A + b * m * n, q + b * n,
                           l + b * m, u + b * m, rho, w0 + b * n, y0 + b * m,
                           w_out + b * n, y_out + b * m, n, m, iters, sigma,
                           alpha, p);
}

// The plan for R blocks a cluster, or for the smallest cluster that holds
// the QP when R is 0; false when none of up to 8 blocks does.
bool plan_for(int n, int m, int elem, int R, int V, Plan* p) {
  if (R > 0)
    return R <= kMaxCluster && make_plan(n, m, elem, R, V, kKinv, kAll, p);
  for (R = 1; R <= kMaxCluster; ++R)
    if (make_plan(n, m, elem, R, V, kKinv, kAll, p)) return true;
  return false;
}

template <typename T>
int launch(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int B,
           int n, int m, int iters, double sigma, double alpha, int R,
           void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const int V = aligned16(Kinv, A) ? vector_width(n, sizeof(T)) : 1;
  Plan p;
  if (!plan_for(n, m, sizeof(T), R, V, &p)) return -1;
  if (B <= 0) return 0;
  if (V == kV)
    return launch_clusters(admm_cluster_kernel<T, kV>, p, B, stream, Kinv, A,
                           q, l, u, rho, w0, y0, w_out, y_out, n, m, iters,
                           (T)sigma, (T)alpha, p);
  return launch_clusters(admm_cluster_kernel<T, 1>, p, B, stream, Kinv, A, q,
                         l, u, rho, w0, y0, w_out, y_out, n, m, iters,
                         (T)sigma, (T)alpha, p);
}

}  // namespace

extern "C" {

// The plan for a QP of n variables and m rows with elements of `elem`
// bytes on a cluster of R blocks (0: the smallest that holds it), as
// export_plan lays it out; returns -1 when the QP fits no cluster.
int admm_cluster_plan(int n, int m, int elem, int R, int* out) {
  Plan p;
  if (!plan_for(n, m, elem, R, vector_width(n, elem), &p)) return -1;
  export_plan(p, out);
  return 0;
}

// Clusters of that plan that the card holds at one time (f32 or f64 by
// `elem`); -1 when the QP fits no cluster, else minus a CUDA error.
int admm_cluster_max_active(int n, int m, int elem, int R) {
  Plan p;
  const int V = vector_width(n, elem);
  if (!plan_for(n, m, elem, R, V, &p)) return -1;
  if (elem == 4)
    return V == 4 ? max_active_clusters(admm_cluster_kernel<float, 4>, p)
                  : max_active_clusters(admm_cluster_kernel<float, 1>, p);
  return V == 2 ? max_active_clusters(admm_cluster_kernel<double, 2>, p)
                : max_active_clusters(admm_cluster_kernel<double, 1>, p);
}

int admm_cluster_f32(const float* Kinv, const float* A, const float* q,
                     const float* l, const float* u, const float* rho,
                     const float* w0, const float* y0, float* w_out,
                     float* y_out, int B, int n, int m, int iters,
                     double sigma, double alpha, int R, void* stream) {
  return launch<float>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                       iters, sigma, alpha, R, stream);
}

int admm_cluster_f64(const double* Kinv, const double* A, const double* q,
                     const double* l, const double* u, const double* rho,
                     const double* w0, const double* y0, double* w_out,
                     double* y_out, int B, int n, int m, int iters,
                     double sigma, double alpha, int R, void* stream) {
  return launch<double>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                        iters, sigma, alpha, R, stream);
}

}  // extern "C"
