// Fixed-iteration ADMM for one QP, the x-step applied as M1^T (M1 rhs), on
// one thread-block cluster with M1 and A resident in its shared memory.
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
// at 67 TFLOP/s), but each iteration is a chain of four dependent mat-vecs.
// The TPU kernel held both matrices in VMEM; one Hopper block cannot (227
// KB), and a single block that re-reads them from L2 spends its time
// waiting on dependent batches of L2 loads.
//
// Design (admm_cluster.cuh has the iteration): one cluster of 8 blocks on
// 8 SMs, each block owning an eighth of the rows of M1 and of A in its
// shared memory for all iterations, so that an iteration reads shared
// memory only and its four mat-vecs run 8 wide. M1 rhs goes by rows and
// M1^T s by columns over the same slice, so the block needs only its own
// part of s and the iteration has two exchanges, in which the partial sums
// of A^T t and of x~ travel through distributed shared memory as bulk
// copies that signal a transaction barrier in the receiver. Where the
// matrices do not fit the cluster's shared memory (f64 at n=380: 2.37 MB)
// the same kernel walks each block's slice in place, through L2, with the
// rows still spread over 8 SMs.
#include "admm_cluster.cuh"

namespace {

using namespace admm_cluster;

template <typename T, int V, bool kResident>
__global__ void __launch_bounds__(kThreads) admm_single_kernel(
    const T* __restrict__ M1, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha,
    Plan p) {
  solve<T, V, kM1, kResident>(M1, A, q, l, u, rho, w0, y0, w_out, y_out, n, m,
                              iters, sigma, alpha, p);
}

// The plan on a full cluster, resident where the matrices fit; false when
// not even the vectors fit a block's shared memory.
bool plan_for(int n, int m, int elem, int V, Plan* p) {
  return make_plan(n, m, elem, kMaxCluster, V, kM1, true, p) ||
         make_plan(n, m, elem, kMaxCluster, V, kM1, false, p);
}

template <typename T, int V>
int launch_v(const Plan& p, void* stream, const T* M1, const T* A, const T* q,
             const T* l, const T* u, const T* rho, const T* w0, const T* y0,
             T* w_out, T* y_out, int n, int m, int iters, T sigma, T alpha) {
  if (p.resident)
    return launch_clusters(admm_single_kernel<T, V, true>, p, 1, stream, M1,
                           A, q, l, u, rho, w0, y0, w_out, y_out, n, m, iters,
                           sigma, alpha, p);
  return launch_clusters(admm_single_kernel<T, V, false>, p, 1, stream, M1, A,
                         q, l, u, rho, w0, y0, w_out, y_out, n, m, iters,
                         sigma, alpha, p);
}

template <typename T>
int launch(const T* M1, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int n,
           int m, int iters, double sigma, double alpha, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const int V = aligned16(M1, A) ? vector_width(n, sizeof(T)) : 1;
  Plan p;
  if (!plan_for(n, m, sizeof(T), V, &p)) return -1;
  if (V == kV)
    return launch_v<T, kV>(p, stream, M1, A, q, l, u, rho, w0, y0, w_out,
                           y_out, n, m, iters, (T)sigma, (T)alpha);
  return launch_v<T, 1>(p, stream, M1, A, q, l, u, rho, w0, y0, w_out, y_out,
                        n, m, iters, (T)sigma, (T)alpha);
}

}  // namespace

extern "C" {

// The plan for a QP of n variables and m rows with elements of `elem`
// bytes, as export_plan lays it out; -1 when the vectors alone do not fit.
int admm_single_plan(int n, int m, int elem, int* out) {
  Plan p;
  if (!plan_for(n, m, elem, vector_width(n, elem), &p)) return -1;
  export_plan(p, out);
  return 0;
}

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
