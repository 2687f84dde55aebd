// Batched fixed-iteration ADMM for QPs too large for a thread-block
// cluster's shared memory: one cluster of 8 blocks per QP, as many rows of
// each block's slice resident in its shared memory as fit, the rest walked
// in place through L2 every iteration.
//
// Replaces the TPU kernel soft_robot_control_tpu/ops/pallas_admm.py
// _admm_kinv_kernel (entry _admm_batched_pallas_grid) where one QP fits no
// cluster: GuSTO's sparse LOCP at n=386, m=1126 (2.34 MB in f32, 4.67 MB in
// f64) and the sparse LOCP at n=380, m=400 in f64 (2.37 MB). Same function
// as admm_batched.cu and admm_cluster.cu: for each of B independent QPs,
// `iters` iterations of
//   rhs = sigma w - q + A^T (rho z - y);  x~ = K^-1 rhs;  z~ = A x~;
//   w = alpha x~ + (1-alpha) w;  z_rel = alpha z~ + (1-alpha) z;
//   z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
// from z0 = clip(A w0, l, u), one shared rho row, no termination check.
// Bounds may be +-inf: they are only compared against, never multiplied.
//
// What bounds it on an H100: bytes, and the latency of an iteration's
// chain of phases. Read once, K^-1 and A of GuSTO's 64 sparse QPs are 149
// MB in f32 (45 us at 3.35 TB/s); their 50 iterations are 6.5 GFLOP (97 us
// at 67 TFLOP/s), the bound. The TPU kernel kept a QP in VMEM. The first
// Hopper design (one block per QP, 64 SMs busy at B=64) re-read A twice and
// K^-1 once an iteration from device memory: 13 GB a launch, 9.66 ms.
//
// Design (admm_cluster.cuh has the iteration): a cluster of 8 blocks per
// QP, each owning a slice of the rows of A and of K^-1, so that a wave of
// 15 clusters (what an H100 holds at once) keeps 120 SMs at work. A block
// keeps the leading rows of its slices in its shared memory for the whole
// launch, rows of A first (walked twice an iteration, K^-1 once), as many
// as the vectors leave room for (make_plan, kSome): at n=386, m=1126 in
// f32 132 of its 141 rows of A, none of its 49 of K^-1. It pads each
// resident row to 16 bytes, so that its walks read shared memory 16 bytes
// a load though n=386 rows are not 16-byte multiples (read an element a
// load, the kernel took a quarter longer on an H100). The rest it walks
// in place; the QPs in flight hold about 11 MB of such rows in f32, which
// stay in the 50 MB L2. The partial sums travel through distributed shared
// memory as in admm_cluster.cu, two exchanges an iteration. Where the eight
// full-length slots of x~ partials would not leave the vectors room (n = m
// past 1,842 in f64, 3,684 in f32), a block receives only the window of
// each peer's x~ partial around its rows, sums it and sends its finished
// rows to every peer: a third exchange an iteration, and the vectors then
// take about 8.75 n elements (make_plan's xwin; n = m up to 3,312 in f64
// and 6,624 in f32). The plan chooses it from the sizes alone, so the
// paths' QPs keep the two exchanges: forced onto them, the windowed
// receive gave the same results bit for bit and took 13.7% longer on
// GuSTO's sparse LOCPs in f64 (8.41 against 7.40 ms on an H100). Its f32
// walks sum with compensation: their rows are long. In f64 at
// n=386 the rows walked in place for the QPs in flight pass the L2. A QP
// whose matrices fit the cluster entirely takes the same path with every
// row resident (a smaller one goes to admm_batched.cu or admm_cluster.cu
// through the wrapper's dispatch). Clusters of 16 blocks (a non-portable
// size) would hold a whole f32 QP at n=386 but the card holds 7 of them at
// once: measured no faster there, and 1.9x slower on the n=380 QPs in f64.
#include "admm_cluster.cuh"

namespace {

using namespace admm_cluster;

template <typename T, int V, bool XW>
__global__ void __launch_bounds__(kThreads) admm_stream_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha,
    Plan p) {
  const size_t b = blockIdx.x / (unsigned)p.R;
  solve<T, V, kKinv, kSome, XW>(Kinv + b * n * n, A + b * m * n,
                                q + b * n, l + b * m, u + b * m, rho,
                                w0 + b * n, y0 + b * m, w_out + b * n,
                                y_out + b * m, n, m, iters, sigma, alpha, p);
}

// The plan on a full cluster with as many rows resident as fit; false when
// not even the vectors fit a block's shared memory.
bool plan_for(int n, int m, int elem, int V, Plan* p) {
  return make_plan(n, m, elem, kMaxCluster, V, kKinv, kSome, p);
}

// f(kernel) with the instance for a vector width and the plan's x~
// receive.
template <typename T, typename F>
int with_kernel(int V, int xwin, F f) {
  constexpr int kV = 16 / sizeof(T);
  if (V == kV)
    return xwin ? f(admm_stream_kernel<T, kV, true>)
                : f(admm_stream_kernel<T, kV, false>);
  return xwin ? f(admm_stream_kernel<T, 1, true>)
              : f(admm_stream_kernel<T, 1, false>);
}

template <typename T>
int launch(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int B,
           int n, int m, int iters, double sigma, double alpha,
           void* stream) {
  const int V = aligned16(Kinv, A) ? vector_width(n, sizeof(T)) : 1;
  Plan p;
  if (!plan_for(n, m, sizeof(T), V, &p)) return -1;
  if (B <= 0) return 0;
  return with_kernel<T>(V, p.xwin, [&](auto kernel) {
    return launch_clusters(kernel, p, B, stream, Kinv, A, q, l, u, rho, w0,
                           y0, w_out, y_out, n, m, iters, (T)sigma,
                           (T)alpha, p);
  });
}

}  // namespace

extern "C" {

// The plan for a QP of n variables and m rows with elements of `elem`
// bytes, as export_plan lays it out; -1 when the vectors alone do not fit.
int admm_stream_plan(int n, int m, int elem, int* out) {
  Plan p;
  if (!plan_for(n, m, elem, vector_width(n, elem), &p)) return -1;
  export_plan(p, out);
  return 0;
}

// Clusters (QPs) of that plan that the card holds at one time; -1 when the
// plan fails, else minus a CUDA error.
int admm_stream_max_active(int n, int m, int elem) {
  Plan p;
  const int V = vector_width(n, elem);
  if (!plan_for(n, m, elem, V, &p)) return -1;
  const auto active = [&](auto kernel) {
    return max_active_clusters(kernel, p);
  };
  if (elem == 4) return with_kernel<float>(V, p.xwin, active);
  return with_kernel<double>(V, p.xwin, active);
}

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
