// Batched fixed-iteration ADMM (OSQP update rule), B independent QPs.
//
// Replaces the TPU kernels soft_robot_control_tpu/ops/pallas_admm.py
// _admm_chunk_kernel (entry admm_batched_pallas) and, for any n, m whose
// footprint fits shared memory, _admm_kinv_kernel (one QP per program).
// Same function: for each of B independent QPs, `iters` iterations of
//   rhs = sigma w - q + A^T (rho z - y);  x~ = K^-1 rhs;  z~ = A x~;
//   w = alpha x~ + (1-alpha) w;  z_rel = alpha z~ + (1-alpha) z;
//   z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
// from z0 = clip(A w0, l, u), with no termination check and one shared rho
// row. Returns (w, y). The three mat-vecs are taken as written, in that
// order; nothing is folded into another product.
//
// What bounds it on an H100: not bytes and not FLOPs. At the main path's
// n=20, m=40, B=1024, 25 iterations, the inputs are ~5.6 MB (under 2 us at
// 3.35 TB/s) and the work ~120 MFLOP (under 2 us at 67 TFLOP/s f32). Each
// iteration is a chain of three dependent mat-vecs of 20-40 terms, so the
// time is the latency of that chain times the iteration count, unless
// enough QPs are in flight to cover it.
//
// Two forms, chosen by size and element type (admm_batched_form;
// ops/admm_batched.py batched_form mirrors it):
//
// - registers (float32, n <= 32, m <= 64: the condensed LOCP): one warp
//   per QP, with A, A^T and K^-1 in registers for all iterations,
//   compile-time sized and fully unrolled. Lane i holds column i of A (for
//   A^T t) and of K^-1 (row i: it is symmetric), lane j rows j and j + 32
//   of A (for A x~). Each mat-vec is then 20-64 FMAs on one lane's own
//   registers, in four independent chains, against a vector that the warp
//   reads from shared memory as 16-byte broadcasts; only the vectors t,
//   rhs and x~ cross lanes, through shared memory and __syncwarp. The
//   chain of an iteration is three such mat-vecs and the row updates, a few
//   hundred cycles; 1024 QPs are 8 warps an SM. In float64 the three
//   copies would not fit a lane's 255 registers: float64 QPs take the
//   shared form.
// - shared (every other QP that fits a block): one warp per QP; K^-1, A
//   and the iterates are copied into shared memory once and stay there (the
//   Pallas kernel's VMEM residency), lane i computes row i of each mat-vec,
//   and the phases are separated by __syncwarp only. A is stored with an
//   odd row stride so that both its row and its column reads are free of
//   bank conflicts; K^-1 is symmetric, so the x-step reads it by columns. A
//   block holds up to four QPs, fewer when their footprint would pass 227
//   KB. The launcher refuses (returns -1) when one QP's footprint does not
//   fit a block's shared memory.
//
// Any B works, including B = 1.
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

// Dot product of L of a lane's registers with a vector in shared memory
// (16-byte aligned), read as 16-byte broadcasts, in four chains.
template <int L>
__device__ __forceinline__ float dot(const float* r, const float* v) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int k = 0; k < L; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(v + k);
    s0 += r[k] * x.x;
    s1 += r[k + 1] * x.y;
    s2 += r[k + 2] * x.z;
    s3 += r[k + 3] * x.w;
  }
  return (s0 + s1) + (s2 + s3);
}

// The register form: one QP a warp; NP and MP are n and m padded to
// multiples of 4 (at most 32 and 64). Rows and columns past m and n are
// zero and inert.
template <int NP, int MP>
__global__ void __launch_bounds__(32) admm_batched_reg_kernel(
    const float* __restrict__ Kinv, const float* __restrict__ A,
    const float* __restrict__ q, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ rho,
    const float* __restrict__ w0, const float* __restrict__ y0,
    float* __restrict__ w_out, float* __restrict__ y_out, int n, int m,
    int iters, float sigma, float alpha) {
  static_assert(NP % 4 == 0 && NP <= 32 && MP % 4 == 0 && MP <= 64,
                "register form sizes");
  constexpr int MR = (MP + 31) / 32;  // rows of A a lane
  __shared__ __align__(16) float st[MP];  // t = rho z - y
  __shared__ __align__(16) float sr[NP];  // rhs
  __shared__ __align__(16) float sx[NP];  // w0, then x~
  const int lane = threadIdx.x;
  const long b = blockIdx.x;
  const float* gA = A + b * m * n;
  const float* gK = Kinv + b * n * n;
  const bool col = lane < n;

  float at[MP], kc[NP], ar[MR][NP];
  float lo[MR], hi[MR], rh[MR], z[MR], y[MR];
#pragma unroll
  for (int j = 0; j < MP; ++j) at[j] = col && j < m ? gA[j * n + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) kc[k] = col && k < n ? gK[k * n + lane] : 0.f;
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int j = lane + 32 * a;
    const bool in = j < m;
    lo[a] = in ? l[b * m + j] : 0.f;
    hi[a] = in ? u[b * m + j] : 0.f;
    rh[a] = in ? rho[j] : 1.f;
    y[a] = in ? y0[b * m + j] : 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) ar[a][k] = in && k < n ? gA[j * n + k] : 0.f;
  }
  float w = col ? w0[b * n + lane] : 0.f;
  const float qv = col ? q[b * n + lane] : 0.f;

  if (lane < NP) sx[lane] = w;
  __syncwarp();
#pragma unroll
  for (int a = 0; a < MR; ++a)  // z0 = clip(A w0, l, u)
    z[a] = clip(dot<NP>(ar[a], sx), lo[a], hi[a]);

  const float one_m_alpha = 1.f - alpha;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int a = 0; a < MR; ++a)
      if (lane + 32 * a < MP) st[lane + 32 * a] = rh[a] * z[a] - y[a];
    __syncwarp();
    const float rhs = sigma * w - qv + dot<MP>(at, st);  // A^T t
    if (lane < NP) sr[lane] = rhs;
    __syncwarp();
    const float x = dot<NP>(kc, sr);  // K^-1 rhs
    if (lane < NP) sx[lane] = x;
    w = alpha * x + one_m_alpha * w;
    __syncwarp();
#pragma unroll
    for (int a = 0; a < MR; ++a) {  // z~ = A x~ and the row updates
      const float z_rel = alpha * dot<NP>(ar[a], sx) + one_m_alpha * z[a];
      const float z_new = clip(z_rel + y[a] / rh[a], lo[a], hi[a]);
      y[a] = y[a] + rh[a] * (z_rel - z_new);
      z[a] = z_new;
    }
  }
  if (col) w_out[b * n + lane] = w;
#pragma unroll
  for (int a = 0; a < MR; ++a)
    if (lane + 32 * a < m) y_out[b * m + lane + 32 * a] = y[a];
}

// The register form a QP takes (1: padded to n=24, m=48; 2: to n=32,
// m=64), or 0 where it takes the shared form.
__host__ __device__ inline int reg_form(int n, int m, int elem_size) {
  if (elem_size != 4) return 0;
  if (n <= 24 && m <= 48) return 1;
  if (n <= 32 && m <= 64) return 2;
  return 0;
}

// The shared form: one warp per QP, matrices resident in shared memory.
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

template <int NP, int MP>
int launch_reg(const float* Kinv, const float* A, const float* q,
               const float* l, const float* u, const float* rho,
               const float* w0, const float* y0, float* w_out, float* y_out,
               int B, int n, int m, int iters, double sigma, double alpha,
               void* stream) {
  admm_batched_reg_kernel<NP, MP><<<(unsigned)B, 32, 0,
                                    (cudaStream_t)stream>>>(
      Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, n, m, iters,
      (float)sigma, (float)alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int B,
           int n, int m, int iters, double sigma, double alpha,
           void* stream) {
  const size_t per = qp_elems(n, m) * sizeof(T);
  if (per > kMaxSmem) return -1;
  if (B <= 0) return 0;
  if constexpr (sizeof(T) == 4) {
    switch (reg_form(n, m, 4)) {
      case 1:
        return launch_reg<24, 48>(Kinv, A, q, l, u, rho, w0, y0, w_out,
                                  y_out, B, n, m, iters, sigma, alpha,
                                  stream);
      case 2:
        return launch_reg<32, 64>(Kinv, A, q, l, u, rho, w0, y0, w_out,
                                  y_out, B, n, m, iters, sigma, alpha,
                                  stream);
    }
  }
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

// 1 where a QP of n variables and m rows in elements of elem_size bytes
// takes the register form, 0 where it takes the shared form.
int admm_batched_form(int n, int m, int elem_size) {
  return reg_form(n, m, elem_size) != 0;
}

// Shared-memory bytes one QP needs in the shared form; the wrapper
// dispatches by it.
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
