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
// 3.35 TB/s) and the work ~120 MFLOP (under 2 us at 67 TFLOP/s). Each
// iteration is a chain of three dependent mat-vecs, so the time is the
// latency of that chain times the iteration count, unless enough QPs are
// in flight to cover it. Each form below shortens that chain for its
// shapes.
//
// Two forms, chosen by a rule on (n, m, element size) (admm_batched_form;
// ops/admm_batched.py batched_form mirrors it):
//
// - registers (float32, n <= 32, m <= 64: the condensed LOCP and the SSM
//   LOCP at n=24, m=1): one warp per QP, with A, A^T and K^-1 in registers
//   for all iterations, compile-time sized and fully unrolled. Lane i holds
//   column i of A (for A^T t) and of K^-1 (row i: it is symmetric), lane j
//   rows j and j + 32 of A (for A x~). Each mat-vec is then 20-64 FMAs on
//   one lane's own registers, in four independent chains, against a vector
//   that the warp reads from shared memory as 16-byte broadcasts; only the
//   vectors t, rhs and x~ cross lanes, through shared memory and
//   __syncwarp. The chain of an iteration is three such mat-vecs and the
//   row updates, a few hundred cycles; 1024 QPs are 8 warps an SM. In
//   float64 the three copies would not fit a lane's 255 registers.
// - block (every other QP that fits a block): one block of up to 1024
//   threads per QP; K^-1, A and the iterates are copied into shared memory
//   once and stay there (the Pallas kernel's VMEM residency). A^T t:
//   thread (g, c) sums column c over the rows g, g + G, ... of A, and n
//   threads add the G partials; K^-1 x-step: thread i walks column i of
//   K^-1 (it is symmetric); A x~: a row a thread. Every walk runs in four
//   interleaved chains (admm_matvec.cuh). A thread's share of an
//   iteration is then about m / G + G + 2 n multiply-adds and four block
//   barriers: at GuSTO's condensed LOCP (n=21, m=641, G=32) about 94.
//   A warp per QP, with lane i walking row i of each mat-vec and all m
//   rows of A^T t in one serial sum, does 1,100 there; it was slower than
//   this form at every float32 shape of the port's paths (PERF.md). Threads and G come from the QP's
//   size, its element size and B (block_threads, block_groups): enough for
//   a row of A each and for about sqrt(m) row groups, as few as let the
//   blocks the batch puts on an SM all be resident.
//   The x-step runs in float64 whatever the QP's type: K^-1 and rhs are
//   kept in shared memory as float64 (widened exactly), their products
//   are exact, and x~ is rounded to the QP's type once. On the Diamond
//   SSM's sparse LOCPs K^-1 reaches 1.8e5 and the float32 sum of its n
//   terms cancels to x~ of order 1: summed in float32 that step put the
//   block form's float32 error against float64 at 2.03x the plain
//   version's (chip_smoke.py phase 14 on an H100; its limit is 2), in
//   float64 at 0.03x. The other two walks stay in the QP's type; nothing is
//   rounded to fewer bits than it. rhs and x~ are read 16 bytes a load, so
//   the wider K^-1 costs little shared-memory bandwidth in all.
//
// In the block form A is stored with an odd row stride so that both its
// row and its column reads are free of bank conflicts. The launcher
// refuses (returns -1) when one QP's footprint does not fit a block's
// shared memory. Any B works, including B = 1.
#include <cuda_runtime.h>
#include <stddef.h>

#include "admm_matvec.cuh"

namespace {

using admm::clip;

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kMaxThreads = 1024;
constexpr int kSMs = 132;            // H100 SXM

enum BatchedForm { kBlock = 0, kRegisters = 1 };

__host__ __device__ inline int a_stride(int n) { return n | 1; }

// len rounded up to whole 16 bytes of elements of elem_size bytes
__host__ __device__ inline size_t up16(size_t len, int elem_size) {
  const size_t w = 16 / elem_size;
  return (len + w - 1) / w * w;
}

// bytes of one QP's shared-memory region in the block form, without the
// partials of A^T t: K^-1 (n*n) and rhs (n) in float64, then x~ (n), A
// (m*stride), q, w (n each), l, u, z, y, t, rho (m each) in the QP's type;
// rhs and x~ start on 16 bytes (the walks read them 16 bytes a load)
__host__ __device__ inline size_t qp_bytes(int n, int m, int elem_size) {
  return (up16((size_t)n * n, 8) + up16(n, 8)) * sizeof(double) +
         (up16(n, elem_size) + (size_t)m * a_stride(n) + 2 * (size_t)n +
          6 * (size_t)m) *
             (size_t)elem_size;
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
// m=64), or 0 where it does not take it.
__host__ __device__ inline int reg_form(int n, int m, int elem_size) {
  if (elem_size != 4) return 0;
  if (n <= 24 && m <= 48) return 1;
  if (n <= 32 && m <= 64) return 2;
  return 0;
}

// Rows g, g + G, ... below m: the rows of row group g.
__device__ inline int group_rows(int m, int g, int G) {
  return g < m ? (m - g + G - 1) / G : 0;
}

// The block form: one QP a block, matrices resident in shared memory, the
// mat-vecs split over the block's threads; G > 1 row groups in A^T t.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) admm_block_kernel(
    const T* __restrict__ Kinv, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha,
    int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long b = blockIdx.x;
  const int lda = a_stride(n);
  double* sK = reinterpret_cast<double*>(smem_raw);  // K^-1, widened
  double* sr = sK + up16((size_t)n * n, 8);           // rhs, widened
  T* sx = reinterpret_cast<T*>(sr + up16(n, 8));      // x~
  T* sA = sx + up16(n, sizeof(T));
  T* sq = sA + (size_t)m * lda;
  T* sw = sq + n;
  T* sl = sw + n;
  T* su = sl + m;
  T* sz = su + m;
  T* sy = sz + m;
  T* st = sy + m;   // rho z - y
  T* sp = st + m;   // rho
  T* part = sp + m;  // G partials of A^T t, n each (G > 1)

  const T* gK = Kinv + b * n * n;
  const T* gA = A + b * m * n;
  for (int i = tid; i < n * n; i += nthr) sK[i] = (double)gK[i];
  for (int i = tid; i < m * n; i += nthr) {
    const int r = i / n;
    sA[r * lda + (i - r * n)] = gA[i];
  }
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
  for (int j = tid; j < m; j += nthr) {
    const T z = clip(admm::dot(sA + (size_t)j * lda, 1, sw, 1, n), sl[j],
                     su[j]);
    sz[j] = z;
    st[j] = sp[j] * z - sy[j];
  }
  __syncthreads();

  const int g = tid / n, c = tid - g * n;  // A^T t: row group g, column c
  const int g_rows = group_rows(m, g, G);
  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    if (G > 1) {  // rhs = sigma w - q + A^T t
      if (g < G)
        part[g * n + c] = admm::dot(sA + (size_t)g * lda + c, G * lda,
                                    st + g, G, g_rows);
      __syncthreads();
      for (int i = tid; i < n; i += nthr)
        sr[i] = (double)(sigma * sw[i] - sq[i] + admm::sum(part + i, n, G));
    } else {
      for (int i = tid; i < n; i += nthr)
        sr[i] = (double)(sigma * sw[i] - sq[i] +
                         admm::dot(sA + i, lda, st, 1, m));
    }
    __syncthreads();
    for (int i = tid; i < n; i += nthr) {  // x~ = K^-1 rhs (column walk)
      const T x = (T)admm::dot_v(sK + i, n, sr, n);
      sx[i] = x;
      sw[i] = alpha * x + one_m_alpha * sw[i];
    }
    __syncthreads();
    for (int j = tid; j < m; j += nthr) {  // z~ = A x~ and the row updates
      const T zt = admm::dot_v(sA + (size_t)j * lda, 1, sx, n);
      const T z_rel = alpha * zt + one_m_alpha * sz[j];
      const T z_new = clip(z_rel + sy[j] / sp[j], sl[j], su[j]);
      const T y_new = sy[j] + sp[j] * (z_rel - z_new);
      sy[j] = y_new;
      sz[j] = z_new;
      st[j] = sp[j] * z_new - y_new;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += nthr) w_out[b * n + i] = sw[i];
  for (int j = tid; j < m; j += nthr) y_out[b * m + j] = sy[j];
}

// Threads of the block form for B QPs of n variables and m rows in
// elements of elem_size bytes: a row of A each and n columns in about
// sqrt(m) row groups, a multiple of 32 from 64 to 1024; and no more than
// let the blocks that the batch puts on an SM (B / kSMs, or as many as
// their shared memory allows) be resident together, at the kernel's 64
// registers a thread (65,536 an SM).
inline int block_threads(int B, int n, int m, int elem_size) {
  int groups = 1;
  while (groups * groups < m) ++groups;
  int t = admm::round_up_32(n * groups > m ? n * groups : m);
  const size_t qp = qp_bytes(n, m, elem_size);
  const int fit = qp < kMaxSmem ? (int)(kMaxSmem / qp) : 1;
  const int want = B > kSMs ? (B + kSMs - 1) / kSMs : 1;
  const int per_sm = want < fit ? want : fit;
  const int cap = (kMaxThreads / per_sm) & ~31;
  if (t > cap) t = cap;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

// Row groups of the block form's A^T t: as many as `threads` hold, at most
// m, and no more than the shared memory left beside the QP holds partials.
inline int block_groups(int n, int m, int threads, int elem_size) {
  int G = threads / n;
  if (G > m) G = m;
  const size_t qp = qp_bytes(n, m, elem_size);
  const size_t room = qp < kMaxSmem ? kMaxSmem - qp : 0;
  const size_t fit = room / ((size_t)n * elem_size);
  if ((size_t)G > fit) G = (int)fit;
  return G < 1 ? 1 : G;
}

inline size_t block_bytes(int n, int m, int G, int elem_size) {
  return qp_bytes(n, m, elem_size) +
         (G > 1 ? (size_t)G * n * elem_size : 0);
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
int launch_block(const T* Kinv, const T* A, const T* q, const T* l,
                 const T* u, const T* rho, const T* w0, const T* y0,
                 T* w_out, T* y_out, int B, int n, int m, int iters,
                 double sigma, double alpha, void* stream) {
  const int threads = block_threads(B, n, m, sizeof(T));
  const int G = block_groups(n, m, threads, sizeof(T));
  const size_t smem = block_bytes(n, m, G, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      admm_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  admm_block_kernel<T><<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, n, m, iters, (T)sigma,
      (T)alpha, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
           const T* rho, const T* w0, const T* y0, T* w_out, T* y_out, int B,
           int n, int m, int iters, double sigma, double alpha, void* stream) {
  if (qp_bytes(n, m, sizeof(T)) > kMaxSmem) return -1;
  if (B <= 0) return 0;
  if constexpr (sizeof(T) == 4) {
    switch (reg_form(n, m, 4)) {
      case 1:
        return launch_reg<24, 48>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out,
                                  B, n, m, iters, sigma, alpha, stream);
      case 2:
        return launch_reg<32, 64>(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out,
                                  B, n, m, iters, sigma, alpha, stream);
    }
  }
  return launch_block(Kinv, A, q, l, u, rho, w0, y0, w_out, y_out, B, n, m,
                      iters, sigma, alpha, stream);
}

}  // namespace

extern "C" {

// The form of a QP of n variables and m rows in elements of elem_size
// bytes that fits a block: 0 block, 1 registers.
int admm_batched_form(int n, int m, int elem_size) {
  return reg_form(n, m, elem_size) ? kRegisters : kBlock;
}

// The block form's layout for that batch: out[0] threads a block, out[1]
// row groups G, out[2] bytes of shared memory a block.
void admm_batched_block_layout(int B, int n, int m, int elem_size,
                               int* out) {
  out[0] = block_threads(B, n, m, elem_size);
  out[1] = block_groups(n, m, out[0], elem_size);
  out[2] = (int)block_bytes(n, m, out[1], elem_size);
}

// Shared-memory bytes one QP needs in the block form without its partials;
// the wrapper dispatches by it.
size_t admm_batched_qp_bytes(int n, int m, int elem_size) {
  return qp_bytes(n, m, elem_size);
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
