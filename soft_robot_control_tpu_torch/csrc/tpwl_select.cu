// TPWL nearest-point select and gather for a batch of states.
//
// Replaces the TPU kernel soft_robot_control_tpu/ops/pallas_tpwl.py
// _select_kernel (entry tpwl_gather_pallas). For each state x = [v; q] of
// B, the weighted distance  w_q ||q - q_i|| + w_v ||v - v_i||  to all P
// dictionary points, the argmin with ties broken toward the lowest index,
// and a copy of the selected point's flattened A_d (n*n), B_d (n*m) and
// d_d (n) rows. It also returns the index, through which the caller fetches
// any other per-point array (the DARE gains of the MPC).
//
// It computes the same function by the exact form: the distances are taken
// by direct differences, as TPWLModel.point_distances does
// (models/tpwl.py:179-184) and as the JAX main path selects. The Pallas
// kernel's squared-norm expansion |a|^2 - 2ab + |b|^2 existed to feed the
// MXU and loses digits near ties; it is not used here. The Pallas kernel's
// one-hot matmul gather is a TPU device as well: here the selected rows
// are copied.
//
// What bounds it on an H100: bytes. At the main path's P=1087, r=30, n=60,
// m=4 the gathered rows are 15.6 KB a state in f32, written once: 80 MB for
// the plan's 5120 states, against ~1 GFLOP of distance arithmetic. The
// design keeps everything else off device memory: the (P, r) dictionary
// (261 KB for q and v in f32, more than one block's 227 KB) streams through
// shared memory in tiles of 128 points, one point a thread, with an odd row
// stride so that the threads' reads are free of bank conflicts. A block
// serves 8 states, whose coordinates sit in shared memory and are read as
// broadcasts; each thread keeps a running (distance, index) minimum per
// state in registers, visiting its points in increasing order. The block
// then reduces the pairs by warp shuffles and across warps, and copies the
// selected rows with consecutive threads on consecutive addresses.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kStates = 8;           // states per block
constexpr int kTile = 128;           // dictionary points per tile = threads
constexpr int kWarps = kTile / 32;

__host__ __device__ inline int tile_stride(int r) { return r | 1; }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int r) {
  return sizeof(T) * ((size_t)kStates * 2 * r +         // states
                      2 * (size_t)kTile * tile_stride(r) +  // q, v tile
                      (size_t)kStates * kWarps) +       // per-warp minima
         sizeof(int) * ((size_t)kStates * kWarps + kStates);
}

template <typename T>
__device__ inline bool better(T d1, int i1, T d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

template <typename T>
__global__ void tpwl_select_kernel(
    const T* __restrict__ x, const T* __restrict__ qp,
    const T* __restrict__ vp, const T* __restrict__ Af,
    const T* __restrict__ Bf, const T* __restrict__ df, int B, int P, int r,
    int nA, int nB, int nd, T wq, T wv, int64_t* __restrict__ idx_out,
    T* __restrict__ A_out, T* __restrict__ B_out, T* __restrict__ d_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_stride(r);
  T* sx = reinterpret_cast<T*>(smem_raw);    // (kStates, 2r): [v; q]
  T* tq = sx + kStates * 2 * r;              // (kTile, ld)
  T* tv = tq + kTile * ld;                   // (kTile, ld)
  T* red_d = tv + kTile * ld;                // (kStates, kWarps)
  int* red_i = reinterpret_cast<int*>(red_d + kStates * kWarps);
  int* sel = red_i + kStates * kWarps;       // (kStates,)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long b0 = (long)blockIdx.x * kStates;
  const int ns = (long)B - b0 < kStates ? (int)((long)B - b0) : kStates;

  for (int e = tid; e < kStates * 2 * r; e += kTile) {
    const int s = e / (2 * r);
    sx[e] = s < ns ? x[b0 * 2 * r + e] : T(0);
  }

  T best_d[kStates];
  int best_i[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    best_d[s] = INFINITY;
    best_i[s] = P;
  }

  for (int p0 = 0; p0 < P; p0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    const int np = min(kTile, P - p0);
    for (int e = tid; e < np * r; e += kTile) {
      const int pt = e / r;
      const int c = e - pt * r;
      tq[pt * ld + c] = qp[(size_t)p0 * r + e];
      tv[pt * ld + c] = vp[(size_t)p0 * r + e];
    }
    __syncthreads();
    if (tid < np) {
      T dq[kStates], dv[kStates];
#pragma unroll
      for (int s = 0; s < kStates; ++s) dq[s] = dv[s] = T(0);
      for (int j = 0; j < r; ++j) {
        const T pq = tq[tid * ld + j];
        const T pv = tv[tid * ld + j];
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          const T eq = pq - sx[s * 2 * r + r + j];
          const T ev = pv - sx[s * 2 * r + j];
          dq[s] += eq * eq;
          dv[s] += ev * ev;
        }
      }
      const int p = p0 + tid;
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        const T d = wq * sqrt(dq[s]) + wv * sqrt(dv[s]);
        if (d < best_d[s]) {  // points arrive in increasing order
          best_d[s] = d;
          best_i[s] = p;
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    T d = best_d[s];
    int i = best_i[s];
    for (int off = 16; off > 0; off >>= 1) {
      const T d2 = __shfl_down_sync(0xffffffffu, d, off);
      const int i2 = __shfl_down_sync(0xffffffffu, i, off);
      if (better(d2, i2, d, i)) {
        d = d2;
        i = i2;
      }
    }
    if (lane == 0) {
      red_d[s * kWarps + warp] = d;
      red_i[s * kWarps + warp] = i;
    }
  }
  __syncthreads();
  if (tid < kStates) {
    T d = red_d[tid * kWarps];
    int i = red_i[tid * kWarps];
    for (int w = 1; w < kWarps; ++w) {
      if (better(red_d[tid * kWarps + w], red_i[tid * kWarps + w], d, i)) {
        d = red_d[tid * kWarps + w];
        i = red_i[tid * kWarps + w];
      }
    }
    // no finite distance (a NaN state): index 0, as torch.argmin gives
    sel[tid] = i < P ? i : 0;
  }
  __syncthreads();

  for (int s = 0; s < ns; ++s) {
    const long b = b0 + s;
    const long i = sel[s];
    if (tid == 0) idx_out[b] = i;
    for (int e = tid; e < nA; e += kTile) A_out[b * nA + e] = Af[i * nA + e];
    for (int e = tid; e < nB; e += kTile) B_out[b * nB + e] = Bf[i * nB + e];
    for (int e = tid; e < nd; e += kTile) d_out[b * nd + e] = df[i * nd + e];
  }
}

template <typename T>
int launch(const T* x, const T* qp, const T* vp, const T* Af, const T* Bf,
           const T* df, int B, int P, int r, int nA, int nB, int nd,
           double wq, double wv, int64_t* idx, T* A_out, T* B_out, T* d_out,
           void* stream) {
  const size_t smem = smem_bytes<T>(r);
  if (smem > kMaxSmem || P <= 0) return -1;
  if (B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      tpwl_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + kStates - 1) / kStates);
  tpwl_select_kernel<T><<<grid, kTile, smem, (cudaStream_t)stream>>>(
      x, qp, vp, Af, Bf, df, B, P, r, nA, nB, nd, (T)wq, (T)wv, idx, A_out,
      B_out, d_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t tpwl_select_smem_bytes(int r, int elem_size) {
  return elem_size == 8 ? smem_bytes<double>(r) : smem_bytes<float>(r);
}

int tpwl_select_f32(const float* x, const float* qp, const float* vp,
                    const float* Af, const float* Bf, const float* df, int B,
                    int P, int r, int nA, int nB, int nd, double wq,
                    double wv, int64_t* idx, float* A_out, float* B_out,
                    float* d_out, void* stream) {
  return launch<float>(x, qp, vp, Af, Bf, df, B, P, r, nA, nB, nd, wq, wv,
                       idx, A_out, B_out, d_out, stream);
}

int tpwl_select_f64(const double* x, const double* qp, const double* vp,
                    const double* Af, const double* Bf, const double* df,
                    int B, int P, int r, int nA, int nB, int nd, double wq,
                    double wv, int64_t* idx, double* A_out, double* B_out,
                    double* d_out, void* stream) {
  return launch<double>(x, qp, vp, Af, Bf, df, B, P, r, nA, nB, nd, wq, wv,
                        idx, A_out, B_out, d_out, stream);
}

}  // extern "C"
