// TPWL nearest-point select and gather for a batch of states.
//
// Replaces the TPU kernel soft_robot_control_tpu/ops/pallas_tpwl.py
// _select_kernel (entry tpwl_gather_pallas). For each state x = [v; q] of
// B, the weighted distance  w_q ||q - q_i|| + w_v ||v - v_i||  to all P
// dictionary points, the argmin with ties broken toward the lowest index,
// and a copy of the selected point's flattened A_d (n*n), B_d (n*m) and
// d_d (n) rows. The first `index_only` states get their index and no rows:
// row k of the outputs belongs to state index_only + k. The index is also
// how the caller fetches any other per-point array (the DARE gains).
//
// It computes the same function by the exact form: the distances are taken
// by direct differences, as TPWLModel.point_distances does
// (models/tpwl.py:179-184) and as the JAX main path selects. The Pallas
// kernel's squared-norm expansion |a|^2 - 2ab + |b|^2 existed to feed the
// MXU and loses digits near ties; it is not used here. The Pallas kernel's
// one-hot matmul gather is a TPU device as well: here the selected rows
// are copied, bit for bit.
//
// What bounds it on an H100: bytes, then FP32 issue. At the main path's
// P=1087, r=30, n=60, m=4 the gathered rows are 15.6 KB a state in f32,
// written once: 80 MB for the plan's 5120 states (27 us at 3.35 TB/s). The
// distances are two instructions (subtract, fused multiply-add) per
// coordinate, state and point: 0.67 G instructions at B=5120, 20 us at the
// card's 128 FP32 lanes an SM.
//
// Design. A thread-block cluster of R blocks serves kS = 64 states. The
// states sit in each block's shared memory, and block `rank` walks the
// dictionary tiles rank, rank + R, ... of kPT = 64 points each, so the
// dictionary is read once per 64 states (80 times at B=5120, a quarter of a
// megabyte each, from L2). R (at most 8) is chosen at launch as the fewest
// blocks that give every SM two (4 at B=5120, 6 at B=3072, 8 at B=1):
// fewer, longer blocks pay the staging and the reductions less often. The
// states and the tiles of q and v arrive by 16-byte cp.async copies, the
// tiles double-buffered behind the arithmetic. Each thread holds a
// kTS x kTP register micro-tile (8 states x 4 points): for every two
// coordinates (one where r is odd) 16 loads of states and 8 of points, each
// a broadcast or free of bank conflicts, feed 256 arithmetic instructions.
// The shared-memory pipe delivers 32 values a cycle to an SM and its FP32
// lanes take 128 operations, so the loads still cost three quarters of the
// arithmetic's issue time. A thread keeps a running (distance, index)
// minimum per state, visiting its points in increasing order; the block
// reduces them by warp shuffles and across warps, and the cluster combines
// its blocks' partials through distributed shared memory in rank order,
// comparing (distance, index) pairs, so ties go to the lowest index
// whatever the split. Then all R * 128 threads of the cluster copy the
// selected rows of the states that need them with 16-byte loads and
// stores; a view that is not on 16-byte ends, or a row length that is not a
// multiple of 16 bytes, is copied element by element in the same kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;       // blocks a cluster: the split of P
constexpr int kS = 64;               // states a cluster
constexpr int kTS = 8;               // states a thread: sg + kSG * a
constexpr int kTP = 4;               // points a thread: pg + kPG * i
constexpr int kSG = 8;               // state groups: the low 3 lane bits
constexpr int kPG = kThreads / kSG;  // point groups: 16
constexpr int kPT = kPG * kTP;       // points a tile: 64
static_assert(kSG * kTS == kS && 32 % kSG == 0, "thread layout");

// Shared memory, in this order: the states (kS x 2r), two stages of (q, v)
// tiles (kPT x r each), the per-warp minima (kWarps x kS) and the block's
// partial (kS) as T, then the same indices and the selection as int. Every
// T array starts on a 16-byte end.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int r) {
  return sizeof(T) * ((size_t)kS * 2 * r + 4 * (size_t)kPT * r +
                      (size_t)kWarps * kS + kS) +
         sizeof(int) * ((size_t)kWarps * kS + 2 * kS);
}

template <typename T>
__device__ inline bool better(T d1, int i1, T d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `elems` consecutive elements of src into shared memory at dst, by
// 16-byte cp.async where `vec` (both ends of every 16-byte piece aligned),
// the tail and the unaligned case by plain loads and stores.
template <typename T>
__device__ inline void load_tile(T* dst, const T* src, int elems, bool vec) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int nv = elems / V;
    for (int c = threadIdx.x; c < nv; c += kThreads)
      cp_async16(dst + c * V, src + c * V);
    done = nv * V;
  }
  for (int e = done + threadIdx.x; e < elems; e += kThreads) dst[e] = src[e];
}

// Rows of `len` elements: dst row k <- src row sel[k] for k < nr, spread
// over the cluster's threads (`t` of `nt`), 16-byte pieces where `vec`,
// four in flight a thread. A cluster's rows hold fewer than 2^31 pieces.
template <typename T>
__device__ inline void copy_rows(const T* __restrict__ src,
                                 T* __restrict__ dst, int len,
                                 const int* sel, int nr, int t, int nt,
                                 bool vec) {
  if (vec) {
    const unsigned lv = len / (16 / sizeof(T));
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const unsigned total = (unsigned)nr * lv;
    for (unsigned e0 = t; e0 < total; e0 += 4u * nt) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned e = e0 + u * nt;
        if (e < total) {
          const unsigned k = e / lv;
          v[u] = s4[(size_t)sel[k] * lv + (e - k * lv)];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned e = e0 + u * nt;
        if (e < total) d4[e] = v[u];
      }
    }
    return;
  }
  const unsigned total = (unsigned)nr * len;
  for (unsigned e = t; e < total; e += nt) {
    const unsigned k = e / len;
    dst[e] = src[(size_t)sel[k] * len + (e - k * len)];
  }
}

// Loads W consecutive elements of shared memory (8- or 16-byte aligned
// where W = 2).
template <int W, typename T>
__device__ __forceinline__ void load_w(const T* p, T* o) {
  if constexpr (W == 2) {
    using T2 = typename std::conditional<sizeof(T) == 4, float2,
                                         double2>::type;
    const T2 v = *reinterpret_cast<const T2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

// The squared differences of one tile, coordinates j = 0..r-1 in order,
// W at a time: states sg + kSG * a (rows of xs, 2r apart, [v; q]) against
// points pg + kPG * i (rows of tq and tv, r apart).
template <int W, typename T>
__device__ __forceinline__ void accumulate(const T* xs, const T* tq,
                                           const T* tv, int r,
                                           T (&dq)[kTS][kTP],
                                           T (&dv)[kTS][kTP]) {
#pragma unroll 1
  for (int j = 0; j < r; j += W) {
    T sv[kTS][W], sq[kTS][W], pv[kTP][W], pq[kTP][W];
#pragma unroll
    for (int a = 0; a < kTS; ++a) {
      load_w<W>(xs + a * kSG * 2 * r + j, sv[a]);
      load_w<W>(xs + a * kSG * 2 * r + r + j, sq[a]);
    }
#pragma unroll
    for (int i = 0; i < kTP; ++i) {
      load_w<W>(tq + i * kPG * r + j, pq[i]);
      load_w<W>(tv + i * kPG * r + j, pv[i]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int a = 0; a < kTS; ++a)
#pragma unroll
        for (int i = 0; i < kTP; ++i) {
          const T eq = pq[i][w] - sq[a][w];
          const T ev = pv[i][w] - sv[a][w];
          dq[a][i] += eq * eq;
          dv[a][i] += ev * ev;
        }
  }
}

// Bits of `vec`: 1 dictionary tiles and 16 states by cp.async, 2 / 4 / 8
// rows of A / B / d by 16-byte pieces.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 1)
    tpwl_select_kernel(
    const T* __restrict__ x, const T* __restrict__ qp,
    const T* __restrict__ vp, const T* __restrict__ Af,
    const T* __restrict__ Bf, const T* __restrict__ df, int B, int P, int r,
    int nA, int nB, int nd, int index_only, T wq, T wv, int vec,
    int64_t* __restrict__ idx_out, T* __restrict__ A_out,
    T* __restrict__ B_out, T* __restrict__ d_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int R = (int)cluster.num_blocks();
  const int tile_elems = kPT * r;
  T* sx = reinterpret_cast<T*>(smem_raw);   // (kS, 2r): [v; q] a row
  T* tiles = sx + kS * 2 * r;                // stage s: q at 2s, v at 2s+1
  T* red_d = tiles + 4 * tile_elems;         // (kWarps, kS)
  T* part_d = red_d + kWarps * kS;           // (kS,)
  int* red_i = reinterpret_cast<int*>(part_d + kS);
  int* part_i = red_i + kWarps * kS;
  int* sel = part_i + kS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sg = tid % kSG;
  const int pg = tid / kSG;
  const long b0 = (long)(blockIdx.x / R) * kS;
  const int ns = (long)B - b0 < kS ? (int)((long)B - b0) : kS;
  const int ntiles = (P + kPT - 1) / kPT;
  const int nk = ntiles > rank ? (ntiles - rank + R - 1) / R : 0;
  const bool vec_tiles = vec & 1;
  // two coordinates a load where every row starts on a pair's end
  const bool pairs = r % 2 == 0;

  // the states (rows past the batch are left as they are: their minima
  // are never read) and this block's first tile, in one group
  load_tile(sx, x + b0 * 2 * r, ns * 2 * r, vec & 16);
  if (nk > 0) {
    const int p0 = rank * kPT;
    const int np = min(kPT, P - p0);
    load_tile(tiles, qp + (size_t)p0 * r, np * r, vec_tiles);
    load_tile(tiles + tile_elems, vp + (size_t)p0 * r, np * r, vec_tiles);
  }
  cp_async_commit();

  T best_d[kTS];
  int best_i[kTS];
#pragma unroll
  for (int a = 0; a < kTS; ++a) {
    best_d[a] = INFINITY;
    best_i[a] = P;
  }

  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {  // the next tile into the other stage
      const int p0 = (rank + (k + 1) * R) * kPT;
      const int np = min(kPT, P - p0);
      T* st = tiles + 2 * ((k + 1) & 1) * tile_elems;
      load_tile(st, qp + (size_t)p0 * r, np * r, vec_tiles);
      load_tile(st + tile_elems, vp + (size_t)p0 * r, np * r, vec_tiles);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k (and the states) visible to every thread
    const T* tq = tiles + 2 * (k & 1) * tile_elems + pg * r;
    const T* tv = tq + tile_elems;
    const T* xs = sx + sg * 2 * r;  // states sg + kSG * a
    T dq[kTS][kTP], dv[kTS][kTP];
#pragma unroll
    for (int a = 0; a < kTS; ++a)
#pragma unroll
      for (int i = 0; i < kTP; ++i) dq[a][i] = dv[a][i] = T(0);
    if (pairs)
      accumulate<2>(xs, tq, tv, r, dq, dv);
    else
      accumulate<1>(xs, tq, tv, r, dq, dv);
    const int pbase = (rank + k * R) * kPT + pg;
#pragma unroll
    for (int i = 0; i < kTP; ++i) {  // this thread's points in order
      const int p = pbase + kPG * i;
#pragma unroll
      for (int a = 0; a < kTS; ++a) {
        const T d = wq * sqrt(dq[a][i]) + wv * sqrt(dv[a][i]);
        if (p < P && d < best_d[a]) {
          best_d[a] = d;
          best_i[a] = p;
        }
      }
    }
    __syncthreads();  // stage k & 1 is refilled at the next step
  }

  // the block's minimum per state: over the point groups of a warp (lanes
  // that share sg), then over the warps
#pragma unroll
  for (int a = 0; a < kTS; ++a) {
    T d = best_d[a];
    int i = best_i[a];
    for (int off = kSG; off < 32; off <<= 1) {
      const T d2 = __shfl_xor_sync(0xffffffffu, d, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(d2, i2, d, i)) {
        d = d2;
        i = i2;
      }
    }
    if (lane < kSG) {
      red_d[warp * kS + sg + kSG * a] = d;
      red_i[warp * kS + sg + kSG * a] = i;
    }
  }
  __syncthreads();
  if (tid < kS) {
    T d = red_d[tid];
    int i = red_i[tid];
    for (int w = 1; w < kWarps; ++w) {
      if (better(red_d[w * kS + tid], red_i[w * kS + tid], d, i)) {
        d = red_d[w * kS + tid];
        i = red_i[w * kS + tid];
      }
    }
    part_d[tid] = d;
    part_i[tid] = i;
  }
  cluster.sync();  // every block's partial written and visible

  if (tid < kS) {
    T d = INFINITY;
    int i = P;
    for (int q = 0; q < R; ++q) {
      const T d2 = *cluster.map_shared_rank(part_d + tid, q);
      const int i2 = *cluster.map_shared_rank(part_i + tid, q);
      if (better(d2, i2, d, i)) {
        d = d2;
        i = i2;
      }
    }
    // no finite distance (a NaN state): index 0, as torch.argmin gives
    sel[tid] = i < P ? i : 0;
    if (rank == 0 && tid < ns) idx_out[b0 + tid] = sel[tid];
  }
  // the peers' partials are read: let them leave once they have copied
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();  // sel visible to the block

  const long s_lo = index_only > b0 ? index_only - b0 : 0;
  if (s_lo < ns) {
    const int nr = ns - (int)s_lo;
    const long row0 = b0 + s_lo - index_only;
    const int t = rank * kThreads + tid;
    const int nt = R * kThreads;
    copy_rows(Af, A_out + row0 * nA, nA, sel + s_lo, nr, t, nt, vec & 2);
    copy_rows(Bf, B_out + row0 * nB, nB, sel + s_lo, nr, t, nt, vec & 4);
    copy_rows(df, d_out + row0 * nd, nd, sel + s_lo, nr, t, nt, vec & 8);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const T* x, const T* qp, const T* vp, const T* Af, const T* Bf,
           const T* df, int B, int P, int r, int nA, int nB, int nd,
           int index_only, double wq, double wv, int64_t* idx, T* A_out,
           T* B_out, T* d_out, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = smem_bytes<T>(r);
  if (smem > kMaxSmem || P <= 0 || r <= 0 || index_only < 0 ||
      index_only > B)
    return -1;
  if (B <= 0) return 0;
  auto rows_vec = [&](const T* src, const T* dst, int len) {
    return aligned16(src) && aligned16(dst) && len % V == 0;
  };
  const int vec = (aligned16(qp) && aligned16(vp) ? 1 : 0) |
                  (aligned16(x) ? 16 : 0) |
                  (rows_vec(Af, A_out, nA) ? 2 : 0) |
                  (rows_vec(Bf, B_out, nB) ? 4 : 0) |
                  (rows_vec(df, d_out, nd) ? 8 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      tpwl_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // blocks a cluster: the fewest that give every SM two blocks, at most
  // one a tile and kMaxCluster (fewer, longer blocks pay the staging and
  // the reductions less often; below two an SM the card idles)
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int clusters = (B + kS - 1) / kS;
  const int ntiles = (P + kPT - 1) / kPT;
  const int R = std::max(1, std::min({(2 * sms + clusters - 1) / clusters,
                                      kMaxCluster, ntiles}));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tpwl_select_kernel<T>, x, qp, vp, Af, Bf,
                           df, B, P, r, nA, nB, nd, index_only, (T)wq,
                           (T)wv, vec, idx, A_out, B_out, d_out);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

size_t tpwl_select_smem_bytes(int r, int elem_size) {
  return elem_size == 8 ? smem_bytes<double>(r) : smem_bytes<float>(r);
}

int tpwl_select_f32(const float* x, const float* qp, const float* vp,
                    const float* Af, const float* Bf, const float* df, int B,
                    int P, int r, int nA, int nB, int nd, int index_only,
                    double wq, double wv, int64_t* idx, float* A_out,
                    float* B_out, float* d_out, void* stream) {
  return launch<float>(x, qp, vp, Af, Bf, df, B, P, r, nA, nB, nd,
                       index_only, wq, wv, idx, A_out, B_out, d_out, stream);
}

int tpwl_select_f64(const double* x, const double* qp, const double* vp,
                    const double* Af, const double* Bf, const double* df,
                    int B, int P, int r, int nA, int nB, int nd,
                    int index_only, double wq, double wv, int64_t* idx,
                    double* A_out, double* B_out, double* d_out,
                    void* stream) {
  return launch<double>(x, qp, vp, Af, Bf, df, B, P, r, nA, nB, nd,
                        index_only, wq, wv, idx, A_out, B_out, d_out,
                        stream);
}

}  // extern "C"
