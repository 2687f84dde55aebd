// Fixed-iteration ADMM with one QP resident across the shared memory of a
// thread-block cluster: the part that admm_cluster.cu (K^-1 form, a batch
// of QPs) and admm_single.cu (M1 form, one QP) have in common.
//
// A cluster of R blocks takes one QP. Block r owns a contiguous slice of
// the rows of A and of K^-1 (or M1), copied from device memory once and
// kept in its shared memory for all iterations, and the same slice of l,
// u, z, y, rho. The n-vectors q, w, rhs, x~ are replicated in every block.
// One iteration, with t = rho z - y already formed for the block's rows:
//   1. partial of A^T t over the block's rows, walked by columns and sent
//      straight into the shared memory of the blocks that need it
//      (distributed shared memory), one slot per sender;
//   2. rhs = sigma w - q + the R slots, in rank order;
//   3. K^-1 form: partial K^-1[rows_r, :]^T rhs[rows_r] by columns (K^-1 is
//      symmetric, so the partials add up to K^-1 rhs; rhs is needed at the
//      block's own rows only, so step 1 sends each element to one block).
//      M1 form: s[rows_r] = M1[rows_r, :] rhs by rows, then the partial
//      M1[rows_r, :]^T s[rows_r] by columns; it needs only the block's own
//      slice of s, so nothing is exchanged between the two passes. Either
//      way the partial is sent to every block's slots;
//   4. x~ = the R slots; w = alpha x~ + (1-alpha) w;
//   5. z~[rows_r] = A[rows_r, :] x~ by rows, then the z, y, t updates.
//
// The two exchanges an iteration are what the design turns on. A cluster
// barrier with release and acquire (cluster.sync()) costs 0.74 us on an
// H100 whatever the cluster's size, 0.66 us of it the fence; a relaxed one
// 0.08 us. So the partials travel as asynchronous remote stores (st.async)
// that credit their bytes to a transaction barrier (mbarrier) in the
// receiving block, which waits until all R senders' bytes are in: data and
// signal go one way, with no fence and no cluster barrier inside the loop.
// A store a lane is still dear (760 of them and as many barrier updates an
// exchange), so where the rows allow 16-byte pieces the block first gathers
// its partial in its own shared memory and then sends it with one bulk copy
// (cp.async.bulk, shared memory to a peer's shared memory) per destination.
// A slot is safe against its sender's next write without a further signal:
// a block sends its x~ partial of iteration k+1 only after it has all rhs
// partials of k+1, which every peer sent after it had read the x~ slots of
// k; and likewise with the roles swapped. For that every block must own a
// row of K^-1, which the plan sees to by lowering R. One cluster barrier
// before the loop makes sure that every block runs, with its barriers
// armed, before a peer sends to it, and one after the loop that no block
// leaves early. Every block sums the slots in the same order, so the
// replicated vectors stay bitwise equal. Bounds are only compared against,
// never multiplied, so they may be infinite.
//
// Both walks read consecutive addresses across a warp, 16 bytes a thread
// where the row length allows it (V elements a load). By columns a warp
// owns 128 bytes of columns and all the slice's rows: its lanes split the
// rows (four ways at 16 bytes a lane) and add up by shuffles, so no partial
// passes through shared memory. By rows a warp takes four rows at a time,
// shares the loads of the vector between them, and reduces the four sums
// together. No transposed copy exists. Where the matrices do not fit the
// cluster's shared memory (`kResident` false) every block walks its slice
// in place in device memory, through L2: the rows are still spread over R
// SMs.
#pragma once
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "admm_matvec.cuh"

namespace admm_cluster {

namespace cg = cooperative_groups;

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on Hopper
constexpr int kThreads = 768;  // 512 to 1024 differ by 5% on an H100
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr size_t kBarrierBytes = 16;  // two mbarriers ahead of the arrays
constexpr long long kWaitCycles = 4000000000LL;  // ~2 s: a lost signal traps

enum Form { kKinv = 0, kM1 = 1 };

// How one QP is laid over a cluster. The Python wrapper mirrors make_plan
// (ops/admm_batched.py: cluster_plan); the card tests hold the two equal.
struct Plan {
  int R;         // blocks in the cluster
  int V;         // elements a vector load (16 bytes, or 1 for ragged rows)
  int mr, nr;    // rows of A, of K^-1 (M1) a block owns; the last fewer
  int resident;  // matrices in shared memory (1) or walked in place (0)
  int bulk;      // partials sent as bulk copies (1) or element by element
  size_t smem;   // bytes of dynamic shared memory a block
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Widest vector load the row length allows.
inline int vector_width(int n, int elem) {
  const int v = 16 / elem;
  return n % v == 0 ? v : 1;
}

// Rows [lo, hi) of `rows` that block `rank` of a cluster of R owns.
__host__ __device__ inline void row_slice(int rows, int R, int rank, int& lo,
                                          int& hi) {
  const int per = ceil_div(rows, R);
  lo = rank * per < rows ? rank * per : rows;
  hi = lo + per < rows ? lo + per : rows;
}

// The largest cluster of at most R blocks in which every block owns a row
// of the n rows of K^-1 (see the note on the exchanges above).
inline int usable_cluster(int n, int R) {
  while (R > 1 && (R - 1) * ceil_div(n, R) >= n) --R;
  return R;
}

// Elements of the slots that receive the partials of A^T t: rhs is needed
// at the block's own rows of K^-1 only, or, in the M1 form, in full.
// Rounded up to a multiple of 4, so that what follows stays 16-byte aligned.
__host__ __device__ inline size_t rhs_slot_elems(int n, int nr, int R,
                                                 int form) {
  return ((size_t)R * (form == kM1 ? n : nr) + 3) / 4 * 4;
}

// The plan for a cluster of at most R blocks; false when a block's share
// does not fit its shared memory. Shared memory of a block: two mbarriers,
// its slices of A and K^-1 (resident only), q, w, rhs, x~ and the block's
// own two partials (n each), the R slots of x~ partials (n each) and of rhs
// partials, l, u, z, y, t, rho (mr each) and, in the M1 form, s (nr). Bulk
// copies need every piece to start and end on 16 bytes.
inline bool make_plan(int n, int m, int elem, int R, int V, int form,
                      bool resident, Plan* p) {
  R = usable_cluster(n, R);
  p->R = R;
  p->V = V;
  p->mr = ceil_div(m, R);
  p->nr = ceil_div(n, R);
  p->resident = resident ? 1 : 0;
  p->bulk = V * elem == 16 && p->nr % V == 0;
  const size_t elems =
      (resident ? ((size_t)p->mr + p->nr) * n : 0) + (6 + (size_t)R) * n +
      rhs_slot_elems(n, p->nr, R, form) + 6 * (size_t)p->mr +
      (form == kM1 ? p->nr : 0);
  p->smem = kBarrierBytes + elems * (size_t)elem;
  return p->smem <= kMaxSmem;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// Start the copy of `count` elements (a multiple of V) into shared memory:
// 16-byte asynchronous copies where V allows, plain loads otherwise. The
// caller waits with __pipeline_wait_prior(0) and a block barrier.
template <typename T, int V>
__device__ __forceinline__ void copy_slice(T* dst, const T* __restrict__ src,
                                           size_t count) {
  if constexpr (V * sizeof(T) == 16) {
    for (size_t i = (size_t)threadIdx.x * V; i < count;
         i += (size_t)blockDim.x * V)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
  } else {
    for (size_t i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// ---- the exchange: remote stores that signal a transaction barrier ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address, in the cluster's shared-memory window, of this block's
// shared address `addr` in block `rank`.
__device__ __forceinline__ uint32_t remote_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void barrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// The one arrival of a phase, with the bytes the phase is to receive.
__device__ __forceinline__ void barrier_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has all its bytes: warp 0 polls
// the barrier while the other warps rest at the block barrier, so that
// their polling does not compete with warps that still work; thread 0 then
// arms the next phase with the `bytes` it is to receive. A signal that
// never comes ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity,
                                             uint32_t bytes) {
  if (threadIdx.x < 32) {
    const long long t0 = clock64();
    for (;;) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
      if (done) break;
      if (clock64() - t0 > kWaitCycles) __trap();
    }
    if (threadIdx.x == 0) barrier_expect(bar, bytes);
  }
  __syncthreads();
}

// Store V elements at the cluster address `dst` and credit their bytes to
// the mbarrier at the cluster address `bar` of the same block.
template <typename T, int V>
__device__ __forceinline__ void send(uint32_t dst, const Vec<T, V>& x,
                                     uint32_t bar) {
  if constexpr (sizeof(T) == 4 && V == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];"
        ::"r"(dst), "r"(__float_as_uint(x.v[0])), "r"(__float_as_uint(x.v[1])),
        "r"(__float_as_uint(x.v[2])), "r"(__float_as_uint(x.v[3])), "r"(bar)
        : "memory");
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 1, "f32 goes 4 or 1 elements a store");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
        "[%0], %1, [%2];"
        ::"r"(dst), "r"(__float_as_uint(x.v[0])), "r"(bar) : "memory");
  } else if constexpr (V == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 "
        "[%0], {%1, %2}, [%3];"
        ::"r"(dst), "l"(__double_as_longlong(x.v[0])),
        "l"(__double_as_longlong(x.v[1])), "r"(bar) : "memory");
  } else {
    static_assert(V == 1, "f64 goes 2 or 1 elements a store");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 "
        "[%0], %1, [%2];"
        ::"r"(dst), "l"(__double_as_longlong(x.v[0])), "r"(bar) : "memory");
  }
}

// Make this thread's writes to shared memory visible to the bulk copies
// that a thread of the block starts after the next block barrier.
__device__ __forceinline__ void fence_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) of this
// block's shared memory to the cluster address `dst` and credit them to the
// mbarrier at the cluster address `bar` of the same block.
__device__ __forceinline__ void send_bulk(uint32_t dst, uint32_t src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- the walks ----

// Lanes of a warp in the column walk: kCols lanes side by side cover 128
// bytes of a row, and kRows such groups split the rows between them.
template <typename T, int V>
struct Lanes {
  static constexpr int kCols =
      128 / (V * sizeof(T)) < 32 ? 128 / (V * sizeof(T)) : 32;
  static constexpr int kRows = 32 / kCols;
};

// emit(c, g, acc) with acc[k] = sum_r M[r, c + k] v[r], k < V, for every
// chunk of V columns from c: a warp owns the columns of 128 bytes and all
// the rows, its kRows lane groups take every kRows-th row and add up by
// shuffles, and each group g calls emit with the full sum.
template <typename T, int V, typename F>
__device__ __forceinline__ void walk_cols(const T* M, int rows, int cols,
                                          const T* v, F emit) {
  constexpr int kCols = Lanes<T, V>::kCols, kRows = Lanes<T, V>::kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const int lc = lane % kCols, g = lane / kCols;
  for (int base = warp * kCols * V; base < cols; base += nwarp * kCols * V) {
    const int c = base + lc * V;
    Vec<T, V> acc;
#pragma unroll
    for (int k = 0; k < V; ++k) acc.v[k] = 0;
    if (c < cols) {
#pragma unroll 4
      for (int r = g; r < rows; r += kRows) {
        const Vec<T, V> a = load_vec<T, V>(M + (size_t)r * cols + c);
        const T vr = v[r];
#pragma unroll
        for (int k = 0; k < V; ++k) acc.v[k] += a.v[k] * vr;
      }
    }
#pragma unroll
    for (int off = kCols; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc.v[k] += __shfl_xor_sync(0xffffffffu, acc.v[k], off);
    if (c < cols) emit(c, g, acc);
  }
}

// emit(r, sum_c M[r, c] v[c]) for every row r: a warp takes rows 4w to
// 4w+3 together, lanes along the row V elements at a time, so that one load
// of v serves four rows; the four sums are reduced together (halving the
// values a lane carries at each of the first two shuffle steps), and four
// lanes call emit, one row each.
template <typename T, int V, typename F>
__device__ __forceinline__ void walk_rows(const T* M, int rows, int cols,
                                          const T* v, F emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int r = 4 * warp; r < rows; r += 4 * nwarp) {
    const T* row[4];
    T acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[k] = M + (size_t)(r + k < rows ? r + k : rows - 1) * cols;
      acc[k] = 0;
    }
#pragma unroll 2
    for (int c = lane * V; c < cols; c += 32 * V) {
      const Vec<T, V> x = load_vec<T, V>(v + c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Vec<T, V> a = load_vec<T, V>(row[k] + c);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[k] += a.v[e] * x.v[e];
      }
    }
    // lanes 0-15 go on with rows 0 and 1, lanes 16-31 with rows 2 and 3
    const bool up = lane & 16;
    T a0 = (up ? acc[2] : acc[0]) +
           __shfl_xor_sync(0xffffffffu, up ? acc[0] : acc[2], 16);
    T a1 = (up ? acc[3] : acc[1]) +
           __shfl_xor_sync(0xffffffffu, up ? acc[1] : acc[3], 16);
    // of those, lanes with bit 3 clear go on with the first row
    const bool odd = lane & 8;
    T a = (odd ? a1 : a0) + __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 8);
    for (int off = 4; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    const int k = (up ? 2 : 0) + (odd ? 1 : 0);
    if ((lane & 7) == 0 && r + k < rows) emit(r + k, a);
  }
}

// Send the chunk `acc` of V elements from column c into slot `rank` (n
// elements a slot, `slots` this block's shared address of slot 0) of every
// block of the cluster; the kRows lane groups that hold the chunk share the
// R destinations between them.
template <typename T, int V>
__device__ __forceinline__ void send_all(uint32_t slots, uint32_t bar, int R,
                                         int rank, int n, int c, int g,
                                         const Vec<T, V>& acc) {
  const uint32_t at = slots + (uint32_t)(((size_t)rank * n + c) * sizeof(T));
  for (int dst = g; dst < R; dst += Lanes<T, V>::kRows)
    send<T, V>(remote_addr(at, dst), acc, remote_addr(bar, dst));
}

// Sum, in rank order, of element i of the R slots of `len` elements each.
template <typename T>
__device__ __forceinline__ T slots_sum(const T* slots, int R, int len,
                                       int i) {
  T x[kMaxCluster];  // all loads in flight before the first addition
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    x[r] = r < R ? slots[(size_t)r * len + i] : T(0);
  T acc = x[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r)
    if (r < R) acc += x[r];
  return acc;
}

// One QP on the calling cluster; every thread of every block of the
// cluster calls it with the same arguments, the pointers at the QP's own
// data. K is K^-1 (kForm = kKinv, symmetric) or M1 (kForm = kM1).
template <typename T, int V, int kForm, bool kResident>
__device__ __forceinline__ void solve(
    const T* __restrict__ K, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha,
    const Plan& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = p.R, nr = p.nr;
  const bool bulk = p.bulk;
  const int rank = (int)cluster.block_rank();
  int a_lo, a_hi, k_lo, k_hi;
  row_slice(m, R, rank, a_lo, a_hi);
  row_slice(n, R, rank, k_lo, k_hi);
  const int ma = a_hi - a_lo, nk = k_hi - k_lo;
  const int tid = threadIdx.x, nthr = blockDim.x;

  const uint32_t rs_bar = smem_addr(smem_raw);  // rhs partials are in
  const uint32_t xs_bar = rs_bar + 8;           // x~ partials are in
  T* sA = reinterpret_cast<T*>(smem_raw + kBarrierBytes);
  T* sK = sA + (kResident ? (size_t)p.mr * n : 0);
  T* sq = sK + (kResident ? (size_t)p.nr * n : 0);
  T* sw = sq + n;
  T* sr = sw + n;   // rhs: the block's rows of K^-1, or all in the M1 form
  T* sx = sr + n;   // x~
  T* pa = sx + n;   // this block's partial of A^T t, gathered for a bulk copy
  T* pk = pa + n;   // this block's partial of x~, likewise
  T* xs = pk + n;   // R slots of n: the blocks' partials of x~
  T* rs = xs + (size_t)R * n;  // R slots: the blocks' partials of A^T t
  T* sl = rs + rhs_slot_elems(n, nr, R, kForm);
  T* su = sl + p.mr;
  T* sz = su + p.mr;
  T* sy = sz + p.mr;
  T* st = sy + p.mr;  // rho z - y
  T* sp = st + p.mr;  // rho
  T* ss = sp + p.mr;  // M1 rhs, the block's rows (M1 form only)
  const uint32_t xs_at = smem_addr(xs), rs_at = smem_addr(rs);
  // bytes a phase receives: from each of the R blocks, its partial of x~,
  // and its partial of rhs at this block's rows (all rows in the M1 form)
  const uint32_t xs_bytes = (uint32_t)(R * n * sizeof(T));
  const uint32_t rs_bytes =
      (uint32_t)(R * (kForm == kM1 ? n : nk) * sizeof(T));
  if (tid == 0) {
    barrier_init(rs_bar);
    barrier_init(xs_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    barrier_expect(rs_bar, rs_bytes);
    barrier_expect(xs_bar, xs_bytes);
  }

  const T* mA = A + (size_t)a_lo * n;
  const T* mK = K + (size_t)k_lo * n;
  if constexpr (kResident) {
    copy_slice<T, V>(sA, mA, (size_t)ma * n);
    copy_slice<T, V>(sK, mK, (size_t)nk * n);
    mA = sA;
    mK = sK;
  }
  for (int i = tid; i < n; i += nthr) {
    sq[i] = q[i];
    sw[i] = w0[i];
  }
  for (int j = tid; j < ma; j += nthr) {
    sl[j] = l[a_lo + j];
    su[j] = u[a_lo + j];
    sy[j] = y0[a_lo + j];
    sp[j] = rho[a_lo + j];
  }
  if constexpr (kResident && V * sizeof(T) == 16) __pipeline_wait_prior(0);
  __syncthreads();
  walk_rows<T, V>(mA, ma, n, sw, [&](int j, T acc) {
    const T z = admm::clip(acc, sl[j], su[j]);
    sz[j] = z;
    st[j] = sp[j] * z - sy[j];
  });
  cluster.sync();  // every block runs, barriers armed, before a peer sends

  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    const uint32_t parity = it & 1;
    // A^T t over the block's rows, sent to where rhs is formed
    walk_cols<T, V>(mA, ma, n, st, [&](int c, int g, const Vec<T, V>& acc) {
      if (bulk) {
        if (g == 0) *reinterpret_cast<Vec<T, V>*>(pa + c) = acc;
      } else if constexpr (kForm == kM1) {
        send_all<T, V>(rs_at, rs_bar, R, rank, n, c, g, acc);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {  // lane group g sends element k
          if (k % Lanes<T, V>::kRows != g) continue;
          const int owner = (c + k) / nr;
          const size_t at = (size_t)rank * nr + c + k - owner * nr;
          Vec<T, 1> x;
          x.v[0] = acc.v[k];
          send<T, 1>(remote_addr(rs_at + (uint32_t)(at * sizeof(T)), owner),
                     x, remote_addr(rs_bar, owner));
        }
      }
    });
    if (bulk) {
      fence_for_bulk();
      __syncthreads();
      if (tid < R) {  // thread r sends block r what it needs of the partial
        int lo = 0, hi = n;
        if constexpr (kForm == kKinv) row_slice(n, R, tid, lo, hi);
        const int len = kForm == kM1 ? n : nr;
        send_bulk(
            remote_addr(rs_at + (uint32_t)((size_t)rank * len * sizeof(T)),
                        tid),
            smem_addr(pa + lo), (uint32_t)((hi - lo) * sizeof(T)),
            remote_addr(rs_bar, tid));
      }
    }
    barrier_wait(rs_bar, parity, rs_bytes);
    // the partial of x~ from the block's rows of K^-1 (M1), sent to all
    const auto to_all = [&](int c, int g, const Vec<T, V>& acc) {
      if (bulk) {
        if (g == 0) *reinterpret_cast<Vec<T, V>*>(pk + c) = acc;
      } else {
        send_all<T, V>(xs_at, xs_bar, R, rank, n, c, g, acc);
      }
    };
    if constexpr (kForm == kM1) {
      for (int i = tid; i < n; i += nthr)
        sr[i] = sigma * sw[i] - sq[i] + slots_sum(rs, R, n, i);
      __syncthreads();
      walk_rows<T, V>(mK, nk, n, sr, [&](int i, T acc) { ss[i] = acc; });
      __syncthreads();
      walk_cols<T, V>(mK, nk, n, ss, to_all);  // M1^T s, own rows
    } else {
      for (int j = tid; j < nk; j += nthr)
        sr[j] = sigma * sw[k_lo + j] - sq[k_lo + j] + slots_sum(rs, R, nr, j);
      __syncthreads();
      walk_cols<T, V>(mK, nk, n, sr, to_all);  // K^-1[rows, :]^T rhs[rows]
    }
    if (bulk) {
      fence_for_bulk();
      __syncthreads();
      if (tid < R)
        send_bulk(remote_addr(
                      xs_at + (uint32_t)((size_t)rank * n * sizeof(T)), tid),
                  smem_addr(pk), (uint32_t)(n * sizeof(T)),
                  remote_addr(xs_bar, tid));
    }
    barrier_wait(xs_bar, parity, xs_bytes);
    for (int i = tid; i < n; i += nthr) {
      const T x = slots_sum(xs, R, n, i);
      sx[i] = x;
      sw[i] = alpha * x + one_m_alpha * sw[i];
    }
    __syncthreads();
    walk_rows<T, V>(mA, ma, n, sx, [&](int j, T zt) {  // A x~, own rows
      const T z_rel = alpha * zt + one_m_alpha * sz[j];
      const T z_new = admm::clip(z_rel + sy[j] / sp[j], sl[j], su[j]);
      const T y_new = sy[j] + sp[j] * (z_rel - z_new);
      sy[j] = y_new;
      sz[j] = z_new;
      st[j] = sp[j] * z_new - y_new;
    });
    __syncthreads();
  }
  if (rank == 0)
    for (int i = tid; i < n; i += nthr) w_out[i] = sw[i];
  for (int j = tid; j < ma; j += nthr) y_out[a_lo + j] = sy[j];
  cluster.sync();  // no block leaves while a peer may still send to it
}

// The launch of `kernel` as B clusters of p.R blocks: sets the kernel's
// shared-memory limit and fills cfg and attr. Returns the CUDA error.
template <typename... Params>
cudaError_t cluster_config(void (*kernel)(Params...), const Plan& p, int B,
                           void* stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * (unsigned)p.R);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
}

// Launch `kernel` as B clusters of p.R blocks. Returns the CUDA error.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), const Plan& p, int B,
                    void* stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, p, B, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

// Clusters of p.R blocks of `kernel` that the card holds at one time, or
// minus the CUDA error.
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), const Plan& p) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, p, 1024, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return -(int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : clusters;
}

// Fill out[0..6] with a plan for the wrappers and tests: R, V, mr, nr,
// resident, bulk, bytes of shared memory a block.
inline void export_plan(const Plan& p, int* out) {
  out[0] = p.R;
  out[1] = p.V;
  out[2] = p.mr;
  out[3] = p.nr;
  out[4] = p.resident;
  out[5] = p.bulk;
  out[6] = (int)p.smem;
}

inline bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

}  // namespace admm_cluster
