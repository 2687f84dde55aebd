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
//      into the shared memory of the blocks that need it (distributed
//      shared memory), one slot per sender;
//   2. rhs = sigma w - q + the R slots, in rank order;
//   3. K^-1 form: partial K^-1[rows_r, :]^T rhs[rows_r] by columns (K^-1 is
//      symmetric, so the partials add up to K^-1 rhs; rhs is needed at the
//      block's own rows only, so step 1 sends each block a window of the
//      partial around its rows).
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
// 0.08 us. So the partials travel as asynchronous copies that credit their
// bytes to a transaction barrier (mbarrier) in the receiving block, which
// waits until all R senders' bytes are in: data and signal go one way, with
// no fence and no cluster barrier inside the loop. A block gathers its
// partial in its own shared memory and sends it with one bulk copy
// (cp.async.bulk, shared memory to a peer's shared memory) per destination.
// A bulk copy moves 16-byte pieces between 16-byte boundaries, so every
// n-vector is laid out over nw = n rounded up to 16 bytes, and the window
// of the A^T t partial that a block receives (its rows of K^-1) is widened
// to 16-byte boundaries on both sides: any n and any slicing goes this way,
// with R copies a block an exchange where an element-by-element exchange
// would take a remote store and a barrier credit an element.
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
// together. No transposed copy exists. How much of a block's slices stays
// in its shared memory is the plan's residency (kRes): all of it (kAll:
// kernel 3's cluster form; kernel 4 where it fits), none (kNone: kernel 4
// in f64 at n=380, every block walking its slices in place in device
// memory, through L2), or as many leading rows as the block's shared
// memory holds, rows of A first, since A is walked twice an iteration and
// K^-1 once (kSome: kernel 3's streaming form, admm_stream.cu), the rows
// left over walked in place. Either way the rows are spread over R SMs.
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
// Which rows of a block's slices stay in its shared memory.
enum Residency { kNone = 0, kAll = 1, kSome = 2 };

// How one QP is laid over a cluster. The Python wrapper mirrors make_plan
// (ops/admm_batched.py: cluster_plan); the card tests hold the two equal.
struct Plan {
  int R;         // blocks in the cluster
  int V;         // elements a vector load (16 bytes, or 1 for ragged rows)
  int mr, nr;    // rows of A, of K^-1 (M1) a block owns; the last fewer
  int resident;  // all of the slices in shared memory (1) or not (0)
  size_t smem;   // bytes of dynamic shared memory a block
  int ra, rk;    // leading rows of the A, K^-1 (M1) slice in shared memory
  int xwin;      // x~ partials received in windows, then gathered (1)
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

// Elements in 16 bytes, and len rounded up to a multiple of them: every
// piece of a bulk copy starts and ends on 16 bytes.
__host__ __device__ inline int per16(int elem) { return 16 / elem; }
__host__ __device__ inline int up16(int len, int elem) {
  const int w = per16(elem);
  return (len + w - 1) / w * w;
}

// Elements of one sender's slot of A^T t partials: the window around the
// receiver's rows of K^-1, widened to 16-byte boundaries (at most nr +
// 2 (w - 1) elements), or, in the M1 form, the whole n-vector.
__host__ __device__ inline int rhs_slot(int n, int nr, int elem, int form) {
  return form == kM1 ? up16(n, elem) : up16(nr + 2 * (per16(elem) - 1), elem);
}

// The window [lo, hi) of the A^T t partial that block `rank` receives: its
// rows of K^-1 widened to 16-byte boundaries.
__host__ __device__ inline void rhs_window(int n, int R, int rank, int elem,
                                           int& lo, int& hi) {
  row_slice(n, R, rank, lo, hi);
  lo = lo / per16(elem) * per16(elem);
  hi = up16(hi, elem);
}

// Row stride of the resident rows: kSome pads each row with zeros to nw (n
// rounded up to 16 bytes), so that its walks read 16 bytes a load whatever
// n is; kAll keeps the rows as they are in device memory.
__host__ __device__ inline int row_stride(int n, int elem, int residency) {
  return residency == kSome ? up16(n, elem) : n;
}

// Bytes ahead of the arrays: two mbarriers, or three with the x~ gather.
__host__ __device__ inline size_t barrier_bytes(int xwin) {
  return xwin ? 2 * kBarrierBytes : kBarrierBytes;
}

// The plan for a cluster of at most R blocks with the given residency;
// false when a block's share does not fit its shared memory. Shared memory
// of a block: the mbarriers; the resident rows of its slices of A and K^-1
// (row_stride each), the region padded to 16 bytes; q, w, rhs, x~ and the
// block's own two partials (nw each); the R slots of x~ partials (nw each)
// and of A^T t partials (rhs_slot each); l, u, z, y, t, rho (mr each) and,
// in the M1 form, s (nr). kSome keeps as many rows as the rest leaves room
// for, rows of A first. Where kSome's vectors do not fit that way (n = m
// past about 1,840 in f64), its x~ slots shrink to the A^T t slots'
// windows (xwin): a block receives of each peer's x~ partial only the
// window around its own rows, sums it, and sends its finished rows of x~
// to every peer, a third exchange an iteration (about 8.75 n elements at
// n = m, up to about 3,300 in f64 and 6,600 in f32).
inline bool make_plan(int n, int m, int elem, int R, int V, int form,
                      int residency, Plan* p) {
  R = usable_cluster(n, R);
  p->R = R;
  p->V = V;
  p->mr = ceil_div(m, R);
  p->nr = ceil_div(n, R);
  const size_t nw = up16(n, elem);
  const size_t slot = rhs_slot(n, p->nr, elem, form);
  const size_t rest = 6 * (size_t)p->mr + (form == kM1 ? p->nr : 0);
  size_t vec = (6 + (size_t)R) * nw + (size_t)R * slot + rest;
  p->xwin = 0;
  if (residency == kSome && form == kKinv &&
      vec > (kMaxSmem - barrier_bytes(0)) / (size_t)elem) {
    p->xwin = 1;
    vec = 6 * nw + 2 * (size_t)R * slot + rest;
  }
  const size_t bar = barrier_bytes(p->xwin);
  const size_t room = (kMaxSmem - bar) / (size_t)elem;
  const int sld = row_stride(n, elem, residency);
  if (vec > room) return false;
  size_t rows = residency == kAll    ? (size_t)p->mr + p->nr
                : residency == kNone ? 0
                                     : (room - vec) / nw;
  p->ra = (int)(rows < (size_t)p->mr ? rows : (size_t)p->mr);
  rows -= p->ra;
  p->rk = (int)(rows < (size_t)p->nr ? rows : (size_t)p->nr);
  p->resident = p->ra == p->mr && p->rk == p->nr;
  p->smem = bar + (up16((p->ra + p->rk) * sld, elem) + vec) * (size_t)elem;
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

// Start the copy of `rows` rows of n elements at src (row stride n) into
// shared memory at dst (row stride sld >= n, the padding set to zero):
// 16-byte asynchronous copies where the rows allow them (kGV elements of
// 16 bytes, sld == n), element by element otherwise. The caller waits with
// __pipeline_wait_prior(0) and a block barrier.
template <typename T, int kGV>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src,
                                          int rows, int n, int sld) {
  const size_t count = (size_t)rows * sld;
  if constexpr (kGV * sizeof(T) == 16) {
    for (size_t i = (size_t)threadIdx.x * kGV; i < count;
         i += (size_t)blockDim.x * kGV)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
  } else {
    for (size_t i = threadIdx.x; i < count; i += blockDim.x) {
      const size_t r = i / sld, c = i - r * sld;
      dst[i] = c < (size_t)n ? src[r * n + c] : T(0);
    }
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

// The rows of a block's slice of a row-major matrix with n columns: rows
// [0, res) in shared memory at `sm` with row stride sld (zero past n), the
// rest in place at `gm` with row stride n; kRes fixes the split where it is
// all or none. load<V>(r, c) reads the V elements from column c of row r:
// one 16-byte load from shared memory, from device memory one load of kGV
// elements where that is V, else element by element, zero past n.
template <typename T, int kRes, int kGV>
struct Rows {
  const T* sm;
  const T* gm;
  int res;
  int sld;
  int n;
  template <int V>
  __device__ __forceinline__ Vec<T, V> sload(int r, int c) const {
    return load_vec<T, V>(sm + (size_t)r * sld + c);
  }
  template <int V>
  __device__ __forceinline__ Vec<T, V> gload(int r, int c) const {
    const T* p = gm + (size_t)r * n + c;
    if constexpr (kGV == V) {
      return load_vec<T, V>(p);
    } else {
      Vec<T, V> a;
#pragma unroll
      for (int k = 0; k < V; ++k) a.v[k] = c + k < n ? p[k] : T(0);
      return a;
    }
  }
  template <int V>
  __device__ __forceinline__ Vec<T, V> load(int r, int c) const {
    if constexpr (kRes == kAll) return this->template sload<V>(r, c);
    else if constexpr (kRes == kNone) return this->template gload<V>(r, c);
    else
      return r < res ? this->template sload<V>(r, c)
                     : this->template gload<V>(r, c);
  }
};

// Lanes of a warp in the column walk: kCols lanes side by side cover 128
// bytes of a row, and kRows such groups split the rows between them.
template <typename T, int V>
struct Lanes {
  static constexpr int kCols =
      128 / (V * sizeof(T)) < 32 ? 128 / (V * sizeof(T)) : 32;
  static constexpr int kRows = 32 / kCols;
};

// acc += a b; with kComp compensated (Kahan): c carries what the sum's
// rounding lost, so that a lane's long sum in f32 rounds about as often as
// one addition does.
template <bool kComp, typename T>
__device__ __forceinline__ void add_prod(T& acc, T& c, T a, T b) {
  if constexpr (kComp) {
    const T y = a * b - c;
    const T t = acc + y;
    c = (t - acc) - y;
    acc = t;
  } else {
    acc += a * b;
  }
}

// emit(c, g, acc) with acc[k] = sum_r M[r, c + k] v[r], k < V, for every
// chunk of V columns from c: a warp owns the columns of 128 bytes and all
// the rows, its kRows lane groups take every kRows-th row (add_prod<kComp>)
// and add up by shuffles, and each group g calls emit with the full sum. A
// chunk may reach past `cols` into the rows' zero padding; emit takes it
// whole.
template <typename T, int V, bool kComp, typename M_, typename F>
__device__ __forceinline__ void walk_cols(const M_& M, int rows, int cols,
                                          const T* v, F emit) {
  constexpr int kCols = Lanes<T, V>::kCols, kRows = Lanes<T, V>::kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const int lc = lane % kCols, g = lane / kCols;
  for (int base = warp * kCols * V; base < cols; base += nwarp * kCols * V) {
    const int c = base + lc * V;
    Vec<T, V> acc, cmp;
#pragma unroll
    for (int k = 0; k < V; ++k) acc.v[k] = cmp.v[k] = 0;
    if (c < cols) {
#pragma unroll 4
      for (int r = g; r < rows; r += kRows) {
        const Vec<T, V> a = M.template load<V>(r, c);
        const T vr = v[r];
#pragma unroll
        for (int k = 0; k < V; ++k)
          add_prod<kComp>(acc.v[k], cmp.v[k], a.v[k], vr);
      }
    }
    if constexpr (kComp) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc.v[k] -= cmp.v[k];
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
// lanes call emit, one row each (a lane's products summed by
// add_prod<kComp>). v is read up to the chunk's end, past `cols` where the
// rows are padded: it must hold zeros there.
template <typename T, int V, bool kComp, typename M_, typename F>
__device__ __forceinline__ void walk_rows(const M_& M, int rows, int cols,
                                          const T* v, F emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int r = 4 * warp; r < rows; r += 4 * nwarp) {
    int row[4];
    T acc[4], cmp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[k] = r + k < rows ? r + k : rows - 1;
      acc[k] = cmp[k] = 0;
    }
#pragma unroll 2
    for (int c = lane * V; c < cols; c += 32 * V) {
      const Vec<T, V> x = load_vec<T, V>(v + c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Vec<T, V> a = M.template load<V>(row[k], c);
#pragma unroll
        for (int e = 0; e < V; ++e)
          add_prod<kComp>(acc[k], cmp[k], a.v[e], x.v[e]);
      }
    }
    if constexpr (kComp) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] -= cmp[k];
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
// data. K is K^-1 (kForm = kKinv, symmetric) or M1 (kForm = kM1). kXW is
// the plan's xwin: x~ partials received in windows and the finished rows
// gathered (kKinv only). The QPs that take it are those whose vectors
// leave no room for full slots, so their rows are long (n = m past 3,684
// in f32): their f32 walks sum with compensation (kComp). With plain sums
// the kernel's f32 error grew with n faster than cuBLAS's (up to 2.18x the
// plain f32 version's at n = m = 6,624 on QPs with P of rank 64, 0.40x to
// 0.65x compensated; PERF.md).
template <typename T, int kGV, int kForm, int kRes, bool kXW = false>
__device__ __forceinline__ void solve(
    const T* __restrict__ K, const T* __restrict__ A,
    const T* __restrict__ q, const T* __restrict__ l,
    const T* __restrict__ u, const T* __restrict__ rho,
    const T* __restrict__ w0, const T* __restrict__ y0, T* __restrict__ w_out,
    T* __restrict__ y_out, int n, int m, int iters, T sigma, T alpha,
    const Plan& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kElem = sizeof(T);
  // the walks' vector width: 16 bytes on kSome's padded rows, else what
  // the rows in device memory allow
  constexpr int V = kRes == kSome ? 16 / kElem : kGV;
  constexpr bool kComp = kXW && kElem == 4;
  const int R = p.R, nr = p.nr, nw = up16(n, kElem);
  const int sld = row_stride(n, kElem, kRes);
  const int rank = (int)cluster.block_rank();
  int a_lo, a_hi, k_lo, k_hi, w_lo, w_hi;
  row_slice(m, R, rank, a_lo, a_hi);
  row_slice(n, R, rank, k_lo, k_hi);
  rhs_window(n, R, rank, kElem, w_lo, w_hi);
  const int ma = a_hi - a_lo, nk = k_hi - k_lo;
  const int tid = threadIdx.x, nthr = blockDim.x;

  const uint32_t rs_bar = smem_addr(smem_raw);  // rhs partials are in
  const uint32_t xs_bar = rs_bar + 8;           // x~ partials are in
  const uint32_t xg_bar = rs_bar + 16;         // x~ rows are in (kXW)
  T* sA = reinterpret_cast<T*>(smem_raw + barrier_bytes(kXW));
  T* sK = sA + (size_t)p.ra * sld;  // ra = mr, rk = nr (kAll); 0 (kNone)
  T* sq = sA + up16((p.ra + p.rk) * sld, kElem);
  T* sw = sq + nw;
  T* sr = sw + nw;  // rhs: the block's rows of K^-1, or all in the M1 form
  T* sx = sr + nw;  // x~
  T* pa = sx + nw;  // this block's partial of A^T t, gathered for a bulk copy
  T* pk = pa + nw;  // this block's partial of x~, likewise
  const int rs_len = rhs_slot(n, nr, kElem, kForm);
  const int xs_len = kXW ? rs_len : nw;
  T* xs = pk + nw;  // R slots: the blocks' partials of x~ (or windows)
  T* rs = xs + (size_t)R * xs_len;  // R slots: the blocks' A^T t partials
  T* sl = rs + (size_t)R * rs_len;
  T* su = sl + p.mr;
  T* sz = su + p.mr;
  T* sy = sz + p.mr;
  T* st = sy + p.mr;  // rho z - y
  T* sp = st + p.mr;  // rho
  T* ss = sp + p.mr;  // M1 rhs, the block's rows (M1 form only)
  const uint32_t xs_at = smem_addr(xs), rs_at = smem_addr(rs);
  // The rows of x~ this block gathers to its peers (kXW): from its window's
  // start to the next block's, so that the pieces tile [0, nw) on 16-byte
  // boundaries; they lie inside the window, where its sums are complete.
  int g_hi = nw;
  if (rank + 1 < R) {
    int lo1, hi1;
    rhs_window(n, R, rank + 1, kElem, lo1, hi1);
    g_hi = lo1;
  }
  // bytes a phase receives: from each of the R blocks, its partial of A^T t
  // over this block's window (all of it in the M1 form) and its partial of
  // x~ (over the same window with kXW); with kXW, every other block's
  // finished rows of x~
  const uint32_t xs_bytes = (uint32_t)(R * (kXW ? w_hi - w_lo : nw) * kElem);
  const uint32_t rs_bytes =
      (uint32_t)(R * (kForm == kM1 ? nw : w_hi - w_lo) * kElem);
  const uint32_t xg_bytes = (uint32_t)((nw - (g_hi - w_lo)) * kElem);
  if (tid == 0) {
    barrier_init(rs_bar);
    barrier_init(xs_bar);
    if constexpr (kXW) barrier_init(xg_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    barrier_expect(rs_bar, rs_bytes);
    barrier_expect(xs_bar, xs_bytes);
    if constexpr (kXW) barrier_expect(xg_bar, xg_bytes);
  }

  const int ra = p.ra < ma ? p.ra : ma, rk = p.rk < nk ? p.rk : nk;
  const Rows<T, kRes, kGV> mA{sA, A + (size_t)a_lo * n, ra, sld, n};
  const Rows<T, kRes, kGV> mK{sK, K + (size_t)k_lo * n, rk, sld, n};
  if constexpr (kRes != kNone) {
    copy_rows<T, kGV>(sA, mA.gm, ra, n, sld);
    copy_rows<T, kGV>(sK, mK.gm, rk, n, sld);
  }
  for (int i = tid; i < nw; i += nthr) {  // zero past n: the walks read it
    sq[i] = i < n ? q[i] : T(0);
    sw[i] = i < n ? w0[i] : T(0);
    sr[i] = 0;
    sx[i] = 0;
  }
  for (int j = tid; j < ma; j += nthr) {
    sl[j] = l[a_lo + j];
    su[j] = u[a_lo + j];
    sy[j] = y0[a_lo + j];
    sp[j] = rho[a_lo + j];
  }
  if constexpr (kRes != kNone && kGV * kElem == 16) __pipeline_wait_prior(0);
  __syncthreads();
  walk_rows<T, V, kComp>(mA, ma, n, sw, [&](int j, T acc) {
    const T z = admm::clip(acc, sl[j], su[j]);
    sz[j] = z;
    st[j] = sp[j] * z - sy[j];
  });
  cluster.sync();  // every block runs, barriers armed, before a peer sends

  // a walk's emit: lane group 0 gathers the chunk into the partial `part`
  const auto gather = [](T* part) {
    return [part](int c, int g, const Vec<T, V>& acc) {
      if (g == 0) *reinterpret_cast<Vec<T, V>*>(part + c) = acc;
    };
  };
  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    const uint32_t parity = it & 1;
    // A^T t over the block's rows, sent to where rhs is formed: thread r
    // sends block r its window of the partial
    walk_cols<T, V, kComp>(mA, ma, n, st, gather(pa));
    fence_for_bulk();
    __syncthreads();
    if (tid < R) {
      int lo = 0, hi = nw;
      if constexpr (kForm == kKinv) rhs_window(n, R, tid, kElem, lo, hi);
      send_bulk(
          remote_addr(rs_at + (uint32_t)((size_t)rank * rs_len * kElem), tid),
          smem_addr(pa + lo), (uint32_t)((hi - lo) * kElem),
          remote_addr(rs_bar, tid));
    }
    barrier_wait(rs_bar, parity, rs_bytes);
    // the partial of x~ from the block's rows of K^-1 (M1), sent to all
    if constexpr (kForm == kM1) {
      for (int i = tid; i < n; i += nthr)
        sr[i] = sigma * sw[i] - sq[i] + slots_sum(rs, R, rs_len, i);
      __syncthreads();
      walk_rows<T, V, kComp>(mK, nk, n, sr,
                             [&](int i, T acc) { ss[i] = acc; });
      __syncthreads();
      walk_cols<T, V, kComp>(mK, nk, n, ss, gather(pk));  // M1^T s, own rows
    } else {
      const T* own = rs + (k_lo - w_lo);  // this block's rows in each slot
      for (int j = tid; j < nk; j += nthr)
        sr[j] = sigma * sw[k_lo + j] - sq[k_lo + j] +
                slots_sum(own, R, rs_len, j);
      __syncthreads();
      // K^-1[rows, :]^T rhs
      walk_cols<T, V, kComp>(mK, nk, n, sr, gather(pk));
    }
    fence_for_bulk();
    __syncthreads();
    if (tid < R) {
      int lo = 0, hi = nw;
      if constexpr (kXW) rhs_window(n, R, tid, kElem, lo, hi);
      send_bulk(
          remote_addr(xs_at + (uint32_t)((size_t)rank * xs_len * kElem), tid),
          smem_addr(pk + lo), (uint32_t)((hi - lo) * kElem),
          remote_addr(xs_bar, tid));
    }
    barrier_wait(xs_bar, parity, xs_bytes);
    if constexpr (kXW) {
      // this block's rows of x~ from the windows, then gathered: each peer
      // sends its rows into the same place of every block's x~
      for (int i = w_lo + tid; i < g_hi; i += nthr)
        sx[i] = slots_sum(xs, R, xs_len, i - w_lo);
      fence_for_bulk();
      __syncthreads();
      if (tid < R && tid != rank && g_hi > w_lo)
        send_bulk(remote_addr(smem_addr(sx + w_lo), tid),
                  smem_addr(sx + w_lo), (uint32_t)((g_hi - w_lo) * kElem),
                  remote_addr(xg_bar, tid));
      barrier_wait(xg_bar, parity, xg_bytes);
      for (int i = tid; i < n; i += nthr)
        sw[i] = alpha * sx[i] + one_m_alpha * sw[i];
    } else {
      for (int i = tid; i < n; i += nthr) {
        const T x = slots_sum(xs, R, nw, i);
        sx[i] = x;
        sw[i] = alpha * x + one_m_alpha * sw[i];
      }
    }
    __syncthreads();
    // A x~, own rows
    walk_rows<T, V, kComp>(mA, ma, n, sx, [&](int j, T zt) {
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

// Fill out[0..8] with a plan for the wrappers and tests: R, V, mr, nr,
// resident, bytes of shared memory a block, ra, rk, xwin.
inline void export_plan(const Plan& p, int* out) {
  out[0] = p.R;
  out[1] = p.V;
  out[2] = p.mr;
  out[3] = p.nr;
  out[4] = p.resident;
  out[5] = (int)p.smem;
  out[6] = p.ra;
  out[7] = p.rk;
  out[8] = p.xwin;
}

inline bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

}  // namespace admm_cluster
