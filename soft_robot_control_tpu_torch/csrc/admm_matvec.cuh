// Block-level mat-vecs of the ADMM kernel that streams its matrices from
// device memory (admm_stream.cu); both walk a row-major matrix so that
// neighbouring threads read neighbouring addresses. clip and round_up_32
// also serve the cluster-resident kernels (admm_cluster.cuh).
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace admm {

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__host__ __device__ inline int round_up_32(int n) { return (n + 31) & ~31; }

// Column groups of matvec_cols: G groups of round_up_32(cols) threads each
// split the rows between them (G = 1 and a loop over the columns when one
// group does not fit the block).
inline int col_groups(int cols, int max_threads) {
  const int g = max_threads / round_up_32(cols);
  return g < 1 ? 1 : (g > 8 ? 8 : g);
}

// emit(r, sum_c M[r, c] v[c]) for every row r: one warp per row, lanes along
// the row, shuffle reduction; lane 0 calls emit. v lives in shared memory.
template <typename T, typename F>
__device__ __forceinline__ void matvec_rows(const T* __restrict__ M, int rows,
                                            int cols, const T* v, F emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarp) {
    const T* row = M + (size_t)r * cols;
    T acc = 0;
#pragma unroll 4
    for (int c = lane; c < cols; c += 32) acc += row[c] * v[c];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) emit(r, acc);
  }
}

// part[g, c] = sum over the rows r = g, g+G, ... of M[r, c] v[r]: thread
// (g, c) owns column c of row group g, so a warp reads 32 neighbouring
// elements of one row at a time. v and part (G*cols) live in shared memory;
// the caller synchronizes and then sums the G partials with cols_sum.
template <typename T>
__device__ __forceinline__ void matvec_cols(const T* __restrict__ M, int rows,
                                            int cols, const T* v, T* part,
                                            int G) {
  const int cpad = round_up_32(cols);
  const int g = G == 1 ? 0 : threadIdx.x / cpad;
  const int c0 = G == 1 ? threadIdx.x : threadIdx.x - g * cpad;
  const int stride = G == 1 ? blockDim.x : cpad;
  if (g >= G) return;
  for (int c = c0; c < cols; c += stride) {
    T acc = 0;
#pragma unroll 8
    for (int r = g; r < rows; r += G) acc += M[(size_t)r * cols + c] * v[r];
    part[g * cols + c] = acc;
  }
}

template <typename T>
__device__ __forceinline__ T cols_sum(const T* part, int cols, int G, int c) {
  T acc = part[c];
  for (int g = 1; g < G; ++g) acc += part[g * cols + c];
  return acc;
}

}  // namespace admm
