// What the cluster-resident ADMM kernels (../admm_cluster.cuh) are built
// from, timed alone on the card: a program of its own, run by
// cluster_probe.py at the repository root. It prints
//  1. the cost of one cluster barrier, with release and acquire
//     (cluster.sync()) and relaxed, against a block barrier, by cluster size
//     and block size, with 1 and with 15 clusters on the card;
//  2. the cycles of one mat-vec walk over a block's slice of a matrix in
//     shared memory (50 and 67 rows of 380 floats: the sparse LOCP on
//     clusters of 8 and of 6), by columns and by rows as the kernels walk
//     it, against a plain streaming read and against 128 bytes a cycle.
#include <cstdio>

#include "../admm_cluster.cuh"

using namespace admm_cluster;

enum Barrier { kClusterSync, kClusterRelaxed, kBlockSync };

template <int kKind>
__global__ void barrier_loop(int reps, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  float a = threadIdx.x;
  for (int i = 0; i < reps; ++i) {
    if (kKind == kClusterSync) cluster.sync();
    if (kKind == kClusterRelaxed) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    }
    if (kKind == kBlockSync) __syncthreads();
    a += 1.f;
  }
  if (a < 0) out[0] = a;
}

// microseconds a barrier, from CUDA events around one launch
template <int kKind>
float barrier_us(int R, int clusters, int threads, float* out) {
  const int reps = 20000;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * clusters);
  cfg.blockDim = dim3(threads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaLaunchKernelEx(&cfg, barrier_loop<kKind>, reps, out);  // warm-up
  cudaEventRecord(t0);
  cudaLaunchKernelEx(&cfg, barrier_loop<kKind>, reps, out);
  cudaEventRecord(t1);
  if (cudaDeviceSynchronize() != cudaSuccess) return -1.f;
  float ms;
  cudaEventElapsedTime(&ms, t0, t1);
  return 1e3f * ms / reps;
}

enum Walk { kCols, kRows, kStream };

template <int kWalk>
__global__ void walk_loop(long long* cycles, float* out, int rows, int cols,
                          int reps) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* M = reinterpret_cast<float*>(raw);
  float* v = M + (size_t)rows * cols;
  float* o = v + 512;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    M[i] = 1e-3f * (i % 17);
  for (int i = threadIdx.x; i < 512; i += blockDim.x) {
    v[i] = 1e-2f * (i % 5);
    o[i] = 0;
  }
  __syncthreads();
  const Rows<float, kAll, 4> Ms{M, M, rows, cols, cols};
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    if (kWalk == kCols)
      walk_cols<float, 4>(Ms, rows, cols, v,
                          [&](int c, int g, const Vec<float, 4>& a) {
                            if (g == 0)
                              *reinterpret_cast<Vec<float, 4>*>(o + c) = a;
                          });
    if (kWalk == kRows)
      walk_rows<float, 4>(Ms, rows, cols, v, [&](int r, float a) { o[r] = a; });
    if (kWalk == kStream) {  // every element once, 16 bytes a thread
      Vec<float, 4> acc = {0, 0, 0, 0};
#pragma unroll 4
      for (int i = threadIdx.x; i < rows * cols / 4; i += blockDim.x) {
        const Vec<float, 4> a = load_vec<float, 4>(M + 4 * i);
        for (int k = 0; k < 4; ++k) acc.v[k] += a.v[k];
      }
      if (acc.v[0] + acc.v[1] + acc.v[2] + acc.v[3] == -1.f) o[0] = acc.v[0];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    cycles[0] = (clock64() - t0) / reps;
    out[0] = o[1];
  }
}

template <int kWalk>
long long walk_cycles(int threads, int rows, long long* cycles, float* out) {
  const int cols = 380;
  const size_t smem = ((size_t)rows * cols + 1024) * sizeof(float);
  cudaFuncSetAttribute(walk_loop<kWalk>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  walk_loop<kWalk><<<1, threads, smem>>>(cycles, out, rows, cols, 2000);
  long long host = -1;
  if (cudaDeviceSynchronize() == cudaSuccess)
    cudaMemcpy(&host, cycles, sizeof(host), cudaMemcpyDeviceToHost);
  return host;
}

int main() {
  float* out;
  long long* cycles;
  cudaMalloc(&out, sizeof(float));
  cudaMalloc(&cycles, sizeof(long long));
  for (int threads : {1024, 768, 128})
    for (int R : {1, 6, 8})
      for (int clusters : {1, 15})
        printf("[barrier] %4d threads, clusters of %d, %2d on the card: "
               "cluster.sync %.3f us, relaxed arrive and wait %.3f us, "
               "__syncthreads %.3f us\n", threads, R, clusters,
               barrier_us<kClusterSync>(R, clusters, threads, out),
               barrier_us<kClusterRelaxed>(R, clusters, threads, out),
               barrier_us<kBlockSync>(R, clusters, threads, out));
  for (int rows : {50, 67})
    for (int threads : {1024, 768, 512})
      printf("[walk] %2d rows of 380 floats, %4d threads: by columns %lld, "
             "by rows %lld, streaming read %lld cycles a pass and block "
             "barrier; at 128 bytes a cycle %d\n", rows, threads,
             walk_cycles<kCols>(threads, rows, cycles, out),
             walk_cycles<kRows>(threads, rows, cycles, out),
             walk_cycles<kStream>(threads, rows, cycles, out),
             rows * 380 * 4 / 128);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
