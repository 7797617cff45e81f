// What K2's block design (vgpmp_torch/csrc/k2_linalg.cuh) takes from CUDA,
// on the CPU, so that its source can be compiled by g++ and run by the tests.
// A launch runs its blocks one after another; a block runs as BLK_THREADS
// std::threads. __syncthreads is a barrier of the block, __syncwarp one of the
// warp, and __shfl_sync and the m8n8k4 float64 product (mma.sync, as
// k2_cpu_mma) go through a per-warp exchange buffer. Dynamic shared memory is
// one array, poisoned before each block: a write past the launch's bytes
// aborts. The test rewrites the header's inline PTX into these calls. What
// this cannot show: timing, the hardware's fragment layout beyond PTX's
// documented one, a missing cp.async wait.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline double rsqrt(double x) { return 1 / std::sqrt(x); }
using std::max;
using std::min;

constexpr size_t K2_CPU_SMEM = 240000;  // above the 227 KB a block may take
extern unsigned char* k2_cpu_smem;  // the kernels' k2_smem
extern std::barrier<>* k2_cpu_block;
extern std::barrier<>* k2_cpu_warp[32];
extern double k2_cpu_xa[32][32], k2_cpu_xb[32][32];

inline void __syncthreads() { k2_cpu_block->arrive_and_wait(); }
inline void __syncwarp() { k2_cpu_warp[threadIdx.x / 32]->arrive_and_wait(); }
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  k2_cpu_xa[w][l] = (double)v;
  k2_cpu_warp[w]->arrive_and_wait();
  const T r = (T)k2_cpu_xa[w][l - l % width + src];
  k2_cpu_warp[w]->arrive_and_wait();
  return r;
}
// mma.sync.aligned.m8n8k4.row.col.f64: lane l holds A[l / 4][l % 4], B[l % 4][l / 4]
// (column l / 4 of B) and C[l / 4][2 (l % 4) + e], e = 0, 1
inline void k2_cpu_mma(double (&c)[2], double a, double b) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l >> 2, q = l & 3;
  k2_cpu_xa[w][l] = a;
  k2_cpu_xb[w][l] = b;
  k2_cpu_warp[w]->arrive_and_wait();
  for (int e = 0; e < 2; ++e)
    for (int k = 0; k < 4; ++k) c[e] = std::fma(k2_cpu_xa[w][g * 4 + k], k2_cpu_xb[w][(2 * q + e) * 4 + k], c[e]);
  k2_cpu_warp[w]->arrive_and_wait();
}
inline size_t __cvta_generic_to_shared(const void*) { return 0; }

template <class K, class... A>
void k2_cpu_launch(K kernel, dim3 grid, dim3 block, size_t smem, A... args) {
  blockDim = block;
  const int nt = block.x;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      blockIdx = dim3(x, y);
      std::memset(k2_cpu_smem, 0xff, K2_CPU_SMEM);
      std::barrier<> bar(nt);
      k2_cpu_block = &bar;
      for (int w = 0; w < nt / 32; ++w) k2_cpu_warp[w] = new std::barrier<>(32);
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t) threads.emplace_back([=] { threadIdx = dim3(t); kernel(args...); });
      for (auto& t : threads) t.join();
      for (int w = 0; w < nt / 32; ++w) delete k2_cpu_warp[w];
      for (size_t i = smem; i < K2_CPU_SMEM; ++i)
        if (k2_cpu_smem[i] != 0xff) {
          std::fprintf(stderr, "shared memory written at byte %zu past the launch's %zu\n", i, smem);
          std::abort();
        }
    }
}
