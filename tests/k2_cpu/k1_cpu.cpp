// K1 on the CPU (cuda_runtime.h here), with a C interface for ctypes: the
// rewritten k1_collision.cuh in float32, each lookup mode.
#include "k1_collision.cuh"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
namespace {  // where the kernel's `extern __shared__ k1_smem` is declared
alignas(16) unsigned char k1_smem[K2_CPU_SMEM];
}
unsigned char* k2_cpu_smem = k1_smem;
std::barrier<>* k2_cpu_block;
std::barrier<>* k2_cpu_warp[32];
double k2_cpu_xa[32][32], k2_cpu_xb[32][32];

template cudaError_t k1_loglik_launch<float, K1_PACKED>(const K1Args<float>&, cudaStream_t);
template cudaError_t k1_loglik_launch<float, K1_NEAREST>(const K1Args<float>&, cudaStream_t);

// grid: base offset (3), origin (3), delta; shape: nx, ny, nz; the extras as
// SceneExtras; lik [T], dlik [T, dof] (grad), h2 [P, T] (when not null)
extern "C" int k1_f32(int mode, const float* q, const float* sigma, const float* robot,
                      const float* spheres, const void* table, const float* grid, const int* shape,
                      const float* grid_f, const int* grid_i, const void* cells, const float* prims,
                      const int* counts, float* lik, float* dlik, float* h2, long long T, long long K,
                      int P, int dof, int craig, int grad, float eps) {
  const SceneExtras ex{grid_f, grid_i, cells, prims, counts[0], counts[1], counts[2], counts[3]};
  const GridArgs<float> g{grid[0], grid[1], grid[2], grid[3], grid[4], grid[5], grid[6],
                          shape[0], shape[1], shape[2]};
  const K1Args<float> a{q, sigma, robot, spheres, table, ex, lik, dlik, h2, T, K, P, dof,
                        craig != 0, grad != 0, g, eps};
  return mode == K1_PACKED ? k1_loglik_launch<float, K1_PACKED>(a, nullptr)
                           : k1_loglik_launch<float, K1_NEAREST>(a, nullptr);
}

// whether the instantiation of (mode, extras) takes the split design
extern "C" int k1_split_design(int mode, int extra) {
  if (mode == K1_PACKED)
    return extra ? k1_split<float, K1_PACKED, true>() : k1_split<float, K1_PACKED, false>();
  if (mode == K1_NEAREST)
    return extra ? k1_split<float, K1_NEAREST, true>() : k1_split<float, K1_NEAREST, false>();
  return extra ? k1_split<float, K1_TRILINEAR, true>() : k1_split<float, K1_TRILINEAR, false>();
}
