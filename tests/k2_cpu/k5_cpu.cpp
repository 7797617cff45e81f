// K5 on the CPU (cuda_runtime.h here), with a C interface for ctypes:
// k5_mesh_sdf.cuh as it is, its launch a loop over blocks.
#include "k5_mesh_sdf.cuh"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
namespace {
namespace k5 {  // where the kernel's `extern __shared__ k5_smem` is declared
alignas(16) unsigned char k5_smem[K2_CPU_SMEM];
}
}  // namespace
unsigned char* k2_cpu_smem = k5::k5_smem;
std::barrier<>* k2_cpu_block;
std::barrier<>* k2_cpu_warp[32];
double k2_cpu_xa[32][32], k2_cpu_xb[32][32];

// tri [T, 9], piece [T] (sorted), grid: origin (3), delta; dims: nx, ny, nz;
// out [nx, ny, nz]
extern "C" int k5_f64(const double* tri, const int* piece, long long T, const double* grid,
                      const int* dims, float* out) {
  const K5Grid g{grid[0], grid[1], grid[2], grid[3], dims[0], dims[1], dims[2]};
  return k5_mesh_sdf_launch(tri, piece, T, g, out, nullptr);
}
