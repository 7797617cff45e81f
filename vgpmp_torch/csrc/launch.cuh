// A kernel launch with dynamic shared memory above the default 48 KB, shared
// by the kernels' sources (k1_collision.cuh, k2_linalg.cuh, k3_clearance.cuh).
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace {

// A launch of kernel with smem bytes of dynamic shared memory: above the
// default 48 KB the kernel is opted in first (up to the 227 KB a block of an
// H100 may take); above that the launch is refused.
template <class Kernel, class... Args>
cudaError_t launch_smem(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t st,
                        Args... args) {
  constexpr size_t DEFAULT_SMEM = 48 * 1024, MAX_SMEM = 232448;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, block, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace
