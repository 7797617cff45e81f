// K1: fused collision log-likelihood (FK -> packed SDF gather -> hinge), forward
// and d/dq in one pass.
//
// Replaces the XLA-fused JAX chain of vgpmp_tpu/kinematics/dh.py:sphere_positions,
// vgpmp_tpu/scene.py:Scene.distance (packed mode, through
// vgpmp_tpu/sdf/grid.py:_packed_flat_index/_unpack_hi/_unpack_lo/
// packed_nearest_distance) and vgpmp_tpu/likelihoods/collision.py:
// CollisionModel.log_prob. The plain PyTorch version of the same function is
// vgpmp_torch/likelihoods/collision.py:log_prob_plain.
//
// What bounds it on an H100: the random 8-byte gathers from the packed table
// ([ncells, 2] words, 222 MB for the industrial scene, larger than the 50 MB
// L2). Each sphere lookup touches one 32-byte DRAM sector, so the bound is the
// bytes of the distinct sectors a call touches over the memory rate; the FK
// chain and the hinge are a few hundred flops per config and never bind.
//
// Design: one warp per configuration. Every lane runs the (cheap) DH chain for
// that configuration redundantly, so no lane waits on another, then the lanes
// split the P spheres between them: each lane issues its own independent
// 8-byte load (value and the three gradient components packed as bf16), and
// many warps per SM keep enough loads in flight to cover DRAM latency. The
// derivative is accumulated in the same pass from the gathered gradient
// (dlik/dq_j = sum_p (c_p/sigma_p) z_j . ((x_p - o_j) x grad_p)), so the
// backward pass is a multiply by the saved result and never gathers again —
// what the custom VJP at vgpmp_tpu/sdf/grid.py:308-318 achieves.
// The compiler may contract the FK's products and sums into fused
// multiply-adds, so a sphere near a voxel face can land in the neighbouring
// voxel of the one the plain version picks; the checks bound that share.

#include <cuda_runtime.h>

#include "fk.cuh"
#include "kernels.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float unpack_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float unpack_lo(uint32_t w) { return __uint_as_float(w << 16); }

__device__ __forceinline__ long long flat_index(float px, float py, float pz, float ox, float oy,
                                                float oz, float delta, int nx, int ny, int nz) {
  int ix = (int)floorf((px - ox) / delta);
  int iy = (int)floorf((py - oy) / delta);
  int iz = (int)floorf((pz - oz) / delta);
  ix = min(max(ix, 0), nx - 1);
  iy = min(max(iy, 0), ny - 1);
  iz = min(max(iz, 0), nz - 1);
  return ((long long)ix * ny + iy) * nz + iz;
}

// robot and spheres: the constant tables described in fk.cuh.
template <int DOF, bool CRAIG, bool GRAD>
__global__ void __launch_bounds__(256) loglik_kernel(
    const float* __restrict__ q, const float* __restrict__ sigma,
    const float* __restrict__ robot, const float* __restrict__ spheres,
    const uint2* __restrict__ words, float* __restrict__ lik, float* __restrict__ dlik,
    long long T, long long K, int P, K1Grid g, float eps) {
  const int lane = threadIdx.x & 31;
  const long long cfg = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (cfg >= T) return;  // uniform across the warp
  const long long row = cfg / K;

  float R[DOF + 1][9];
  float t[DOF + 1][3];
  fk_chain<DOF, CRAIG>(q + cfg * DOF, robot, R, t);

  float acc = 0.f;
  float dq[DOF];
#pragma unroll
  for (int j = 0; j < DOF; ++j) dq[j] = 0.f;

  for (int sp = lane; sp < P; sp += 32) {
    const float* s = spheres + 5 * sp;
    const float rad = s[4];
    float x, y, z;
    const int f = sphere_centre<DOF>(s, R, t, x, y, z);
    const long long idx =
        flat_index(x - g.bx, y - g.by, z - g.bz, g.ox, g.oy, g.oz, g.delta, g.nx, g.ny, g.nz);
    const uint2 w = __ldg(words + idx);
    const float dist = unpack_hi(w.x);
    const float c = fmaxf(eps - (dist - rad), 0.f);
    const float sig = sigma[row * P + sp];
    acc += c * c / sig;
    if (GRAD && c > 0.f) {
      const float k = c / sig;
      const float gx = k * unpack_lo(w.x), gy = k * unpack_hi(w.y), gz = k * unpack_lo(w.y);
#pragma unroll
      for (int j = 0; j < DOF; ++j) {
        if (j < f) {  // joint j moves frames j+1.. (both DH conventions)
          const int ax = CRAIG ? j + 1 : j;  // frame whose z axis joint j turns about
          const float rx = x - t[ax][0], ry = y - t[ax][1], rz = z - t[ax][2];
          const float mx = ry * gz - rz * gy, my = rz * gx - rx * gz, mz = rx * gy - ry * gx;
          dq[j] += R[ax][2] * mx + R[ax][5] * my + R[ax][8] * mz;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(FULL, acc, off);
    if (GRAD) {
#pragma unroll
      for (int j = 0; j < DOF; ++j) dq[j] += __shfl_xor_sync(FULL, dq[j], off);
    }
  }
  if (lane == 0) {
    lik[cfg] = -0.5f * acc;
    if (GRAD) {
#pragma unroll
      for (int j = 0; j < DOF; ++j) dlik[cfg * DOF + j] = dq[j];
    }
  }
}

template <int DOF, bool CRAIG>
cudaError_t launch_dof(bool grad, dim3 grid, dim3 block, cudaStream_t st, const float* q,
                       const float* sigma, const float* robot, const float* spheres,
                       const uint2* words, float* lik, float* dlik, long long T, long long K,
                       int P, K1Grid g, float eps) {
  if (grad)
    loglik_kernel<DOF, CRAIG, true><<<grid, block, 0, st>>>(q, sigma, robot, spheres, words, lik,
                                                            dlik, T, K, P, g, eps);
  else
    loglik_kernel<DOF, CRAIG, false><<<grid, block, 0, st>>>(q, sigma, robot, spheres, words, lik,
                                                             dlik, T, K, P, g, eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t k1_loglik_launch(const float* q, const float* sigma, const float* robot,
                             const float* spheres, const void* words, float* lik, float* dlik,
                             int64_t T, int64_t K, int P, int dof, bool craig, bool grad,
                             K1Grid g, float eps, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  const int warps = 8;
  const dim3 block(32 * warps);
  const dim3 grid((unsigned)((T + warps - 1) / warps));
  const uint2* w = (const uint2*)words;
  if (dof == 7 && craig)
    return launch_dof<7, true>(grad, grid, block, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  if (dof == 7)
    return launch_dof<7, false>(grad, grid, block, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  if (dof == 6 && craig)
    return launch_dof<6, true>(grad, grid, block, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  if (dof == 6)
    return launch_dof<6, false>(grad, grid, block, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  return cudaErrorInvalidValue;
}
