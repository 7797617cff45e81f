// K3: metric clearance of a batch of configurations,
//   out[c] = min_p ( trilinear(sdf, FK(q_c)_p - base_offset) - r_p ).
//
// Replaces the XLA-fused JAX chain that the success metric evaluates over the
// PD-path probes: vgpmp_tpu/likelihoods/collision.py:sphere_clearance_eval
// (vgpmp_tpu/kinematics/dh.py:sphere_positions, then
// vgpmp_tpu/scene.py:Scene.distance with mode_override="trilinear", that is
// vgpmp_tpu/sdf/grid.py:trilinear_distance) followed by the minimum over
// spheres that vgpmp_tpu/engine/validator.py:execute_and_validate and
// vgpmp_tpu/sim.py:kinematic_execute_trajectory take. The plain PyTorch
// version is vgpmp_torch/likelihoods/collision.py:min_clearance_eval_plain.
// Forward only: the metric is never differentiated.
//
// What bounds it on an H100: the eight corner loads per sphere from the
// float32 grid (111 MB for the industrial scene, larger than the 50 MB L2).
// Neighbouring probes of a PD path are at most one controller step apart, so
// their corners share most 32-byte sectors; the bound is the bytes of the
// distinct sectors a call touches over the memory rate. The FK chain and the
// seven lerps are a few hundred flops per config and never bind.
//
// Design: one warp per configuration, as K1. Every lane runs the DH chain
// redundantly, the lanes split the P spheres, each lane issues its eight
// independent 4-byte loads through the read-only path (the two z-neighbours
// of a corner pair are adjacent words), and a warp shuffle takes the minimum.
// The clamps and the lerp order (z, then y, then x) are the plain version's,
// so the two differ by fused multiply-adds only. A NaN configuration gives
// NaN, as the plain version does: the clamp and the minimum keep it.

#include <cuda_runtime.h>

#include <math_constants.h>

#include "fk.cuh"
#include "kernels.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// clamp to [0, hi]; a NaN stays a NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return v < 0.f ? 0.f : (v > hi ? hi : v);
}

// minimum that keeps a NaN, as torch.min does
__device__ __forceinline__ float min_keep_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// Trilinear interpolation at the mesh-frame point (px, py, pz): corners at
// origin + delta * (i, j, k); outside the grid the border values hold. The
// relative position is clamped to [0, n-1] and the base index to [0, n-2], so
// the fraction reaches exactly 1 on the upper border.
__device__ __forceinline__ float trilinear(const float* __restrict__ sdf, float px, float py,
                                           float pz, const K1Grid& g) {
  const float rx = clamp_keep_nan((px - g.ox) / g.delta, (float)(g.nx - 1));
  const float ry = clamp_keep_nan((py - g.oy) / g.delta, (float)(g.ny - 1));
  const float rz = clamp_keep_nan((pz - g.oz) / g.delta, (float)(g.nz - 1));
  const int ix = min(max((int)floorf(rx), 0), g.nx - 2);  // (int)NaN is 0
  const int iy = min(max((int)floorf(ry), 0), g.ny - 2);
  const int iz = min(max((int)floorf(rz), 0), g.nz - 2);
  const float fx = rx - (float)ix, fy = ry - (float)iy, fz = rz - (float)iz;
  const long long sy = g.nz, sx = (long long)g.ny * g.nz;
  const float* p = sdf + ((long long)ix * sx + (long long)iy * sy + iz);
  const float c000 = __ldg(p), c001 = __ldg(p + 1);
  const float c010 = __ldg(p + sy), c011 = __ldg(p + sy + 1);
  const float c100 = __ldg(p + sx), c101 = __ldg(p + sx + 1);
  const float c110 = __ldg(p + sx + sy), c111 = __ldg(p + sx + sy + 1);
  const float c00 = c000 * (1.f - fz) + c001 * fz;
  const float c01 = c010 * (1.f - fz) + c011 * fz;
  const float c10 = c100 * (1.f - fz) + c101 * fz;
  const float c11 = c110 * (1.f - fz) + c111 * fz;
  const float c0 = c00 * (1.f - fy) + c01 * fy;
  const float c1 = c10 * (1.f - fy) + c11 * fy;
  return c0 * (1.f - fx) + c1 * fx;
}

template <int DOF, bool CRAIG>
__global__ void __launch_bounds__(256) min_clearance_kernel(
    const float* __restrict__ q, const float* __restrict__ robot,
    const float* __restrict__ spheres, const float* __restrict__ sdf, float* __restrict__ out,
    long long T, int P, K1Grid g) {
  const int lane = threadIdx.x & 31;
  const long long cfg = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (cfg >= T) return;  // uniform across the warp

  float R[DOF + 1][9];
  float t[DOF + 1][3];
  fk_chain<DOF, CRAIG>(q + cfg * DOF, robot, R, t);

  float m = CUDART_INF_F;
  for (int sp = lane; sp < P; sp += 32) {
    const float* s = spheres + 5 * sp;
    float x, y, z;
    sphere_centre<DOF>(s, R, t, x, y, z);
    const float d = trilinear(sdf, x - g.bx, y - g.by, z - g.bz, g);
    m = min_keep_nan(m, d - s[4]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = min_keep_nan(m, __shfl_xor_sync(FULL, m, off));
  if (lane == 0) out[cfg] = m;
}

template <int DOF, bool CRAIG>
cudaError_t launch_dof(dim3 grid, dim3 block, cudaStream_t st, const float* q, const float* robot,
                       const float* spheres, const float* sdf, float* out, long long T, int P,
                       K1Grid g) {
  min_clearance_kernel<DOF, CRAIG><<<grid, block, 0, st>>>(q, robot, spheres, sdf, out, T, P, g);
  return cudaGetLastError();
}

}  // namespace

cudaError_t k3_min_clearance_launch(const float* q, const float* robot, const float* spheres,
                                    const float* sdf, float* out, int64_t T, int P, int dof,
                                    bool craig, K1Grid g, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  const int warps = 8;
  const dim3 block(32 * warps);
  const dim3 grid((unsigned)((T + warps - 1) / warps));
  if (dof == 7 && craig) return launch_dof<7, true>(grid, block, st, q, robot, spheres, sdf, out, T, P, g);
  if (dof == 7) return launch_dof<7, false>(grid, block, st, q, robot, spheres, sdf, out, T, P, g);
  if (dof == 6 && craig) return launch_dof<6, true>(grid, block, st, q, robot, spheres, sdf, out, T, P, g);
  if (dof == 6) return launch_dof<6, false>(grid, block, st, q, robot, spheres, sdf, out, T, P, g);
  return cudaErrorInvalidValue;
}
