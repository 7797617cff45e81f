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
// chain and the hinge are a few hundred flops per config and never bind. What
// a kernel has to do about it is keep many independent gathers in flight and
// spend few instructions and registers around them.
//
// Design: a block of 256 threads takes a tile of 32 consecutive configurations
// (neighbours in time along a trajectory, so neighbours in space: their
// spheres share sectors).
//   Phase 1: one thread per configuration runs the DH chain once
//     (fk.cuh:fk_chain_to_shared) and leaves the frames in shared memory.
//   Phase 2: thread (g, c) keeps local configuration c and the spheres g,
//     g + 8, g + 16, ..., so a warp holds the tile's 32 configurations of one
//     sphere: its shared-memory reads are conflict-free, the sphere's constants
//     are a broadcast, and its 32 gathers land near each other. A thread
//     computes the cells of its five spheres and starts all five gathers
//     before it uses one.
//   Phase 3: the hinge, and for an active pair the joint torques from the
//     frames in shared memory (dlik/dq_j = sum_p (c_p/sigma_p) z_j . ((x_p -
//     o_j) x grad_p), from the gathered gradient, so the backward pass is a
//     multiply by the saved result and never gathers again: what the custom
//     VJP at vgpmp_tpu/sdf/grid.py:308-318 achieves). The eight partial sums
//     per configuration meet in shared memory, and lik [32] and dlik [32, DOF]
//     leave coalesced.
// No thread holds a configuration's frames in registers: the kernel takes 64
// registers a thread with the gradient, 48 without, and spills nothing, so
// eight warps of a block and several blocks share an SM (PERF.md).
// The compiler may contract the FK's products and sums into fused
// multiply-adds, so a sphere near a voxel face can land in the neighbouring
// voxel of the one the plain version picks; the checks bound that share.

#include <cuda_runtime.h>

#include "fk.cuh"
#include "kernels.h"

namespace {

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

// C configurations and THREADS threads a block, NI gathers in flight a thread:
// the tile that was fastest of six at the main path's shape (PERF.md).
constexpr int C = 32, THREADS = 256, NI = 5;

// robot and spheres: the constant tables described in fk.cuh.
template <int DOF, bool CRAIG, bool GRAD>
__global__ void __launch_bounds__(THREADS) loglik_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ sigma,
    const float* __restrict__ robot, const float* __restrict__ spheres,
    const uint2* __restrict__ words, float* __restrict__ lik, float* __restrict__ dlik,
    long long T, long long K, int P, K1Grid g, float eps) {
  constexpr int G = THREADS / C;
  constexpr int NF = FK_FRAME * (DOF + 1);
  constexpr int SLOTS = 8;  // 1 + DOF <= 8 partial sums per thread
  static_assert(THREADS % C == 0 && C % 32 == 0 && DOF + 1 <= SLOTS, "tile shape");
  extern __shared__ float smem[];
  float* frames = smem;                // [NF][C]
  float* red = frames + NF * C;        // [G][SLOTS][C]
  float* sph = red + G * SLOTS * C;    // [P][5]

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * C;
  for (int i = tid; i < 5 * P; i += THREADS) sph[i] = spheres[i];
  if (tid < C && tile0 + tid < T)
    fk_chain_to_shared<DOF, CRAIG>(q + (tile0 + tid) * DOF, robot, frames + tid, C);
  __syncthreads();

  const int c = tid % C, grp = tid / C;
  const long long cfg = tile0 + c;
  const bool live = cfg < T;
  const float* fr = frames + c;
  const float* sig = sigma + (live ? cfg / K : 0) * P;

  float acc = 0.f;
  float dq[DOF];
#pragma unroll
  for (int j = 0; j < DOF; ++j) dq[j] = 0.f;

  for (int base = grp; base < P; base += G * NI) {
    uint2 w[NI];
    float sg[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int sp = base + G * i;
      if (live && sp < P) {
        const float* s = sph + 5 * sp;
        float x, y, z;
        sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
        const long long idx =
            flat_index(x - g.bx, y - g.by, z - g.bz, g.ox, g.oy, g.oz, g.delta, g.nx, g.ny, g.nz);
        w[i] = __ldg(words + idx);
        sg[i] = __ldg(sig + sp);
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int sp = base + G * i;
      if (live && sp < P) {
        const float* s = sph + 5 * sp;
        const float dist = unpack_hi(w[i].x);
        const float h = fmaxf(eps - (dist - s[4]), 0.f);
        acc += h * h / sg[i];
        if (GRAD && h > 0.f) {
          const int f = (int)s[0];
          float x, y, z;
          sphere_centre_shared(fr, C, f, s[1], s[2], s[3], x, y, z);
          const float k = h / sg[i];
          const float gx = k * unpack_lo(w[i].x), gy = k * unpack_hi(w[i].y),
                      gz = k * unpack_lo(w[i].y);
#pragma unroll
          for (int j = 0; j < DOF; ++j) {
            if (j < f) {  // joint j moves frames j+1.. (both DH conventions)
              // frame whose z axis joint j turns about
              const float* A = fr + FK_FRAME * (CRAIG ? j + 1 : j) * C;
              const float rx = x - A[9 * C], ry = y - A[10 * C], rz = z - A[11 * C];
              const float mx = ry * gz - rz * gy, my = rz * gx - rx * gz, mz = rx * gy - ry * gx;
              dq[j] += A[2 * C] * mx + A[5 * C] * my + A[8 * C] * mz;
            }
          }
        }
      }
    }
  }

  red[(grp * SLOTS) * C + c] = acc;
  if (GRAD) {
#pragma unroll
    for (int j = 0; j < DOF; ++j) red[(grp * SLOTS + 1 + j) * C + c] = dq[j];
  }
  __syncthreads();
  if (tid < C && tile0 + tid < T) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) s += red[(k * SLOTS) * C + tid];
    lik[tile0 + tid] = -0.5f * s;
  }
  if (GRAD) {
    for (int e = tid; e < C * DOF; e += THREADS) {
      const int cc = e / DOF, j = e % DOF;
      if (tile0 + cc < T) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < G; ++k) s += red[(k * SLOTS + 1 + j) * C + cc];
        dlik[tile0 * DOF + e] = s;
      }
    }
  }
}

template <int DOF, bool CRAIG>
cudaError_t launch_tile(bool grad, cudaStream_t st, const float* q, const float* sigma,
                        const float* robot, const float* spheres, const uint2* words, float* lik,
                        float* dlik, long long T, long long K, int P, K1Grid g, float eps) {
  const size_t smem =
      sizeof(float) * ((size_t)FK_FRAME * (DOF + 1) * C + (size_t)(THREADS / C) * 8 * C + 5 * (size_t)P);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // more spheres than the tile has room for
  const dim3 grid((unsigned)((T + C - 1) / C)), block(THREADS);
  if (grad)
    loglik_tile_kernel<DOF, CRAIG, true>
        <<<grid, block, smem, st>>>(q, sigma, robot, spheres, words, lik, dlik, T, K, P, g, eps);
  else
    loglik_tile_kernel<DOF, CRAIG, false>
        <<<grid, block, smem, st>>>(q, sigma, robot, spheres, words, lik, dlik, T, K, P, g, eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t k1_loglik_launch(const float* q, const float* sigma, const float* robot,
                             const float* spheres, const void* words, float* lik, float* dlik,
                             int64_t T, int64_t K, int P, int dof, bool craig, bool grad,
                             K1Grid g, float eps, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  const uint2* w = (const uint2*)words;
  if (dof == 7 && craig)
    return launch_tile<7, true>(grad, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  if (dof == 7)
    return launch_tile<7, false>(grad, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  if (dof == 6 && craig)
    return launch_tile<6, true>(grad, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  if (dof == 6)
    return launch_tile<6, false>(grad, st, q, sigma, robot, spheres, w, lik, dlik, T, K, P, g, eps);
  return cudaErrorInvalidValue;
}
