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
//
// d/dsigma, where sigma_obs is trained: lik_t = -1/2 sum_p h_tp^2 / sigma_rp
// (r the row of config t), so dL/dsigma_rp = 1/2 sum_{t in r} g_t h_tp^2 /
// sigma_rp^2 for the upstream gradient g. The forward's H2 instantiation also
// writes h_tp^2, sphere-major ([P, T]: a warp holds 32 consecutive configs of
// one sphere, so its store is one 128-byte line, and the backward reads each
// (row, sphere) segment contiguously); the frozen path's instantiations are
// unchanged and write nothing more. k1_dsigma then reduces g * h^2 over each
// row's configs: reading h^2 back replaces a second gather from the table.
// It moves T (P + 1) floats and does 2 T P operations, so it is bound by the
// bytes it reads.
// A scene with extra grids or primitives takes the EXTRA instantiation: after
// its five base gathers a thread issues, grid by grid, the five spheres'
// gathers from each extra packed grid (scene.cuh's extras, copied to shared
// memory beside the sphere table), keeps the smallest value and its gradient
// (half of each at a tie, as autograd of the plain minimum), folds in the
// analytic primitives, and the hinge reads that. Where a sphere
// centre lies inside or on a box its gradient is NaN, as JAX's is
// (scene.cuh:compose_primitives), so the config's d/dq is NaN in the joints
// that move the sphere. The base-only instantiations are unchanged.
// The compiler may contract the FK's products and sums into fused
// multiply-adds, so a sphere near a voxel face can land in the neighbouring
// voxel of the one the plain version picks; the checks bound that share.

#include <cuda_runtime.h>

#include "fk.cuh"
#include "kernels.h"
#include "scene.cuh"

namespace {

// C configurations and THREADS threads a block, NI gathers in flight a thread:
// the tile that was fastest of six at the main path's shape (PERF.md).
constexpr int C = 32, THREADS = 256, NI = 5;

// robot and spheres: the constant tables described in fk.cuh.
// H2: also write h^2 [P, T] (only with GRAD). EXTRA: compose ex's sources.
template <int DOF, bool CRAIG, bool GRAD, bool H2, bool EXTRA>
__global__ void __launch_bounds__(THREADS) loglik_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ sigma,
    const float* __restrict__ robot, const float* __restrict__ spheres,
    const uint2* __restrict__ words, SceneExtras ex, float* __restrict__ lik,
    float* __restrict__ dlik, float* __restrict__ h2, long long T, long long K, int P, K1Grid g,
    float eps) {
  constexpr int G = THREADS / C;
  constexpr int NF = FK_FRAME * (DOF + 1);
  constexpr int SLOTS = 8;  // 1 + DOF <= 8 partial sums per thread
  static_assert(THREADS % C == 0 && C % 32 == 0 && DOF + 1 <= SLOTS, "tile shape");
  static_assert(GRAD || !H2, "h^2 is written only beside the gradient");
  extern __shared__ float smem[];
  float* frames = smem;                // [NF][C]
  float* red = frames + NF * C;        // [G][SLOTS][C]
  float* sph = red + G * SLOTS * C;    // [P][5]

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * C;
  for (int i = tid; i < 5 * P; i += THREADS) sph[i] = spheres[i];
  ExtrasView xv{};
  if constexpr (EXTRA) xv = extras_to_shared(ex, sph + 5 * P, tid, THREADS);
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
    float px[NI], py[NI], pz[NI];  // EXTRA: the sphere centres
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
        if constexpr (EXTRA) {
          px[i] = x;
          py[i] = y;
          pz[i] = z;
        }
      }
    }
    // EXTRA: the composed value and gradient, from the base word on
    float dv[NI], gv[NI][3];
    if constexpr (EXTRA) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        dv[i] = unpack_hi(w[i].x);
        gv[i][0] = unpack_lo(w[i].x);
        gv[i][1] = unpack_hi(w[i].y);
        gv[i][2] = unpack_lo(w[i].y);
      }
      const uint2* cells = static_cast<const uint2*>(ex.cells);
      for (int e = 0; e < xv.G; ++e) {
        const K1Grid eg = extra_grid(xv, e);
        const uint2* ew = cells + extra_start(xv, e);
        uint2 we[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i)
          if (live && base + G * i < P)
            we[i] = __ldg(ew + flat_index(px[i] - eg.bx, py[i] - eg.by, pz[i] - eg.bz, eg.ox,
                                          eg.oy, eg.oz, eg.delta, eg.nx, eg.ny, eg.nz));
#pragma unroll
        for (int i = 0; i < NI; ++i)
          if (live && base + G * i < P)
            fold_min<GRAD>(unpack_hi(we[i].x),
                           {unpack_lo(we[i].x), unpack_hi(we[i].y), unpack_lo(we[i].y)}, dv[i], gv[i]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (live && base + G * i < P) {
          bool bad = false;
          compose_primitives<GRAD>(xv, px[i], py[i], pz[i], dv[i], gv[i], bad);
          if (bad) gv[i][0] = gv[i][1] = gv[i][2] = CUDART_NAN_F;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int sp = base + G * i;
      if (live && sp < P) {
        const float* s = sph + 5 * sp;
        const float dist = EXTRA ? dv[i] : unpack_hi(w[i].x);
        // EXTRA: a NaN distance (a zero-length capsule) stays NaN, as in
        // the plain version's clamp
        const float h = EXTRA ? max_keep_nan(eps - (dist - s[4]), 0.f) : fmaxf(eps - (dist - s[4]), 0.f);
        acc += h * h / sg[i];
        if (H2) h2[(long long)sp * T + cfg] = h * h;
        if (GRAD && (h > 0.f || (EXTRA && h != h))) {
          const int f = (int)s[0];
          float x, y, z;
          sphere_centre_shared(fr, C, f, s[1], s[2], s[3], x, y, z);
          const float k = h / sg[i];
          const float gx = k * (EXTRA ? gv[i][0] : unpack_lo(w[i].x)),
                      gy = k * (EXTRA ? gv[i][1] : unpack_hi(w[i].y)),
                      gz = k * (EXTRA ? gv[i][2] : unpack_lo(w[i].y));
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

template <int DOF, bool CRAIG, bool EXTRA>
cudaError_t launch_tile(bool grad, cudaStream_t st, const float* q, const float* sigma,
                        const float* robot, const float* spheres, const uint2* words,
                        const SceneExtras& ex, float* lik, float* dlik, float* h2, long long T,
                        long long K, int P, K1Grid g, float eps) {
  const size_t smem =
      sizeof(float) * ((size_t)FK_FRAME * (DOF + 1) * C + (size_t)(THREADS / C) * 8 * C + 5 * (size_t)P +
                       (EXTRA ? (size_t)extras_floats(ex) : 0));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // more spheres than the tile has room for
  const dim3 grid((unsigned)((T + C - 1) / C)), block(THREADS);
  if (h2 != nullptr)
    loglik_tile_kernel<DOF, CRAIG, true, true, EXTRA><<<grid, block, smem, st>>>(
        q, sigma, robot, spheres, words, ex, lik, dlik, h2, T, K, P, g, eps);
  else if (grad)
    loglik_tile_kernel<DOF, CRAIG, true, false, EXTRA><<<grid, block, smem, st>>>(
        q, sigma, robot, spheres, words, ex, lik, dlik, h2, T, K, P, g, eps);
  else
    loglik_tile_kernel<DOF, CRAIG, false, false, EXTRA><<<grid, block, smem, st>>>(
        q, sigma, robot, spheres, words, ex, lik, dlik, h2, T, K, P, g, eps);
  return cudaGetLastError();
}

template <int DOF, bool CRAIG>
cudaError_t launch_scene(bool grad, cudaStream_t st, const float* q, const float* sigma,
                         const float* robot, const float* spheres, const uint2* words,
                         const SceneExtras& ex, float* lik, float* dlik, float* h2, long long T,
                         long long K, int P, K1Grid g, float eps) {
  if (extras_floats(ex) > 0)
    return launch_tile<DOF, CRAIG, true>(grad, st, q, sigma, robot, spheres, words, ex, lik, dlik,
                                         h2, T, K, P, g, eps);
  return launch_tile<DOF, CRAIG, false>(grad, st, q, sigma, robot, spheres, words, ex, lik, dlik,
                                        h2, T, K, P, g, eps);
}

// k1_dsigma: block (r, y) holds DS_WARPS warps, warp w sphere p = y * DS_WARPS
// + w of row r. Its lanes stride over the row's K configs (coalesced reads of
// g and of the sphere's h^2 segment), DS_UNROLL loads of each in flight before
// the first use (a row is ~1 000 configs, so a lane makes a few such rounds
// and the time is a few memory latencies, not ~30), a shuffle tree joins the
// 32 lanes, and lane 0 scales by 1/2 / sigma^2.
constexpr int DS_WARPS = 8, DS_UNROLL = 8;

__global__ void __launch_bounds__(DS_WARPS * 32) dsigma_kernel(
    const float* __restrict__ g, const float* __restrict__ h2, const float* __restrict__ sigma,
    float* __restrict__ out, long long T, long long K, int P) {
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.y * DS_WARPS + threadIdx.x / 32;
  if (p >= P) return;  // the whole warp
  const long long r = blockIdx.x;
  const float* gr = g + r * K;
  const float* hp = h2 + (long long)p * T + r * K;
  float a0 = 0.f, a1 = 0.f;
  for (long long k = lane; k < K; k += 32 * DS_UNROLL) {
    float gv[DS_UNROLL], hv[DS_UNROLL];
#pragma unroll
    for (int j = 0; j < DS_UNROLL; ++j) {
      const bool in = k + 32 * j < K;
      gv[j] = in ? __ldg(gr + k + 32 * j) : 0.f;
      hv[j] = in ? __ldg(hp + k + 32 * j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DS_UNROLL; j += 2) {
      a0 += gv[j] * hv[j];
      a1 += gv[j + 1] * hv[j + 1];
    }
  }
  float acc = a0 + a1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float s = sigma[r * P + p];
    out[r * P + p] = 0.5f * acc / (s * s);
  }
}

}  // namespace

cudaError_t k1_loglik_launch(const float* q, const float* sigma, const float* robot,
                             const float* spheres, const void* words, const SceneExtras& ex,
                             float* lik, float* dlik, float* h2, int64_t T, int64_t K, int P,
                             int dof, bool craig, bool grad, K1Grid g, float eps,
                             cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (h2 != nullptr && !grad) return cudaErrorInvalidValue;
  const uint2* w = (const uint2*)words;
  if (dof == 7 && craig)
    return launch_scene<7, true>(grad, st, q, sigma, robot, spheres, w, ex, lik, dlik, h2, T, K, P,
                                 g, eps);
  if (dof == 7)
    return launch_scene<7, false>(grad, st, q, sigma, robot, spheres, w, ex, lik, dlik, h2, T, K,
                                  P, g, eps);
  if (dof == 6 && craig)
    return launch_scene<6, true>(grad, st, q, sigma, robot, spheres, w, ex, lik, dlik, h2, T, K, P,
                                 g, eps);
  if (dof == 6)
    return launch_scene<6, false>(grad, st, q, sigma, robot, spheres, w, ex, lik, dlik, h2, T, K,
                                  P, g, eps);
  return cudaErrorInvalidValue;
}

cudaError_t k1_dsigma_launch(const float* g, const float* h2, const float* sigma, float* out,
                             int64_t T, int64_t K, int P, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  const dim3 grid((unsigned)(T / K), (unsigned)((P + DS_WARPS - 1) / DS_WARPS));
  dsigma_kernel<<<grid, DS_WARPS * 32, 0, st>>>(g, h2, sigma, out, T, K, P);
  return cudaGetLastError();
}
