// K3: metric clearance of a batch of configurations,
//   out[c] = min_p ( trilinear(sdf, FK(q_c)_p - base_offset) - r_p ),
// and, in its second entry, the success metric's floor compare fused in.
//
// Replaces the XLA-fused JAX chain that the success metric evaluates over the
// PD-path probes: vgpmp_tpu/likelihoods/collision.py:sphere_clearance_eval
// (vgpmp_tpu/kinematics/dh.py:sphere_positions, then
// vgpmp_tpu/scene.py:Scene.distance with mode_override="trilinear", that is
// vgpmp_tpu/sdf/grid.py:trilinear_distance) followed by the minimum over
// spheres, and, in k3_probe_clearance, the tapered floor, the compare and the
// per-segment scatter-or of vgpmp_tpu/engine/validator.py:execute_and_validate
// and vgpmp_tpu/sim.py:kinematic_execute_trajectory, which XLA fuses into
// the same region. The plain PyTorch versions are
// vgpmp_torch/likelihoods/collision.py:min_clearance_eval_plain and
// vgpmp_torch/sim.py:probe_clearance_plain. Forward only: the metric is never
// differentiated.
//
// What bounds it on an H100: operations, narrowly. The eight corner loads per
// sphere come from the float32 grid (111 MB for the industrial scene, larger
// than the 50 MB L2), but neighbouring probes of a PD path are at most one
// controller step apart, so their corners share most 32-byte sectors and the
// bytes are fewer than the work: per config a DH chain of seven steps and,
// per sphere, a centre, three divisions, the clamps and seven lerps.
//
// Design: the tile of K1 (k1_collision.cu). A block of 256 threads takes 32
// consecutive configurations.
//   Phase 1: the block's threads take the tile's 32 x DOF joint angles, one
//     each, to cos and sin; then one thread per configuration composes the
//     DH chain once (fk.cuh:fk_chain_to_shared_cs) into element-major frames
//     in shared memory, so the serial part of the chain holds no sin or cos.
//     The sphere table is copied beside them.
//   Phase 2: thread (g, c) keeps local configuration c and the spheres g,
//     g + 8, g + 16, ..., so a warp holds one sphere at 32 consecutive probes:
//     its shared-memory reads are conflict-free, the sphere's constants a
//     broadcast, and its corner loads land in a few sectors. A thread issues
//     a sphere's eight corner loads before it uses one; its minimum over its
//     spheres stays in registers. More spheres' loads in flight a thread (2, 3
//     and 5 were tried) cost registers, so fewer blocks share an SM, and were
//     slower (PERF.md).
//   Phase 3: the eight partial minima of a configuration meet in shared
//     memory, and warp 0 writes the tile's 32 minima in one coalesced store.
//     In k3_probe_clearance warp 1 has meanwhile (during phase 1's chain)
//     computed each probe's tapered floor (L_inf joint distance to each query
//     endpoint, the ramp, the endpoint depths) and segment, so warp 0 only
//     compares and adds the warp's violated probes to their segment's count
//     with one integer atomic per segment (lanes of one segment found by
//     __match_any_sync). Integer sums give the same counts on every run.
// Per sphere the kernel spends about a hundred instructions, so it trims them:
// the cell offsets are 32-bit (grids under 2^31 cells), and the three
// divisions by the voxel edge are a multiply by its reciprocal and one fused
// correction, which rounds as the division does (div_by).
// A scene with extra grids or primitives takes the EXTRA instantiation: per
// sphere, after the base grid's eight corners, each extra grid's eight
// corners (the same trilinear_cell, on its own offset, origin, delta and
// shape) and the analytic primitives (scene.cuh:compose_primitives, from the
// extras' tables in shared memory), the minimum keeping a NaN; the base-only
// instantiations are unchanged.
// The clamps and the lerp order (z, then y, then x) are the plain version's,
// and dh_step (fk.cuh) is the one DH composition of K1 and K3, so the two
// kernels round alike and differ from the plain version by fused
// multiply-adds only. The floor's products are rounded one by one, and its
// division by the radius is a multiply by the float32 reciprocal, as PyTorch's
// CUDA division by a scalar is. A NaN configuration gives NaN, as the plain
// version does: the clamps and the minimum keep it, and a NaN probe is never
// counted as violated (a comparison with NaN is false).

#include <cuda_runtime.h>

#include <math_constants.h>

#include "fk.cuh"
#include "kernels.h"
#include "scene.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// C configurations and THREADS threads a block, as K1
constexpr int C = 32, THREADS = 256;
constexpr int GROUPS = THREADS / C;  // sphere groups: thread (g, c) takes spheres g, g + 8, ...
static_assert(THREADS % C == 0 && C == 32, "phase 3 runs in one warp");

// clamp(1 - d / radius, min=0) with the division as a multiply by the
// reciprocal, rounded as PyTorch's two elementwise kernels round it
__device__ __forceinline__ float ramp(float d, float inv_radius) {
  const float r = 1.f - __fmul_rn(d, inv_radius);
  return (r != r) ? r : fmaxf(r, 0.f);
}

// k3_probe_clearance, phase 1: the tapered floor of the configuration cfg
// and its segment's flat index b * T + seg. A row that is not visited, or a
// segment index outside [0, T), gets the floor -inf, which no clearance lies
// below (a NaN neither).
template <int DOF>
__device__ __forceinline__ void probe_floor(const float* __restrict__ q, long long cfg,
                                            const K3Probe& pa, float& lim, long long& key) {
  const long long b = cfg / pa.G;
  const float* qc = q + cfg * DOF;
  const float* qa = pa.q_s + b * DOF;
  const float* qb = pa.q_g + b * DOF;
  float ds = 0.f, dg = 0.f;  // L_inf joint distance to the start and the goal
#pragma unroll
  for (int j = 0; j < DOF; ++j) {
    const float qj = qc[j];
    ds = max_keep_nan(ds, fabsf(qj - qa[j]));
    dg = max_keep_nan(dg, fabsf(qj - qb[j]));
  }
  const float allowed = max_keep_nan(__fmul_rn(pa.depth_s[b], ramp(ds, pa.inv_radius)),
                                     __fmul_rn(pa.depth_g[b], ramp(dg, pa.inv_radius)));
  const long long seg = pa.seg_idx[cfg];
  const bool counted = pa.visited[b] && seg >= 0 && seg < pa.T;
  lim = counted ? -allowed - pa.slack : -CUDART_INF_F;
  key = b * pa.T + seg;
}

// k3_probe_clearance, phase 3: the warp's violated probes added to their
// segments, one atomic per segment. Every lane of the warp calls it.
__device__ __forceinline__ void probe_count(bool viol, long long key, int32_t* seg_count, int lane) {
  const unsigned who = __ballot_sync(FULL, viol);
  if (viol) {
    const unsigned same = __match_any_sync(who, (unsigned long long)key);
    if (__ffs(same) - 1 == lane) atomicAdd(seg_count + key, __popc(same));
  }
}

// robot and spheres: the constant tables described in fk.cuh. EXTRA: compose
// ex's sources.
template <int DOF, bool CRAIG, bool PROBE, bool EXTRA>
__global__ void __launch_bounds__(THREADS) clearance_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ robot,
    const float* __restrict__ spheres, const float* __restrict__ sdf, SceneExtras ex,
    float* __restrict__ out, long long n, int P, K1Grid g, K3Probe pa) {
  constexpr int NF = FK_FRAME * (DOF + 1);
  extern __shared__ float smem[];
  float* frames = smem;              // [NF][C]
  float* red = frames + NF * C;      // [GROUPS][C]
  float* trig = red + GROUPS * C;    // [DOF][2][C]: cos and sin of every joint angle
  float* lim = trig + 2 * DOF * C;   // [C]: the probes' floors (k3_probe_clearance)
  long long* key = reinterpret_cast<long long*>(lim + C);  // [C]: their segments
  float* sph = lim + 3 * C;          // [P][5]

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * C;
  for (int i = tid; i < 5 * P; i += THREADS) sph[i] = spheres[i];
  ExtrasView xv{};
  if constexpr (EXTRA) xv = extras_to_shared(ex, sph + 5 * P, tid, THREADS);
  // Phase 1: the tile's joint angles, one a thread (q read coalesced), to
  // cos and sin; then one thread a configuration composes the chain
  const long long nq = (n - tile0 < C ? n - tile0 : C) * DOF;
  for (int e = tid; e < nq; e += THREADS) {
    const int c = e / DOF, j = e % DOF;
    joint_cos_sin(robot + 6 * j, q[tile0 * DOF + e], trig[2 * j * C + c], trig[(2 * j + 1) * C + c]);
  }
  __syncthreads();
  if (tid < C && tile0 + tid < n)
    fk_chain_to_shared_cs<DOF, CRAIG>(
        [&](int j, float& co, float& s) {
          co = trig[2 * j * C + tid];
          s = trig[(2 * j + 1) * C + tid];
        },
        robot, frames + tid, C);
  else if (PROBE && tid >= C && tid < 2 * C && tile0 + tid - C < n)  // warp 1, meanwhile
    probe_floor<DOF>(q, tile0 + tid - C, pa, lim[tid - C], key[tid - C]);
  __syncthreads();

  const int c = tid % C, grp = tid / C;
  const float* fr = frames + c;
  const int sy = g.nz, sx = g.ny * g.nz;
  const float inv_delta = 1.f / g.delta;
  float m = CUDART_INF_F;
  if (tile0 + c < n) {
    for (int sp = grp; sp < P; sp += GROUPS) {
      const float* s = sph + 5 * sp;
      float x, y, z, cv[8], f[3];
      sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
      load_corners(sdf + trilinear_cell(x - g.bx, y - g.by, z - g.bz, g, inv_delta, f), sy, sx, cv);
      float d = lerp_corners(cv, f);
      if constexpr (EXTRA) {
        const float* cells = static_cast<const float*>(ex.cells);
        for (int e = 0; e < xv.G; ++e) {
          const K1Grid eg = extra_grid(xv, e);
          float ce[8], fe[3];
          const int cell = trilinear_cell(x - eg.bx, y - eg.by, z - eg.bz, eg, 1.f / eg.delta, fe);
          load_corners(cells + extra_start(xv, e) + cell, eg.nz, eg.ny * eg.nz, ce);
          d = min_keep_nan(d, lerp_corners(ce, fe));
        }
        float unused_g[3];
        bool unused_bad = false;
        compose_primitives<false>(xv, x, y, z, d, unused_g, unused_bad);
      }
      m = min_keep_nan(m, d - s[4]);
    }
  }
  red[grp * C + c] = m;
  __syncthreads();

  if (tid < C) {  // warp 0, whole
    const long long cfg = tile0 + tid;
    const bool live = cfg < n;
    float v = red[tid];
#pragma unroll
    for (int k = 1; k < GROUPS; ++k) v = min_keep_nan(v, red[k * C + tid]);
    if (live) out[cfg] = v;
    if (PROBE) probe_count(live && v < lim[tid], key[tid], pa.seg_count, tid);
  }
}

template <int DOF, bool CRAIG, bool PROBE, bool EXTRA>
cudaError_t launch_tile(cudaStream_t st, const float* q, const float* robot, const float* spheres,
                        const float* sdf, const SceneExtras& ex, float* out, long long n, int P,
                        K1Grid g, const K3Probe& pa) {
  const size_t smem =
      sizeof(float) * ((size_t)(FK_FRAME * (DOF + 1) + GROUPS + 2 * DOF + 3) * C + 5 * (size_t)P +
                       (EXTRA ? (size_t)extras_floats(ex) : 0));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // more spheres than the tile has room for
  const dim3 grid((unsigned)((n + C - 1) / C)), block(THREADS);
  clearance_tile_kernel<DOF, CRAIG, PROBE, EXTRA><<<grid, block, smem, st>>>(q, robot, spheres, sdf,
                                                                             ex, out, n, P, g, pa);
  return cudaGetLastError();
}

template <int DOF, bool CRAIG, bool PROBE>
cudaError_t launch_scene(cudaStream_t st, const float* q, const float* robot, const float* spheres,
                         const float* sdf, const SceneExtras& ex, float* out, long long n, int P,
                         K1Grid g, const K3Probe& pa) {
  if (extras_floats(ex) > 0)
    return launch_tile<DOF, CRAIG, PROBE, true>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  return launch_tile<DOF, CRAIG, PROBE, false>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
}

template <bool PROBE>
cudaError_t launch(const float* q, const float* robot, const float* spheres, const float* sdf,
                   const SceneExtras& ex, float* out, int64_t n, int P, int dof, bool craig,
                   K1Grid g, const K3Probe& pa, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  if (dof == 7 && craig)
    return launch_scene<7, true, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  if (dof == 7)
    return launch_scene<7, false, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  if (dof == 6 && craig)
    return launch_scene<6, true, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  if (dof == 6)
    return launch_scene<6, false, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t k3_min_clearance_launch(const float* q, const float* robot, const float* spheres,
                                    const float* sdf, const SceneExtras& ex, float* out,
                                    int64_t T, int P, int dof, bool craig, K1Grid g,
                                    cudaStream_t st) {
  return launch<false>(q, robot, spheres, sdf, ex, out, T, P, dof, craig, g, K3Probe{}, st);
}

cudaError_t k3_probe_clearance_launch(const float* q, const float* robot, const float* spheres,
                                      const float* sdf, const SceneExtras& ex, float* out,
                                      int64_t n, int P, int dof, bool craig, K1Grid g,
                                      const K3Probe& probe, cudaStream_t st) {
  if (probe.G <= 0 || probe.T <= 0) return cudaErrorInvalidValue;
  return launch<true>(q, robot, spheres, sdf, ex, out, n, P, dof, craig, g, probe, st);
}
