// K3: metric clearance of a batch of configurations,
//   out[c] = min_p ( trilinear(sdf, FK(q_c)_p - base_offset) - r_p ),
// and, in its second entry, the success metric's floor compare fused in. The
// kernel template; k3_clearance.cu instantiates it in float (float32
// sessions), k3_clearance_f64.cu in double (float64 sessions: the FK, the
// float64 grid's corners, the lerps and the floor in double; the shared
// frames double in size).
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
// Design: the tile of K1 (k1_collision.cuh). A block of 256 threads takes 32
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
// shape) and the analytic primitives (scene.cuh's sphere_value, box_value and
// capsule_value, from the extras' tables in shared memory), the minimum
// keeping a NaN; the base-only instantiations are unchanged. The primitives
// took as long as an extra grid (PERF.md), so a primitive is evaluated only
// where it can attain the minimum: each has a bounding sphere (centre c,
// radius R; primitive_bounds), its value at a point x is at least |x - c| - R
// (for a box only outside its bounding sphere), and where |x - c| exceeds
// max(d, 0) + R + K3_CULL_MARGIN, for d the minimum so far, it lies above d
// by more than any rounding and is skipped (primitives_min_near). A box's
// value is also at least |l_k| - h_k along each of its axes k (l the local
// point, h the half extents), so a point farther than that from its
// thinnest slab is skipped too: a table's bounding sphere holds most of the
// arm, its slab little of it. The minimum is the same bits as the one over
// every source: a skipped value never attains it. A capsule of zero length,
// whose value is NaN, is never skipped.
// The clamps and the lerp order (z, then y, then x) are the plain version's,
// and dh_step (fk.cuh) is the one DH composition of K1 and K3, so the two
// kernels round alike and differ from the plain version by fused
// multiply-adds only. The floor's products are rounded one by one, and its
// division by the radius is a multiply by the reciprocal rounded to S, as
// PyTorch's CUDA division by a scalar is. A NaN configuration gives NaN, as the plain
// version does: the clamps and the minimum keep it, and a NaN probe is never
// counted as violated (a comparison with NaN is false).

#pragma once

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
template <class S>
__device__ __forceinline__ S ramp(S d, S inv_radius) {
  const S r = S(1) - s_mul_rn(d, inv_radius);
  return (r != r) ? r : s_max(r, S(0));
}

// k3_probe_clearance, phase 1: the tapered floor of the configuration cfg
// and its segment's flat index b * T + seg. A row that is not visited, or a
// segment index outside [0, T), gets the floor -inf, which no clearance lies
// below (a NaN neither).
template <int DOF, class S>
__device__ __forceinline__ void probe_floor(const S* __restrict__ q, long long cfg,
                                            const K3Probe<S>& pa, S& lim, long long& key) {
  const long long b = cfg / pa.G;
  const S* qc = q + cfg * DOF;
  const S* qa = pa.q_s + b * DOF;
  const S* qb = pa.q_g + b * DOF;
  S ds = S(0), dg = S(0);  // L_inf joint distance to the start and the goal
#pragma unroll
  for (int j = 0; j < DOF; ++j) {
    const S qj = qc[j];
    ds = max_keep_nan(ds, s_abs(qj - qa[j]));
    dg = max_keep_nan(dg, s_abs(qj - qb[j]));
  }
  const S allowed = max_keep_nan(s_mul_rn(pa.depth_s[b], ramp(ds, pa.inv_radius)),
                                 s_mul_rn(pa.depth_g[b], ramp(dg, pa.inv_radius)));
  const long long seg = pa.seg_idx[cfg];
  const bool counted = pa.visited[b] && seg >= 0 && seg < pa.T;
  lim = counted ? -allowed - pa.slack : -s_inf<S>();
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

// K3_CULL_MARGIN (metres): how far above the minimum so far a primitive's
// bound must lie to be skipped, far more than the rounding of the values
// and the bound (~1e-6 m in float) and far less than the distances
constexpr double K3_CULL_MARGIN = 1e-3;
// a primitive's bounds: its bounding sphere's centre (3) and radius; for a
// box, the world->box row of its thinnest axis (3) and that half extent
constexpr int PRIM_BOUND = 8;

// Each primitive's bounds into bound [Ks + Kb + Kc][PRIM_BOUND], from the
// primitives' table prims (kernels.h:SceneExtras): a sphere itself; a box's
// centre, the norm of its half extents and its thinnest slab; a capsule's
// midpoint and half its length plus its radius, R = +inf for a capsule of
// zero (or NaN) length, never skipped. Every thread of the block calls it.
template <class S>
__device__ __forceinline__ void primitive_bounds(const SceneExtras& ex, S* __restrict__ bound, int tid) {
  const S* pr = static_cast<const S*>(ex.prims);
  for (int k = tid; k < ex.Ks + ex.Kb + ex.Kc; k += THREADS) {
    S* b = bound + PRIM_BOUND * k;
    if (k < ex.Ks) {
      const S* p = pr + SCENE_SPHERE * k;
      b[0] = p[0], b[1] = p[1], b[2] = p[2], b[3] = p[3];
    } else if (k < ex.Ks + ex.Kb) {
      const S* p = pr + SCENE_SPHERE * ex.Ks + SCENE_BOX * (k - ex.Ks);
      b[0] = p[0], b[1] = p[1], b[2] = p[2];
      b[3] = s_sqrt(p[12] * p[12] + p[13] * p[13] + p[14] * p[14]);
      const int a = p[12] <= p[13] ? (p[12] <= p[14] ? 0 : 2) : (p[13] <= p[14] ? 1 : 2);
      b[4] = p[3 + 3 * a], b[5] = p[4 + 3 * a], b[6] = p[5 + 3 * a], b[7] = p[12 + a];
    } else {
      const S* p = pr + SCENE_SPHERE * ex.Ks + SCENE_BOX * ex.Kb + SCENE_CAPSULE * (k - ex.Ks - ex.Kb);
      const S ax = p[3] - p[0], ay = p[4] - p[1], az = p[5] - p[2], len2 = ax * ax + ay * ay + az * az;
      b[0] = p[0] + S(0.5) * ax, b[1] = p[1] + S(0.5) * ay, b[2] = p[2] + S(0.5) * az;
      b[3] = len2 > S(0) ? S(0.5) * s_sqrt(len2) + p[6] : s_inf<S>();
    }
  }
}

// The primitives folded into the running minimum d at the world point
// (x, y, z), as compose_primitives<false> folds them, each skipped where its
// bound lies above d (see the header).
template <class S>
__device__ __forceinline__ void primitives_min_near(const ExtrasView<S>& v, const S* __restrict__ bound,
                                                    S x, S y, S z, S& d) {
  const S* p = v.pr;
  const S* b = bound;
  // the bounding sphere, or a box's thinnest slab, lies above max(d, 0) + margin
  auto far = [&](const S* b) {
    const S dx = x - b[0], dy = y - b[1], dz = z - b[2];
    const S t = s_max(d, S(0)) + b[3] + S(K3_CULL_MARGIN);
    return dx * dx + dy * dy + dz * dz > t * t;
  };
  auto off_slab = [&](const S* b) {
    const S l = b[4] * (x - b[0]) + b[5] * (y - b[1]) + b[6] * (z - b[2]);
    return s_abs(l) - b[7] > s_max(d, S(0)) + S(K3_CULL_MARGIN);
  };
  for (int k = 0; k < v.Ks; ++k, p += SCENE_SPHERE, b += PRIM_BOUND) {
    if (far(b)) continue;
    S u[3], n;
    const S dk = sphere_value(p, x, y, z, u, n);
    if (takes(dk, d)) d = dk;
  }
  for (int k = 0; k < v.Kb; ++k, p += SCENE_BOX, b += PRIM_BOUND) {
    if (far(b) || off_slab(b)) continue;
    S l[3], m[3], outside;
    const S dk = box_value(p, x, y, z, l, m, outside);
    if (takes(dk, d)) d = dk;
  }
  for (int k = 0; k < v.Kc; ++k, p += SCENE_CAPSULE, b += PRIM_BOUND) {
    if (far(b)) continue;
    S u[3], n;
    const S dk = capsule_value(p, x, y, z, u, n);
    if (takes(dk, d)) d = dk;
  }
}

// robot and spheres: the constant tables described in fk.cuh. EXTRA: compose
// ex's sources.
template <class S, int DOF, bool CRAIG, bool PROBE, bool EXTRA>
__global__ void __launch_bounds__(THREADS) clearance_tile_kernel(
    const S* __restrict__ q, const S* __restrict__ robot, const S* __restrict__ spheres,
    const S* __restrict__ sdf, SceneExtras ex, S* __restrict__ out, long long n, int P,
    GridArgs<S> g, K3Probe<S> pa) {
  constexpr int NF = FK_FRAME * (DOF + 1);
  // the probes' segments take 8 bytes a config: 2 slots of float, 1 of double
  constexpr int KEY_SLOTS = (int)(sizeof(long long) / sizeof(S));
  extern __shared__ __align__(16) unsigned char k3_smem[];
  S* frames = reinterpret_cast<S*>(k3_smem);  // [NF][C]
  S* red = frames + NF * C;                    // [GROUPS][C]
  S* trig = red + GROUPS * C;                  // [DOF][2][C]: cos and sin of every joint angle
  S* lim = trig + 2 * DOF * C;                 // [C]: the probes' floors (k3_probe_clearance)
  long long* key = reinterpret_cast<long long*>(lim + C);  // [C]: their segments
  S* sph = lim + (1 + KEY_SLOTS) * C;          // [P][5]

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * C;
  for (int i = tid; i < 5 * P; i += THREADS) sph[i] = spheres[i];
  ExtrasView<S> xv{};
  S* bound = nullptr;  // EXTRA: the primitives' bounding spheres, beside the extras
  if constexpr (EXTRA) {
    xv = extras_to_shared(ex, sph + 5 * P, tid, THREADS);
    bound = sph + 5 * P + extras_floats(ex);
    primitive_bounds(ex, bound, tid);
  }
  // Phase 1: the tile's joint angles, one a thread (q read coalesced), to
  // cos and sin; then one thread a configuration composes the chain. The
  // same two steps as fk.cuh's joint_trig_to_shared and fk_chain_from_trig
  // (K1 in float64), written out here: through those helpers the base-only
  // probe entry took 40 registers where it takes 32 (PERF.md)
  const long long nq = (n - tile0 < C ? n - tile0 : C) * DOF;
  for (int e = tid; e < nq; e += THREADS) {
    const int c = e / DOF, j = e % DOF;
    joint_cos_sin(robot + 6 * j, q[tile0 * DOF + e], trig[2 * j * C + c], trig[(2 * j + 1) * C + c]);
  }
  __syncthreads();
  if (tid < C && tile0 + tid < n)
    fk_chain_to_shared_cs<DOF, CRAIG, S>(
        [&](int j, S& co, S& s) {
          co = trig[2 * j * C + tid];
          s = trig[(2 * j + 1) * C + tid];
        },
        robot, frames + tid, C);
  else if (PROBE && tid >= C && tid < 2 * C && tile0 + tid - C < n)  // warp 1, meanwhile
    probe_floor<DOF>(q, tile0 + tid - C, pa, lim[tid - C], key[tid - C]);
  __syncthreads();

  const int c = tid % C, grp = tid / C;
  const S* fr = frames + c;
  const int sy = g.nz, sx = g.ny * g.nz;
  const S inv_delta = S(1) / g.delta;
  S m = s_inf<S>();
  if (tile0 + c < n) {
    for (int sp = grp; sp < P; sp += GROUPS) {
      const S* s = sph + 5 * sp;
      S x, y, z, cv[8], f[3];
      sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
      load_corners(sdf + trilinear_cell(x - g.bx, y - g.by, z - g.bz, g, inv_delta, f), sy, sx, cv);
      S d = lerp_corners(cv, f);
      if constexpr (EXTRA) {
        const S* cells = static_cast<const S*>(ex.cells);
        for (int e = 0; e < xv.G; ++e) {
          const GridArgs<S> eg = extra_grid(xv, e);
          S ce[8], fe[3];
          const int cell = trilinear_cell(x - eg.bx, y - eg.by, z - eg.bz, eg, S(1) / eg.delta, fe);
          load_corners(cells + extra_start(xv, e) + cell, eg.nz, eg.ny * eg.nz, ce);
          d = min_keep_nan(d, lerp_corners(ce, fe));
        }
        primitives_min_near(xv, bound, x, y, z, d);
      }
      m = min_keep_nan(m, d - s[4]);
    }
  }
  red[grp * C + c] = m;
  __syncthreads();

  if (tid < C) {  // warp 0, whole
    const long long cfg = tile0 + tid;
    const bool live = cfg < n;
    S v = red[tid];
#pragma unroll
    for (int k = 1; k < GROUPS; ++k) v = min_keep_nan(v, red[k * C + tid]);
    if (live) out[cfg] = v;
    if (PROBE) probe_count(live && v < lim[tid], key[tid], pa.seg_count, tid);
  }
}


template <class S, int DOF, bool CRAIG, bool PROBE, bool EXTRA>
cudaError_t launch_tile(cudaStream_t st, const S* q, const S* robot, const S* spheres, const S* sdf,
                        const SceneExtras& ex, S* out, long long n, int P, GridArgs<S> g,
                        const K3Probe<S>& pa) {
  constexpr size_t KEY_SLOTS = sizeof(long long) / sizeof(S);
  const size_t smem =
      sizeof(S) * ((size_t)(FK_FRAME * (DOF + 1) + GROUPS + 2 * DOF + 1 + KEY_SLOTS) * C +
                   5 * (size_t)P +
                   (EXTRA ? (size_t)extras_floats(ex) + PRIM_BOUND * (size_t)(ex.Ks + ex.Kb + ex.Kc) : 0));
  const dim3 grid((unsigned)((n + C - 1) / C)), block(THREADS);
  return launch_smem(clearance_tile_kernel<S, DOF, CRAIG, PROBE, EXTRA>, grid, block, smem, st, q,
                     robot, spheres, sdf, ex, out, n, P, g, pa);
}

template <class S, int DOF, bool CRAIG, bool PROBE>
cudaError_t launch_scene(cudaStream_t st, const S* q, const S* robot, const S* spheres, const S* sdf,
                         const SceneExtras& ex, S* out, long long n, int P, GridArgs<S> g,
                         const K3Probe<S>& pa) {
  if (extras_floats(ex) > 0)
    return launch_tile<S, DOF, CRAIG, PROBE, true>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  return launch_tile<S, DOF, CRAIG, PROBE, false>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
}

template <bool PROBE, class S>
cudaError_t launch(const S* q, const S* robot, const S* spheres, const S* sdf,
                   const SceneExtras& ex, S* out, int64_t n, int P, int dof, bool craig,
                   GridArgs<S> g, const K3Probe<S>& pa, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  if (dof == 7 && craig)
    return launch_scene<S, 7, true, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  if (dof == 7)
    return launch_scene<S, 7, false, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  if (dof == 6 && craig)
    return launch_scene<S, 6, true, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  if (dof == 6)
    return launch_scene<S, 6, false, PROBE>(st, q, robot, spheres, sdf, ex, out, n, P, g, pa);
  return cudaErrorInvalidValue;
}

}  // namespace

template <class S>
cudaError_t k3_min_clearance_launch(const S* q, const S* robot, const S* spheres, const S* sdf,
                                    const SceneExtras& ex, S* out, int64_t T, int P, int dof,
                                    bool craig, GridArgs<S> g, cudaStream_t st) {
  return launch<false>(q, robot, spheres, sdf, ex, out, T, P, dof, craig, g, K3Probe<S>{}, st);
}

template <class S>
cudaError_t k3_probe_clearance_launch(const S* q, const S* robot, const S* spheres, const S* sdf,
                                      const SceneExtras& ex, S* out, int64_t n, int P, int dof,
                                      bool craig, GridArgs<S> g, const K3Probe<S>& probe,
                                      cudaStream_t st) {
  if (probe.G <= 0 || probe.T <= 0) return cudaErrorInvalidValue;
  return launch<true>(q, robot, spheres, sdf, ex, out, n, P, dof, craig, g, probe, st);
}
