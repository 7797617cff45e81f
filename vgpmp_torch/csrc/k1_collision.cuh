// K1: fused collision log-likelihood (FK -> SDF lookup -> hinge), forward and
// d/dq in one launch. The kernel template; each k1_*.cu source instantiates it
// for one scalar type and one lookup mode.
//
// Replaces the XLA-fused JAX chain of vgpmp_tpu/kinematics/dh.py:sphere_positions,
// vgpmp_tpu/scene.py:Scene.distance (packed mode, through
// vgpmp_tpu/sdf/grid.py:_packed_flat_index/_unpack_hi/_unpack_lo/
// packed_nearest_distance; nearest mode, through nearest_distance and
// central_difference_grad; trilinear mode, through trilinear_distance) and
// vgpmp_tpu/likelihoods/collision.py:CollisionModel.log_prob. The plain
// PyTorch version of the same function is
// vgpmp_torch/likelihoods/collision.py:log_prob_plain.
//
// What bounds it on an H100: the random gathers from the grid (the packed
// table is [ncells, 2] words, 222 MB for the industrial scene, the float32
// grid 111 MB, both larger than the 50 MB L2). Each sphere lookup touches a
// few 32-byte DRAM sectors (one for the packed word; the cell, and for the
// gradient of a hinge-active pair its six neighbours; or the eight corners),
// so the bound is the bytes of the distinct sectors a call needs over the
// memory rate; the FK chain and the hinge are a few hundred flops per config
// and never bind. What a kernel has to do about it is keep many independent
// gathers in flight and spend few instructions and registers around them.
//
// Design: a block of 256 threads takes a tile of 32 consecutive configurations
// (neighbours in time along a trajectory, so neighbours in space: their
// spheres share sectors).
//   Phase 1: one thread per configuration runs the DH chain once
//     (fk.cuh:fk_chain_to_shared) and leaves the frames in shared memory. In
//     double, and for the trilinear lookup, the block's 256 threads first
//     take the tile's joint angles to cos and sin, one each, as K3 does
//     (fk.cuh:joint_trig_to_shared), so the chain on one warp holds no trig:
//     seven warps otherwise wait on fourteen sin and cos in series (the
//     float32 packed and nearest lookups keep their machine code; ROADMAP.md).
//   Phase 2: thread (g, c) keeps local configuration c and the spheres g,
//     g + 8, g + 16, ..., so a warp holds the tile's 32 configurations of one
//     sphere: its shared-memory reads are conflict-free, the sphere's constants
//     are a broadcast, and its 32 gathers land near each other. A thread
//     computes the cells of NI spheres and starts all their gathers before it
//     uses one (GridLookup::fetch; NI is 5 for the packed word, 3 in double;
//     for the eight corners of the trilinear lookup one in float, two in
//     double).
//   Phase 3: the hinge, and for an active pair the joint torques from the
//     frames in shared memory (dlik/dq_j = sum_p (c_p/sigma_p) z_j . ((x_p -
//     o_j) x grad_p), from the gathered gradient, so the backward pass is a
//     multiply by the saved result and never gathers again: what the custom
//     VJP at vgpmp_tpu/sdf/grid.py:308-318 achieves). The eight partial sums
//     per configuration meet in shared memory, and lik [32] and dlik [32, DOF]
//     leave coalesced.
// No thread holds a configuration's frames in registers: the packed float32
// kernel takes 64 registers a thread with the gradient, 48 without, and
// spills nothing, so eight warps of a block and several blocks share an SM
// (PERF.md).
//
// That one-pass loop serves the base grid alone in the packed lookup (the
// main path: the word carries the gradient) and in the trilinear lookup (its
// value needs all eight corners, which its gradient reads too). The nearest
// cell and every composed scene take the split design instead
// (loglik_split, k1_split; the trilinear lookup's value pass is its own,
// loglik_split_corners): phases 2 and 3 in two passes over NV spheres at a
// time. The value pass gathers one cell entry of each grid
// per sphere, all in flight together, and computes the primitives' values
// while they fly; it keeps the minimum's value and the source that attains
// it. The gradient pass runs only for hinge-active pairs (12-26 % of them at
// the main path's inputs) and takes only that source's gradient: the
// neighbours of a nearest cell are gathered then, and a primitive's gradient
// is computed then. This drops the gathers and the arithmetic that d/dq
// never reads, and the registers the old pass held across its gathers (a
// composed float32 kernel: 80 registers, three blocks an SM, where the
// one-pass loop took 128 and spilled; PERF.md).
//
// The lookup modes (GridLookup): K1_PACKED gathers one 8-byte word, the bf16
// value and central-difference gradient (widened to S). K1_NEAREST is the
// reference's semantics on the unpacked grid: the value at the clipped cell
// floor((p - origin) / delta), and d/dp per axis (data[clip(i + e)] -
// data[clip(i - e)]) / (2 delta), divided as JAX divides (no reciprocal, so
// the test for an exactly-zero quotient, which becomes 0.1, sees JAX's
// quotient); the six neighbours are gathered only with the gradient.
// K1_TRILINEAR interpolates the eight corners (scene.cuh:trilinear_cell,
// lerp_corners, as K3) and takes the exact derivative that autodiff of the
// clip, floor and lerps gives: zero along an axis clamped outside the grid,
// half exactly on its border (jnp.clip's maximum and minimum split a tie),
// at the upper border the cell below with fraction 1, on a cell face the
// cell above (scene.cuh:lerp_gradient). The σ-gradient forward and
// k1_dsigma read h^2 and work in every mode unchanged.
//
// The scalar type S is the session's: float32 sessions run in float, float64
// sessions in double (the FK, the lookups' arithmetic, the hinge and the
// sums; the packed words stay bf16 and are widened, as JAX's
// .astype(p.dtype) does). The shared-memory frames then double in size (42 KB
// for 7 joints and 37 spheres); above 48 KB a launch opts in to more
// (launch.cuh:launch_smem).
//
// d/dsigma, where sigma_obs is trained: lik_t = -1/2 sum_p h_tp^2 / sigma_rp
// (r the row of config t), so dL/dsigma_rp = 1/2 sum_{t in r} g_t h_tp^2 /
// sigma_rp^2 for the upstream gradient g. The forward's H2 instantiation also
// writes h_tp^2, sphere-major ([P, T]: a warp holds 32 consecutive configs of
// one sphere, so its store is one 128-byte line, and the backward reads each
// (row, sphere) segment contiguously); the frozen path's instantiations are
// unchanged and write nothing more. k1_dsigma then reduces g * h^2 over each
// row's configs: reading h^2 back replaces a second gather from the table.
// It moves T (P + 1) values and does 2 T P operations, so it is bound by the
// bytes it reads.
// A scene with extra grids or primitives takes the EXTRA instantiation: each
// extra grid is looked up in the same mode (scene.cuh's extras, copied to
// shared memory beside the sphere table), the smallest value wins (its
// gradient; half of each at a tie, as autograd of the plain minimum), with
// the analytic primitives folded in, and the hinge reads that. Where a sphere
// centre lies inside or on a box its gradient is NaN, as JAX's is
// (scene.cuh:compose_primitives), so the config's d/dq is NaN in the joints
// that move the sphere, where its pair is hinge-active (JAX's autodiff gives
// NaN there even for an inactive pair, which only a negative epsilon makes
// possible; ROADMAP.md Queue 3).
// The compiler may contract the FK's products and sums into fused
// multiply-adds, so a sphere near a voxel face can land in the neighbouring
// voxel of the one the plain version picks; the checks bound that share.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fk.cuh"
#include "kernels.h"
#include "scene.cuh"

namespace {

// C configurations and THREADS threads a block: the tile that was fastest of
// six at the main path's shape (PERF.md).
constexpr int C = 32, THREADS = 256;

// the one-pass loop's gathers of NI spheres in flight a thread: five packed
// words in float, three in double (whose registers for each word's sphere
// would otherwise cut the blocks an SM holds; k1_blocks), or the eight
// trilinear corners of one sphere in float (two held 80 registers with the
// gradient, three blocks an SM, and were slower; PERF.md) and of two in
// double
template <class S, int MODE>
__host__ __device__ constexpr int k1_ni() {
  return MODE == K1_PACKED ? (sizeof(S) == 8 ? 3 : 5) : (sizeof(S) == 8 ? 2 : 1);
}

// Which instantiations take the split design (loglik_split): the value of
// every source first, the gradient only for hinge-active pairs. The
// base-only packed lookup (the main path: its word already carries the
// gradient) and the trilinear lookup (its value needs all eight corners)
// keep the one-pass loop.
template <class S, int MODE, bool EXTRA>
__host__ __device__ constexpr bool k1_split() {
  return MODE == K1_NEAREST || (MODE == K1_PACKED && EXTRA) || (MODE == K1_TRILINEAR && EXTRA);
}

// The split design's spheres a thread takes at a time, one cell entry of
// each grid apiece in flight: one for a composed scene, and for the float64
// nearest cell with the gradient, where the registers of a second would cut
// the blocks an SM holds more than its gathers gain; two otherwise (PERF.md).
// XG: the extra grids whose cells are gathered with the base grid's; grids
// beyond it are gathered one grid at a time after them.
template <class S, bool EXTRA, bool GRAD>
__host__ __device__ constexpr int k1_nv() {
  return EXTRA || (sizeof(S) == 8 && GRAD) ? 1 : 2;
}
constexpr int XG = 1;

// Whether the trilinear split design's value pass takes a grid's gradient
// from the corners it gathered, where that grid takes the minimum, and keeps
// the winner's, so that the gradient pass gathers nothing for a grid (float:
// faster than gathering again), or the gradient pass gathers the winner's
// corners again (double: the kept gradient's registers, under the 128 of two
// blocks an SM, made it slower; PERF.md).
template <class S>
__host__ __device__ constexpr bool k1_keep_gradient() {
  return sizeof(S) == 4;
}

// One sphere's lookup of a grid in a mode. The one-pass loop's (packed,
// trilinear): fetch issues its gathers, value and gradient read them (the
// gradient only after a fetch with GRAD). The split design's (packed,
// nearest): value_of reads the cell's entry, gradient_at gathers what the
// gradient needs; the trilinear value pass fetches and reads value, and
// value_at and gradient_at gather again where a tie needs every source.
template <class S, int MODE>
struct GridLookup;

template <class S>
struct GridLookup<S, K1_PACKED> {
  using Entry = uint2;
  uint2 w;
  template <bool GRAD>
  __device__ __forceinline__ void fetch(const uint2* __restrict__ t, const GridArgs<S>& g, S px,
                                        S py, S pz) {
    int i[3];
    w = __ldg(t + nearest_cell(px, py, pz, g, i));
  }
  // the split design: the word's value; the gradient from the word gathered
  // again
  __device__ __forceinline__ static S value_of(uint2 e) { return (S)unpack_hi(e.x); }
  __device__ __forceinline__ static void gradient_at(const uint2* __restrict__ t, const GridArgs<S>& g,
                                                     S px, S py, S pz, S (&gr)[3]) {
    GridLookup lk;
    lk.template fetch<true>(t, g, px, py, pz);
    lk.gradient(g, gr);
  }
  __device__ __forceinline__ S value() const { return (S)unpack_hi(w.x); }
  __device__ __forceinline__ void gradient(const GridArgs<S>&, S (&gr)[3]) const {
    gr[0] = (S)unpack_lo(w.x);
    gr[1] = (S)unpack_hi(w.y);
    gr[2] = (S)unpack_lo(w.y);
  }
};

template <class S>
struct GridLookup<S, K1_NEAREST> {
  using Entry = S;
  S nb[6];  // the cell's neighbours along +x, -x, +y, -y, +z, -z (clipped)
  // the six clipped neighbours of the cell c at indices i
  __device__ __forceinline__ void neighbours(const S* __restrict__ c, const int (&i)[3],
                                             const GridArgs<S>& g) {
    const int sx = g.ny * g.nz, sy = g.nz;  // grids of fewer than 2^31 cells
    nb[0] = __ldg(c + (i[0] < g.nx - 1 ? sx : 0));
    nb[1] = __ldg(c - (i[0] > 0 ? sx : 0));
    nb[2] = __ldg(c + (i[1] < g.ny - 1 ? sy : 0));
    nb[3] = __ldg(c - (i[1] > 0 ? sy : 0));
    nb[4] = __ldg(c + (i[2] < g.nz - 1 ? 1 : 0));
    nb[5] = __ldg(c - (i[2] > 0 ? 1 : 0));
  }
  // the split design: the cell's value; the gradient from its six clipped
  // neighbours, gathered only then
  __device__ __forceinline__ static S value_of(S e) { return e; }
  __device__ __forceinline__ static void gradient_at(const S* __restrict__ t, const GridArgs<S>& g, S px,
                                                     S py, S pz, S (&gr)[3]) {
    GridLookup lk;
    int i[3];
    lk.neighbours(t + nearest_cell(px, py, pz, g, i), i, g);
    lk.gradient(g, gr);
  }
  __device__ __forceinline__ void gradient(const GridArgs<S>& g, S (&gr)[3]) const {
    const S two_delta = S(2) * g.delta;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const S d = (nb[2 * a] - nb[2 * a + 1]) / two_delta;
      gr[a] = d == S(0) ? S(0.1) : d;  // the reference's escape from flat plateaus
    }
  }
};

template <class S>
struct GridLookup<S, K1_TRILINEAR> {
  using Entry = S;
  S c[8], f[3], w[3];
  template <bool GRAD>
  __device__ __forceinline__ void fetch(const S* __restrict__ t, const GridArgs<S>& g, S px, S py,
                                        S pz) {
    const int cell = trilinear_cell(px, py, pz, g, S(1) / g.delta, f, GRAD ? w : nullptr);
    load_corners(t + cell, g.nz, g.ny * g.nz, c);
  }
  __device__ __forceinline__ S value() const { return lerp_corners(c, f); }
  __device__ __forceinline__ void gradient(const GridArgs<S>& g, S (&gr)[3]) const {
    lerp_gradient(c, f, w, g.delta, gr);
  }
  // the split design: the value and the gradient at a point, the corners
  // gathered again for each
  __device__ __forceinline__ static S value_at(const S* __restrict__ t, const GridArgs<S>& g, S px, S py,
                                               S pz) {
    GridLookup lk;
    lk.template fetch<false>(t, g, px, py, pz);
    return lk.value();
  }
  __device__ __forceinline__ static void gradient_at(const S* __restrict__ t, const GridArgs<S>& g, S px,
                                                     S py, S pz, S (&gr)[3]) {
    GridLookup lk;
    lk.template fetch<true>(t, g, px, py, pz);
    lk.gradient(g, gr);
  }
};

// The split design's gradient at (x, y, z) where two sources tie for the
// minimum (rare): every source's gradient, folded in the plain version's
// order (fold_min, compose_primitives). Out of line, so that its registers
// do not count against the split design's.
template <class S, int MODE>
__device__ __noinline__ void tie_gradient(const GridArgs<S> g,
                                          const typename GridLookup<S, MODE>::Entry* table,
                                          const typename GridLookup<S, MODE>::Entry* cells,
                                          const ExtrasView<S> xv, int prim0, S x, S y, S z,
                                          S (&gr)[3]) {
  using Lookup = GridLookup<S, MODE>;
  S dd = s_inf<S>();
  for (int src = 0; src < prim0; ++src) {
    const GridArgs<S> gg = src == 0 ? g : extra_grid(xv, src - 1);
    const auto* t = src == 0 ? table : cells + extra_start(xv, src - 1);
    int ix[3];
    S gk[3];
    Lookup::gradient_at(t, gg, x - gg.bx, y - gg.by, z - gg.bz, gk);
    S dk;
    if constexpr (MODE == K1_TRILINEAR)
      dk = Lookup::value_at(t, gg, x - gg.bx, y - gg.by, z - gg.bz);
    else
      dk = Lookup::value_of(__ldg(t + nearest_cell(x - gg.bx, y - gg.by, z - gg.bz, gg, ix)));
    fold_min<true, S>(dk, gk, dd, gr);
  }
  bool unused = false;
  compose_primitives<true, S>(xv, x, y, z, dd, gr, unused);
}

// The split design: loglik_tile's phases 2 and 3 for the instantiations
// k1_split picks, a round of NV spheres of one thread at a time.
//   Value pass: for each sphere, its centre, the cell entry of the base grid
//     and of the first XG extra grids, all gathers issued before one is read;
//     the primitives' values computed while they fly (the centre is then
//     dead); the grids beyond XG one grid at a time. The composed value is
//     their minimum (a NaN kept), and beside it the source that attains it,
//     or -1 where another ties it (scene.cuh:fold_source), and the
//     primitives' NaN rule (bad); then the hinge, and a bit for each
//     hinge-active sphere (h > 0, or NaN where KEEP_NAN). Of the entries only
//     the winning grid's packed word, which carries the gradient, outlives
//     the pass.
//   Gradient pass, only for the active spheres: the centre again from the
//     frames and the gradient of the source that attains the minimum alone:
//     a grid's from its packed word, or in nearest mode from the cell's six
//     neighbours, gathered now; a primitive's from
//     scene.cuh:primitive_gradient. At a tie, every source's
//     (tie_gradient). Then the torques.
// lik and d/dq sum in the one-pass loop's order.
template <class S, int MODE, int DOF, bool CRAIG, bool GRAD, bool H2, bool EXTRA>
__device__ __forceinline__ void loglik_split(
    const S* __restrict__ fr, const S* __restrict__ sph, const S* __restrict__ sig, bool live,
    long long cfg, int grp, const typename GridLookup<S, MODE>::Entry* __restrict__ table,
    const SceneExtras& ex, const ExtrasView<S>& xv, S* __restrict__ h2, long long T, int P,
    const GridArgs<S>& g, S eps, S& acc, S (&dq)[DOF]) {
  using Lookup = GridLookup<S, MODE>;
  using Entry = typename Lookup::Entry;
  constexpr int G = THREADS / C;
  constexpr int NE = EXTRA ? XG : 0;  // extra grids gathered beside the base grid
  constexpr int NV = k1_nv<S, EXTRA, GRAD>();
  constexpr bool KEEP_NAN = EXTRA;    // a zero-length capsule's NaN stays
  const Entry* cells = static_cast<const Entry*>(ex.cells);
  // a source's index: 0 the base grid, 1 + e extra grid e, 1 + G + k primitive k
  const int prim0 = 1 + xv.G;
  // grid source src's placement and entries
  auto grid_of = [&](int src) { return src == 0 ? g : extra_grid(xv, src - 1); };
  auto entries_of = [&](int src) { return src == 0 ? table : cells + extra_start(xv, src - 1); };
  for (int base = grp; base < P; base += G * NV) {
    S k[NV];  // h / sigma
    int win[NV];
    Entry wn[MODE == K1_PACKED ? NV : 1];
    unsigned bad = 0, active = 0;  // a bit a sphere
    {
      Entry eb[NV], ee[NE > 0 ? NE : 1][NV];
      S d[NV], sg[NV];
      bool tie[NV];
      // fold grid source src's entry en into sphere i's minimum
      auto fold_grid = [&](int i, int src, Entry en) {
        fold_source(Lookup::value_of(en), src, d[i], win[i], tie[i]);
        if constexpr (MODE == K1_PACKED)
          if (win[i] == src) wn[i] = en;  // each source is folded once
      };
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int sp = base + G * i;
        if (live && sp < P) {
          const S* s = sph + 5 * sp;
          S x, y, z;
          int ix[3];
          sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
          eb[i] = __ldg(table + nearest_cell(x - g.bx, y - g.by, z - g.bz, g, ix));
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            if (e < xv.G) {
              const GridArgs<S> eg = extra_grid(xv, e);
              ee[e][i] = __ldg(cells + extra_start(xv, e) +
                               nearest_cell(x - eg.bx, y - eg.by, z - eg.bz, eg, ix));
            }
          }
          sg[i] = __ldg(sig + sp);
          d[i] = s_inf<S>();
          win[i] = -2;  // none yet
          tie[i] = false;
          if constexpr (EXTRA) {
            bool b = false;
            primitives_min<GRAD, S>(xv, x, y, z, prim0, d[i], win[i], tie[i], b);
            bad |= unsigned(b) << i;
          }
        }
      }
      if constexpr (EXTRA) {
        for (int e = NE; e < xv.G; ++e) {
          const GridArgs<S> eg = extra_grid(xv, e);
          const Entry* et = cells + extra_start(xv, e);
          Entry en[NV];
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int sp = base + G * i;
            if (live && sp < P) {
              const S* s = sph + 5 * sp;
              S x, y, z;
              int ix[3];
              sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
              en[i] = __ldg(et + nearest_cell(x - eg.bx, y - eg.by, z - eg.bz, eg, ix));
            }
          }
#pragma unroll
          for (int i = 0; i < NV; ++i)
            if (live && base + G * i < P) fold_grid(i, 1 + e, en[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int sp = base + G * i;
        if (live && sp < P) {
          fold_grid(i, 0, eb[i]);
#pragma unroll
          for (int e = 0; e < NE; ++e)
            if (e < xv.G) fold_grid(i, 1 + e, ee[e][i]);
          if (tie[i]) win[i] = -1;
          const S rad = sph[5 * sp + 4];
          const S h = KEEP_NAN ? max_keep_nan(eps - (d[i] - rad), S(0)) : s_max(eps - (d[i] - rad), S(0));
          acc += h * h / sg[i];
          if (H2) h2[(long long)sp * T + cfg] = h * h;
          k[i] = h / sg[i];
          if (h > S(0) || (KEEP_NAN && h != h)) active |= 1u << i;
        }
      }
    }
    if (!GRAD || active == 0) continue;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!(active >> i & 1)) continue;
      const int wi = win[i];
      const S* s = sph + 5 * (base + G * i);
      const int f = (int)s[0];
      S x, y, z;
      sphere_centre_shared(fr, C, f, s[1], s[2], s[3], x, y, z);
      S gr[3] = {S(0), S(0), S(0)};
      if (EXTRA && wi >= prim0) {
        primitive_gradient(xv, wi - prim0, x, y, z, gr);
      } else if (!EXTRA || wi >= 0) {
        if constexpr (MODE == K1_PACKED) {
          GridLookup<S, K1_PACKED> lk{wn[i]};
          lk.gradient(g, gr);
        } else {
          const GridArgs<S> gg = grid_of(wi);
          Lookup::gradient_at(entries_of(wi), gg, x - gg.bx, y - gg.by, z - gg.bz, gr);
        }
      } else {
        tie_gradient<S, MODE>(g, table, cells, xv, prim0, x, y, z, gr);
      }
      if (bad >> i & 1) gr[0] = gr[1] = gr[2] = s_nan<S>();
      const S gx = k[i] * gr[0], gy = k[i] * gr[1], gz = k[i] * gr[2];
#pragma unroll
      for (int j = 0; j < DOF; ++j) {
        if (j < f) {  // joint j moves frames j+1.. (both DH conventions)
          const S* A = fr + FK_FRAME * (CRAIG ? j + 1 : j) * C;
          const S rx = x - A[9 * C], ry = y - A[10 * C], rz = z - A[11 * C];
          const S mx = ry * gz - rz * gy, my = rz * gx - rx * gz, mz = rx * gy - ry * gx;
          dq[j] += A[2 * C] * mx + A[5 * C] * my + A[8 * C] * mz;
        }
      }
    }
  }
}

// The split design for the trilinear lookup (k1_split: the composed
// scene), loglik_split's two passes with a value pass of its own, since a
// grid's value needs eight corners and not one entry, one sphere of a
// thread at a time (two spilled; PERF.md): the sphere issues the eight
// corners of the base grid and of the first XG extra grids before one is
// read, the primitives' values computed while they fly; the grids beyond XG
// one grid at a time. Only the minimum's value and source outlive the pass,
// and in float (k1_keep_gradient) the winning grid's gradient, taken from
// its corners when it takes the minimum. The gradient pass, for a
// hinge-active sphere (or a NaN one), reads that kept gradient, or in double
// finds the source's cell and fractions again and gathers its eight corners
// again (scene.cuh:lerp_gradient, the clip weights and the division by delta
// as before either way); a primitive's gradient, or at a tie every source's
// (tie_gradient), as loglik_split does. Its own function, so that the packed
// and nearest instantiations keep their machine code.
template <class S, int DOF, bool CRAIG, bool GRAD, bool H2>
__device__ __forceinline__ void loglik_split_corners(
    const S* __restrict__ fr, const S* __restrict__ sph, const S* __restrict__ sig, bool live,
    long long cfg, int grp, const S* __restrict__ table, const SceneExtras& ex, const ExtrasView<S>& xv,
    S* __restrict__ h2, long long T, int P, const GridArgs<S>& g, S eps, S& acc, S (&dq)[DOF]) {
  using Lookup = GridLookup<S, K1_TRILINEAR>;
  constexpr int G = THREADS / C;
  constexpr bool KEEP = GRAD && k1_keep_gradient<S>();
  const S* cells = static_cast<const S*>(ex.cells);
  const int prim0 = 1 + xv.G;  // sources: 0 the base grid, 1 + e extra grid e, prim0 + k primitive k
  if (!live) return;
  for (int sp = grp; sp < P; sp += G) {
    const S* s = sph + 5 * sp;
    const S sg = __ldg(sig + sp);
    S d = s_inf<S>(), wg[3];  // the minimum, and with KEEP the winning grid's gradient
    int win = -2;             // none yet
    bool tie = false, bad = false;
    // fold grid source src's lookup lk (of grid gg) into the minimum
    auto fold_grid = [&](int src, const Lookup& lk, const GridArgs<S>& gg) {
      fold_source(lk.value(), src, d, win, tie);
      if constexpr (KEEP)
        if (win == src) lk.gradient(gg, wg);  // each source is folded once
    };
    {
      S x, y, z;
      sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
      Lookup lb, le[XG];
      lb.template fetch<KEEP>(table, g, x - g.bx, y - g.by, z - g.bz);
#pragma unroll
      for (int e = 0; e < XG; ++e) {
        if (e < xv.G) {
          const GridArgs<S> eg = extra_grid(xv, e);
          le[e].template fetch<KEEP>(cells + extra_start(xv, e), eg, x - eg.bx, y - eg.by, z - eg.bz);
        }
      }
      primitives_min<GRAD, S>(xv, x, y, z, prim0, d, win, tie, bad);
      for (int e = XG; e < xv.G; ++e) {
        const GridArgs<S> eg = extra_grid(xv, e);
        Lookup ln;
        ln.template fetch<KEEP>(cells + extra_start(xv, e), eg, x - eg.bx, y - eg.by, z - eg.bz);
        fold_grid(1 + e, ln, eg);
      }
      fold_grid(0, lb, g);
#pragma unroll
      for (int e = 0; e < XG; ++e)
        if (e < xv.G) fold_grid(1 + e, le[e], extra_grid(xv, e));
    }
    if (tie) win = -1;
    const S h = max_keep_nan(eps - (d - s[4]), S(0));
    acc += h * h / sg;
    if (H2) h2[(long long)sp * T + cfg] = h * h;
    if (!GRAD || !(h > S(0) || h != h)) continue;
    const int f = (int)s[0];
    S x, y, z;
    sphere_centre_shared(fr, C, f, s[1], s[2], s[3], x, y, z);
    S gr[3] = {S(0), S(0), S(0)};
    if (win >= prim0) {
      primitive_gradient(xv, win - prim0, x, y, z, gr);
    } else if (KEEP && win >= 0) {
      gr[0] = wg[0];
      gr[1] = wg[1];
      gr[2] = wg[2];
    } else if (win >= 0) {
      const GridArgs<S> gg = win == 0 ? g : extra_grid(xv, win - 1);
      Lookup::gradient_at(win == 0 ? table : cells + extra_start(xv, win - 1), gg, x - gg.bx, y - gg.by,
                          z - gg.bz, gr);
    } else {
      tie_gradient<S, K1_TRILINEAR>(g, table, cells, xv, prim0, x, y, z, gr);
    }
    if (bad) gr[0] = gr[1] = gr[2] = s_nan<S>();
    const S k = h / sg;
    const S gx = k * gr[0], gy = k * gr[1], gz = k * gr[2];
#pragma unroll
    for (int j = 0; j < DOF; ++j) {
      if (j < f) {  // joint j moves frames j+1.. (both DH conventions)
        const S* A = fr + FK_FRAME * (CRAIG ? j + 1 : j) * C;
        const S rx = x - A[9 * C], ry = y - A[10 * C], rz = z - A[11 * C];
        const S mx = ry * gz - rz * gy, my = rz * gx - rx * gz, mz = rx * gy - ry * gx;
        dq[j] += A[2 * C] * mx + A[5 * C] * my + A[8 * C] * mz;
      }
    }
  }
}

// The tile's work, the body of both kernel entries below. robot and
// spheres: the constant tables described in fk.cuh; table: the base grid's
// entries in MODE.
// H2: also write h^2 [P, T] (only with GRAD). EXTRA: compose ex's sources.
template <class S, int MODE, int DOF, bool CRAIG, bool GRAD, bool H2, bool EXTRA>
__device__ __forceinline__ void loglik_tile(
    const S* __restrict__ q, const S* __restrict__ sigma, const S* __restrict__ robot,
    const S* __restrict__ spheres, const typename GridLookup<S, MODE>::Entry* __restrict__ table,
    SceneExtras ex, S* __restrict__ lik, S* __restrict__ dlik, S* __restrict__ h2, long long T,
    long long K, int P, GridArgs<S> g, S eps) {
  using Lookup = GridLookup<S, MODE>;
  using Entry = typename Lookup::Entry;
  constexpr int G = THREADS / C;
  constexpr int NI = k1_ni<S, MODE>();
  constexpr int NF = FK_FRAME * (DOF + 1);
  constexpr int SLOTS = 8;  // 1 + DOF <= 8 partial sums per thread
  // a NaN distance (a NaN configuration in trilinear mode, a zero-length
  // capsule) stays NaN, as in the plain version's clamp
  constexpr bool KEEP_NAN = EXTRA || MODE == K1_TRILINEAR;
  static_assert(THREADS % C == 0 && C % 32 == 0 && DOF + 1 <= SLOTS, "tile shape");
  static_assert(2 * DOF <= (THREADS / C) * SLOTS, "the joints' sin and cos fit in red");
  static_assert(GRAD || !H2, "h^2 is written only beside the gradient");
  extern __shared__ __align__(16) unsigned char k1_smem[];
  S* frames = reinterpret_cast<S*>(k1_smem);  // [NF][C]
  S* red = frames + NF * C;                    // [G][SLOTS][C]
  S* sph = red + G * SLOTS * C;                // [P][5]

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * C;
  for (int i = tid; i < 5 * P; i += THREADS) sph[i] = spheres[i];
  ExtrasView<S> xv{};
  if constexpr (EXTRA) xv = extras_to_shared(ex, sph + 5 * P, tid, THREADS);
  if constexpr (sizeof(S) == 8 || MODE == K1_TRILINEAR) {
    // double, and the trilinear lookup: the block's threads take the tile's
    // sin and cos, one angle each, into red (free until phase 3), so that
    // the chain's serial part, on one warp of eight, holds no trig
    joint_trig_to_shared<DOF, C>(q, robot, red, tile0, T, tid, THREADS);
    __syncthreads();
    if (tid < C && tile0 + tid < T) fk_chain_from_trig<DOF, CRAIG, C>(red, robot, frames, tid);
  } else if (tid < C && tile0 + tid < T) {
    fk_chain_to_shared<DOF, CRAIG>(q + (tile0 + tid) * DOF, robot, frames + tid, C);
  }
  __syncthreads();

  const int c = tid % C, grp = tid / C;
  const long long cfg = tile0 + c;
  const bool live = cfg < T;
  const S* fr = frames + c;
  const S* sig = sigma + (live ? cfg / K : 0) * P;

  S acc = S(0);
  S dq[DOF];
#pragma unroll
  for (int j = 0; j < DOF; ++j) dq[j] = S(0);

  if constexpr (MODE == K1_TRILINEAR && k1_split<S, MODE, EXTRA>())
    loglik_split_corners<S, DOF, CRAIG, GRAD, H2>(fr, sph, sig, live, cfg, grp, table, ex, xv, h2, T, P, g,
                                                  eps, acc, dq);
  else if constexpr (k1_split<S, MODE, EXTRA>())
    loglik_split<S, MODE, DOF, CRAIG, GRAD, H2, EXTRA>(fr, sph, sig, live, cfg, grp, table, ex, xv,
                                                       h2, T, P, g, eps, acc, dq);
  else for (int base = grp; base < P; base += G * NI) {
    static_assert(!EXTRA, "a composed scene takes the split design");
    Lookup lk[NI];
    S sg[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int sp = base + G * i;
      if (live && sp < P) {
        const S* s = sph + 5 * sp;
        S x, y, z;
        sphere_centre_shared(fr, C, (int)s[0], s[1], s[2], s[3], x, y, z);
        lk[i].template fetch<GRAD>(table, g, x - g.bx, y - g.by, z - g.bz);
        sg[i] = __ldg(sig + sp);
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int sp = base + G * i;
      if (live && sp < P) {
        const S* s = sph + 5 * sp;
        const S dist = lk[i].value();
        const S h = KEEP_NAN ? max_keep_nan(eps - (dist - s[4]), S(0))
                             : s_max(eps - (dist - s[4]), S(0));
        acc += h * h / sg[i];
        if (H2) h2[(long long)sp * T + cfg] = h * h;
        if (GRAD && (h > S(0) || (KEEP_NAN && h != h))) {
          const int f = (int)s[0];
          S x, y, z;
          sphere_centre_shared(fr, C, f, s[1], s[2], s[3], x, y, z);
          S gr[3];
          lk[i].gradient(g, gr);
          const S k = h / sg[i];
          const S gx = k * gr[0], gy = k * gr[1], gz = k * gr[2];
#pragma unroll
          for (int j = 0; j < DOF; ++j) {
            if (j < f) {  // joint j moves frames j+1.. (both DH conventions)
              // frame whose z axis joint j turns about
              const S* A = fr + FK_FRAME * (CRAIG ? j + 1 : j) * C;
              const S rx = x - A[9 * C], ry = y - A[10 * C], rz = z - A[11 * C];
              const S mx = ry * gz - rz * gy, my = rz * gx - rx * gz, mz = rx * gy - ry * gx;
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
    S s = S(0);
#pragma unroll
    for (int k = 0; k < G; ++k) s += red[(k * SLOTS) * C + tid];
    lik[tile0 + tid] = S(-0.5) * s;
  }
  if (GRAD) {
    for (int e = tid; e < C * DOF; e += THREADS) {
      const int cc = e / DOF, j = e % DOF;
      if (tile0 + cc < T) {
        S s = S(0);
#pragma unroll
        for (int k = 0; k < G; ++k) s += red[(k * SLOTS + 1 + j) * C + cc];
        dlik[tile0 * DOF + e] = s;
      }
    }
  }
}

#define K1_TILE_PARAMS                                                                           \
  const S *__restrict__ q, const S *__restrict__ sigma, const S *__restrict__ robot,            \
      const S *__restrict__ spheres,                                                            \
      const typename GridLookup<S, MODE>::Entry *__restrict__ table, SceneExtras ex,            \
      S *__restrict__ lik, S *__restrict__ dlik, S *__restrict__ h2, long long T, long long K,  \
      int P, GridArgs<S> g, S eps
#define K1_TILE_ARGS q, sigma, robot, spheres, table, ex, lik, dlik, h2, T, K, P, g, eps

template <class S, int MODE, int DOF, bool CRAIG, bool GRAD, bool H2, bool EXTRA>
__global__ void __launch_bounds__(THREADS) loglik_tile_kernel(K1_TILE_PARAMS) {
  loglik_tile<S, MODE, DOF, CRAIG, GRAD, H2, EXTRA>(K1_TILE_ARGS);
}

// The blocks an SM must hold, which caps a thread's registers, where an
// instantiation names them (0: none named, the register budget as it was).
// A float32 scene with extras: three (80 registers) for the split design of
// the packed and nearest lookups, which fits them without a spill (one
// sphere at a time, the tie path out of line). The base grid alone in
// double, packed or nearest cell: three (80), which the packed lookup's
// three words in flight fit, and which the nearest cell's gradient pass
// would otherwise exceed (100-104 registers, two blocks). The float32
// trilinear lookup on the base grid, one sphere's corners in flight: five
// blocks (48) for the forward, four (64) with the gradient, where it took 60
// and 80 (four and three blocks). The composed trilinear lookup: two (128),
// in float32 with the winner's gradient kept (119; at three it was 19 %
// slower), in double where it would take 174 (PERF.md).
template <class S, int MODE, bool EXTRA, bool GRAD>
__host__ __device__ constexpr int k1_blocks() {
  if (MODE == K1_TRILINEAR) return EXTRA ? 2 : (sizeof(S) == 4 ? (GRAD ? 4 : 5) : 0);
  if (EXTRA && sizeof(S) == 4) return k1_split<S, MODE, EXTRA>() ? 3 : 2;
  return !EXTRA && sizeof(S) == 8 && MODE != K1_TRILINEAR ? 3 : 0;
}
template <class S, int MODE, int DOF, bool CRAIG, bool GRAD, bool H2, bool EXTRA>
__global__ void __launch_bounds__(THREADS, (k1_blocks<S, MODE, EXTRA, GRAD>()))
    loglik_tile_kernel_blocks(K1_TILE_PARAMS) {
  loglik_tile<S, MODE, DOF, CRAIG, GRAD, H2, EXTRA>(K1_TILE_ARGS);
}

template <class S, int MODE, int DOF, bool CRAIG, bool GRAD, bool H2, bool EXTRA>
cudaError_t launch_kernel(const K1Args<S>& a, const typename GridLookup<S, MODE>::Entry* table,
                          size_t smem, cudaStream_t st) {
  const dim3 grid((unsigned)((a.T + C - 1) / C)), block(THREADS);
  if constexpr (k1_blocks<S, MODE, EXTRA, GRAD>() > 0)
    return launch_smem(loglik_tile_kernel_blocks<S, MODE, DOF, CRAIG, GRAD, H2, EXTRA>, grid, block,
                       smem, st, a.q, a.sigma, a.robot, a.spheres, table, a.ex, a.lik, a.dlik, a.h2,
                       (long long)a.T, (long long)a.K, a.P, a.g, a.eps);
  else
    return launch_smem(loglik_tile_kernel<S, MODE, DOF, CRAIG, GRAD, H2, EXTRA>, grid, block, smem,
                       st, a.q, a.sigma, a.robot, a.spheres, table, a.ex, a.lik, a.dlik, a.h2,
                       (long long)a.T, (long long)a.K, a.P, a.g, a.eps);
}

template <class S, int MODE, int DOF, bool CRAIG, bool EXTRA>
cudaError_t launch_tile(const K1Args<S>& a, cudaStream_t st) {
  const size_t smem = sizeof(S) * ((size_t)FK_FRAME * (DOF + 1) * C + (size_t)(THREADS / C) * 8 * C +
                                   5 * (size_t)a.P + (EXTRA ? (size_t)extras_floats(a.ex) : 0));
  const auto* table = static_cast<const typename GridLookup<S, MODE>::Entry*>(a.table);
  if (a.h2 != nullptr) return launch_kernel<S, MODE, DOF, CRAIG, true, true, EXTRA>(a, table, smem, st);
  if (a.grad) return launch_kernel<S, MODE, DOF, CRAIG, true, false, EXTRA>(a, table, smem, st);
  return launch_kernel<S, MODE, DOF, CRAIG, false, false, EXTRA>(a, table, smem, st);
}

template <class S, int MODE, int DOF, bool CRAIG>
cudaError_t launch_scene(const K1Args<S>& a, cudaStream_t st) {
  if (extras_floats(a.ex) > 0) return launch_tile<S, MODE, DOF, CRAIG, true>(a, st);
  return launch_tile<S, MODE, DOF, CRAIG, false>(a, st);
}

// k1_dsigma: a warp a part of a (row, sphere) segment, the parts of a
// segment in one block, the warps numbered flat (seg = r * P + p, then the
// part), so that no warp of the grid is idle but in its last block. The
// segment's K configs are h2[p, r K ..] and g[r K ..]: the part's lanes take
// 16-byte vectors of both (float4, double2; DS_VEC of each a lane, all
// issued before the first product is summed), the scalars before h^2's
// first 16-byte boundary and after its last in the part that holds them
// (K = S N is not a multiple of 4 in every problemset, and a segment starts
// wherever p T + r K falls), and g as scalars where its own vector would not
// be aligned with h^2's. A segment takes the fewest parts (1, 2, 4 or 8)
// whose lanes hold it in one round. Each lane sums its products, a shuffle
// tree joins the 32 lanes, the parts meet in shared memory in order, and
// lane 0 of part 0 scales by 1/2 / sigma^2. Only sums and products: a NaN in
// g or h^2 reaches its (row, sphere) as the plain sum carries it.
constexpr int DS_WARPS = 8, DS_VEC = 4;

template <class S>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  __device__ __forceinline__ static float dot(float acc, float4 a, float4 b) {
    return acc + a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ __forceinline__ static float4 scalars(const float* p) {
    return float4{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ __forceinline__ static double dot(double acc, double2 a, double2 b) {
    return acc + a.x * b.x + a.y * b.y;
  }
  __device__ __forceinline__ static double2 scalars(const double* p) {
    return double2{__ldg(p), __ldg(p + 1)};
  }
};

// the parts a segment of K values of S takes (dsigma_kernel)
template <class S>
__host__ __device__ constexpr int dsigma_parts(long long K) {
  const long long per_part = 32LL * DS_VEC * (16 / sizeof(S));  // values a part's lanes hold in one round
  int parts = 1;
  while (parts < DS_WARPS && parts * per_part < K) parts *= 2;
  return parts;
}

template <class S>
__global__ void __launch_bounds__(DS_WARPS * 32) dsigma_kernel(
    const S* __restrict__ g, const S* __restrict__ h2, const S* __restrict__ sigma,
    S* __restrict__ out, long long T, int K, int P, int segs, int parts) {
  using V = Vec16<S>;
  using S16 = typename V::type;
  constexpr int W = 16 / sizeof(S);  // values a vector
  extern __shared__ __align__(16) unsigned char k1_smem[];
  S* part_sum = reinterpret_cast<S*>(k1_smem);  // [DS_WARPS], with more than one part
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int flat = blockIdx.x * DS_WARPS + warp;  // the launch holds fewer than 2^31 warps
  const int seg = flat / parts, part = flat % parts;
  S acc = S(0);
  if (seg < segs) {
    const int r = seg / P, p = seg % P;
    const S* gr = g + (long long)r * K;
    const S* hp = h2 + (long long)p * T + (long long)r * K;
    // h^2's scalars before its first 16-byte boundary, its vectors, then the tail
    const int head = min((int)((W - (reinterpret_cast<uintptr_t>(hp) / sizeof(S)) % W) % W), K);
    const int nvec = (K - head) / W, tail0 = head + nvec * W;
    const bool g_vec = reinterpret_cast<uintptr_t>(gr + head) % 16 == 0;
    const int per = (nvec + parts - 1) / parts;  // vectors a part
    const int lo = part * per, hi = min(nvec, lo + per);
    const S16* hv = reinterpret_cast<const S16*>(hp + head);
    const S16* gv = reinterpret_cast<const S16*>(gr + head);
    for (int v0 = lo; v0 < hi; v0 += 32 * DS_VEC) {
      S16 a[DS_VEC], b[DS_VEC];
#pragma unroll
      for (int i = 0; i < DS_VEC; ++i) {
        const int v = v0 + lane + 32 * i;
        if (v < hi) {
          a[i] = __ldg(hv + v);
          b[i] = g_vec ? __ldg(gv + v) : V::scalars(gr + head + v * W);
        }
      }
#pragma unroll
      for (int i = 0; i < DS_VEC; ++i)
        if (v0 + lane + 32 * i < hi) acc = V::dot(acc, a[i], b[i]);
    }
    if (part == 0) {
      // the head and the tail (fewer than W values each)
      const int e = lane < head ? lane : tail0 + (lane - head);
      if (e < K && (lane < head || e >= tail0)) acc += __ldg(hp + e) * __ldg(gr + e);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (parts > 1) {  // the same for every thread of the launch
    if (lane == 0) part_sum[warp] = acc;
    __syncthreads();
    if (part == 0 && lane == 0)
      for (int k = 1; k < parts; ++k) acc += part_sum[warp + k];
  }
  if (seg < segs && part == 0 && lane == 0) {
    const S s = sigma[seg];
    out[seg] = S(0.5) * acc / (s * s);
  }
}

}  // namespace

template <class S, int MODE>
cudaError_t k1_loglik_launch(const K1Args<S>& a, cudaStream_t st) {
  if (a.T == 0) return cudaSuccess;
  if (a.h2 != nullptr && !a.grad) return cudaErrorInvalidValue;
  if (a.dof == 7 && a.craig) return launch_scene<S, MODE, 7, true>(a, st);
  if (a.dof == 7) return launch_scene<S, MODE, 7, false>(a, st);
  if (a.dof == 6 && a.craig) return launch_scene<S, MODE, 6, true>(a, st);
  if (a.dof == 6) return launch_scene<S, MODE, 6, false>(a, st);
  return cudaErrorInvalidValue;
}

template <class S>
cudaError_t k1_dsigma_launch(const S* g, const S* h2, const S* sigma, S* out, int64_t T,
                             int64_t K, int P, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  const long long segs = (T / K) * P;
  const int parts = dsigma_parts<S>(K);
  if (K >= (1LL << 31) || segs * parts >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((segs * parts + DS_WARPS - 1) / DS_WARPS));
  return launch_smem(dsigma_kernel<S>, grid, dim3(DS_WARPS * 32), parts > 1 ? DS_WARPS * sizeof(S) : 0, st,
                     g, h2, sigma, out, (long long)T, (int)K, P, (int)segs, parts);
}
