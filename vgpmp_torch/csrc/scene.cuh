// Device code shared by K1 (k1_collision.cuh) and K3 (k3_clearance.cuh): the
// grids' lookups, the scene's composition, and the scalar helpers both
// kernels template on the session's type S (float or double).
//
// A scene is the base grid plus, optionally, extra voxel grids at their own
// world offsets and analytic primitives (spheres, boxes with a world->box
// rotation, capsules): vgpmp_tpu/scene.py:Scene.distance takes the minimum
// over all of them, and so do the kernels, in the plain version's order
// (base, extra grids in order, spheres, boxes, capsules; fold_min). K1 reads
// each grid in the session's lookup mode (the packed nearest cell, an 8-byte
// word of the bf16 value and gradient, widened to S as JAX's .astype does;
// the nearest cell of the grid of S with its central difference; or the
// trilinear interpolation with its exact derivative), K3 by trilinear
// interpolation; both compute the primitives' value, and K1 their gradient,
// in S.
//
// The extras reach a kernel as device tensors (SceneExtras), which each block
// copies to shared memory beside its sphere table: moving an object rewrites a
// tensor, and no launch argument changes.
#pragma once

#include <cuda_runtime.h>

#include <math_constants.h>

#include "kernels.h"
#include "launch.cuh"

namespace {

// ------------------------------------------------------------ scalar helpers

__device__ __forceinline__ float s_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double s_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float s_floor(float x) { return floorf(x); }
__device__ __forceinline__ double s_floor(double x) { return floor(x); }
__device__ __forceinline__ float s_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double s_abs(double x) { return fabs(x); }
__device__ __forceinline__ float s_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double s_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float s_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double s_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float s_copysign(float a, float b) { return copysignf(a, b); }
__device__ __forceinline__ double s_copysign(double a, double b) { return copysign(a, b); }
__device__ __forceinline__ float s_mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double s_mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float s_fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double s_fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
template <class S> __device__ __forceinline__ S s_nan();
template <> __device__ __forceinline__ float s_nan<float>() { return CUDART_NAN_F; }
template <> __device__ __forceinline__ double s_nan<double>() { return CUDART_NAN; }
template <class S> __device__ __forceinline__ S s_inf();
template <> __device__ __forceinline__ float s_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double s_inf<double>() { return CUDART_INF; }

// ------------------------------------------------------------ packed lookup

__device__ __forceinline__ float unpack_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float unpack_lo(uint32_t w) { return __uint_as_float(w << 16); }

// a / b rounded to nearest, from inv = 1 / b rounded to nearest: the product
// and one fused correction (Markstein's theorem), the same bits as the
// division for quotients far from under- and overflow, in three instructions
// where the division takes about eight and a branch
template <class S>
__device__ __forceinline__ S div_by(S a, S b, S inv) {
  const S q = s_mul_rn(a, inv);
  return s_fma_rn(s_fma_rn(-q, b, a), inv, q);
}

// (p - o) / delta, the position in cells along one axis, as JAX divides it. In
// double, div_by (a double division is a Newton sequence with a slow-path
// branch; the reciprocal is one division a grid, hoisted out of a sphere
// loop); float keeps its division.
__device__ __forceinline__ float cell_coord(float p, float o, float delta) { return (p - o) / delta; }
__device__ __forceinline__ double cell_coord(double p, double o, double delta) {
  return div_by(p - o, delta, 1.0 / delta);
}

// the nearest cell of a mesh-frame point, clamped to the grid: its three
// indices in i, and the flat index
template <class S>
__device__ __forceinline__ long long nearest_cell(S px, S py, S pz, const GridArgs<S>& g,
                                                  int (&i)[3]) {
  i[0] = min(max((int)s_floor(cell_coord(px, g.ox, g.delta)), 0), g.nx - 1);
  i[1] = min(max((int)s_floor(cell_coord(py, g.oy, g.delta)), 0), g.ny - 1);
  i[2] = min(max((int)s_floor(cell_coord(pz, g.oz, g.delta)), 0), g.nz - 1);
  return ((long long)i[0] * g.ny + i[1]) * g.nz + i[2];
}

// ------------------------------------------------------- trilinear lookup

// clamp to [0, hi]; a NaN stays a NaN (fminf/fmaxf would drop it)
template <class S>
__device__ __forceinline__ S clamp_keep_nan(S v, S hi) {
  return v < S(0) ? S(0) : (v > hi ? hi : v);
}

// minimum and maximum that keep a NaN, as torch.min and torch.maximum do
template <class S>
__device__ __forceinline__ S min_keep_nan(S a, S b) {
  return (a != a) ? a : ((b != b) ? b : s_min(a, b));
}
template <class S>
__device__ __forceinline__ S max_keep_nan(S a, S b) {
  return (a != a) ? a : ((b != b) ? b : s_max(a, b));
}

// The cell a trilinear lookup at the mesh-frame point (px, py, pz)
// interpolates in: corners at origin + delta * (i, j, k), outside the grid
// the border values hold. The relative position is clamped to [0, n-1] and
// the base index to [0, n-2], so the fraction reaches exactly 1 on the upper
// border. inv_delta = 1 / g.delta. w[a] (where given) is the factor by which
// autodiff of the clamp passes axis a's gradient, as jnp.clip's maximum and
// minimum (and torch.maximum's and torch.minimum's) pass it: 1 inside
// (0, n-1), 1/2 exactly on the border, 0 outside, and 1 for a NaN position.
// Returns the flat index of the base corner (the binding refuses grids of
// 2^31 cells or more).
template <class S>
__device__ __forceinline__ S clip_weight(S u, S hi) {
  return (u < S(0) || u > hi) ? S(0) : ((u == S(0) || u == hi) ? S(0.5) : S(1));
}
template <class S>
__device__ __forceinline__ int trilinear_cell(S px, S py, S pz, const GridArgs<S>& g, S inv_delta,
                                              S (&f)[3], S* w = nullptr) {
  const S ux = div_by(px - g.ox, g.delta, inv_delta);
  const S uy = div_by(py - g.oy, g.delta, inv_delta);
  const S uz = div_by(pz - g.oz, g.delta, inv_delta);
  const S hx = (S)(g.nx - 1), hy = (S)(g.ny - 1), hz = (S)(g.nz - 1);
  if (w != nullptr) {
    w[0] = clip_weight(ux, hx);
    w[1] = clip_weight(uy, hy);
    w[2] = clip_weight(uz, hz);
  }
  const S rx = clamp_keep_nan(ux, hx), ry = clamp_keep_nan(uy, hy), rz = clamp_keep_nan(uz, hz);
  const int ix = min(max((int)s_floor(rx), 0), g.nx - 2);  // (int)NaN is 0
  const int iy = min(max((int)s_floor(ry), 0), g.ny - 2);
  const int iz = min(max((int)s_floor(rz), 0), g.nz - 2);
  f[0] = rx - (S)ix;
  f[1] = ry - (S)iy;
  f[2] = rz - (S)iz;
  return (ix * g.ny + iy) * g.nz + iz;
}

// The eight corners of the cell at p, through the read-only path; the two
// z-neighbours of a pair are adjacent words.
template <class S>
__device__ __forceinline__ void load_corners(const S* __restrict__ p, int sy, int sx, S (&c)[8]) {
  c[0] = __ldg(p);
  c[1] = __ldg(p + 1);
  c[2] = __ldg(p + sy);
  c[3] = __ldg(p + sy + 1);
  c[4] = __ldg(p + sx);
  c[5] = __ldg(p + sx + 1);
  c[6] = __ldg(p + sx + sy);
  c[7] = __ldg(p + sx + sy + 1);
}

// Seven lerps, z first, then y, then x, as the plain version takes them.
template <class S>
__device__ __forceinline__ S lerp_corners(const S (&c)[8], const S (&f)[3]) {
  const S fx = f[0], fy = f[1], fz = f[2];
  const S c00 = c[0] * (S(1) - fz) + c[1] * fz;
  const S c01 = c[2] * (S(1) - fz) + c[3] * fz;
  const S c10 = c[4] * (S(1) - fz) + c[5] * fz;
  const S c11 = c[6] * (S(1) - fz) + c[7] * fz;
  const S c0 = c00 * (S(1) - fy) + c01 * fy;
  const S c1 = c10 * (S(1) - fy) + c11 * fy;
  return c0 * (S(1) - fx) + c1 * fx;
}

// The spatial gradient of lerp_corners: the derivative along each axis of
// the fraction, times the clamp's weight w (trilinear_cell), over delta (as
// autodiff of the division gives it, a division): zero along an axis clamped
// outside the grid, half on its border.
template <class S>
__device__ __forceinline__ void lerp_gradient(const S (&c)[8], const S (&f)[3], const S (&w)[3],
                                              S delta, S (&gr)[3]) {
  const S fx = f[0], fy = f[1], fz = f[2];
  const S c00 = c[0] * (S(1) - fz) + c[1] * fz;
  const S c01 = c[2] * (S(1) - fz) + c[3] * fz;
  const S c10 = c[4] * (S(1) - fz) + c[5] * fz;
  const S c11 = c[6] * (S(1) - fz) + c[7] * fz;
  const S c0 = c00 * (S(1) - fy) + c01 * fy;
  const S c1 = c10 * (S(1) - fy) + c11 * fy;
  const S dx = c1 - c0;
  const S dy = (S(1) - fx) * (c01 - c00) + fx * (c11 - c10);
  const S dz = (S(1) - fx) * ((S(1) - fy) * (c[1] - c[0]) + fy * (c[3] - c[2])) +
               fx * ((S(1) - fy) * (c[5] - c[4]) + fy * (c[7] - c[6]));
  gr[0] = w[0] * dx / delta;
  gr[1] = w[1] * dy / delta;
  gr[2] = w[2] * dz / delta;
}

// ------------------------------------------------------------- the extras

// The extras' tables in shared memory: grid_f [G][SCENE_GRID_F], grid_i
// [G][SCENE_GRID_I] (as int bits, in the first bytes of their S slots) and
// the primitives, in that order.
template <class S>
struct ExtrasView {
  const S* gf;
  const int* gi;
  const S* pr;
  int G, Ks, Kb, Kc;
};

__host__ __device__ __forceinline__ int extras_prim_floats(const SceneExtras& e) {
  return e.Ks * SCENE_SPHERE + e.Kb * SCENE_BOX + e.Kc * SCENE_CAPSULE;
}

// the shared-memory slots of S the extras take
__host__ __device__ __forceinline__ int extras_floats(const SceneExtras& e) {
  return e.G * (SCENE_GRID_F + SCENE_GRID_I) + extras_prim_floats(e);
}

// Every thread of the block calls it; a __syncthreads() must follow before
// the view is read.
template <class S>
__device__ __forceinline__ ExtrasView<S> extras_to_shared(const SceneExtras& e, S* dst, int tid,
                                                          int nthreads) {
  const int nf = e.G * SCENE_GRID_F, ni = e.G * SCENE_GRID_I, np = extras_prim_floats(e);
  const S* gf = static_cast<const S*>(e.grid_f);
  const S* pr = static_cast<const S*>(e.prims);
  int* di = reinterpret_cast<int*>(dst + nf);
  for (int i = tid; i < nf; i += nthreads) dst[i] = gf[i];
  for (int i = tid; i < ni; i += nthreads) di[i] = e.grid_i[i];
  for (int i = tid; i < np; i += nthreads) dst[nf + ni + i] = pr[i];
  return ExtrasView<S>{dst, di, dst + nf + ni, e.G, e.Ks, e.Kb, e.Kc};
}

// extra grid e as a GridArgs (its world offset in bx, by, bz)
template <class S>
__device__ __forceinline__ GridArgs<S> extra_grid(const ExtrasView<S>& v, int e) {
  const S* f = v.gf + SCENE_GRID_F * e;
  const int* n = v.gi + SCENE_GRID_I * e;
  return GridArgs<S>{f[0], f[1], f[2], f[3], f[4], f[5], f[6], n[0], n[1], n[2]};
}

// extra grid e's first cell in the concatenated cells
template <class S>
__device__ __forceinline__ int extra_start(const ExtrasView<S>& v, int e) {
  return v.gi[SCENE_GRID_I * e + 3];
}

// Whether a source's value dk replaces the running minimum d: where it is
// smaller, and where it is NaN (a NaN minimum then stays), as torch.minimum
// propagates a NaN.
template <class S>
__device__ __forceinline__ bool takes(S dk, S d) { return dk < d || dk != dk; }

// Fold a source's value dk and (GRAD) gradient gk into the running minimum
// (d, g) as torch.minimum and jnp.minimum differentiate it: the gradient of
// the smaller value, and at a tie half of each (bf16 values of two packed
// grids tie often). Folding source by source in the plain version's order
// gives its weights at a tie of three as well.
template <bool GRAD, class S>
__device__ __forceinline__ void fold_min(S dk, const S (&gk)[3], S& d, S (&g)[3]) {
  if (takes(dk, d)) {
    d = dk;
    if (GRAD) {
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = gk[i];
    }
  } else if (GRAD && dk == d) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = S(0.5) * (g[i] + gk[i]);
  }
}

// Each primitive kind's signed distance at the world point (x, y, z) and
// its gradient, from the primitive's values p (kernels.h:SceneExtras): the
// value returns dk and keeps what the gradient reads. Every composition
// takes them: compose_primitives (K1's one-pass loop, K3) and K1's split
// design (primitives_min, primitive_gradient).
template <class S>
__device__ __forceinline__ S sphere_value(const S* p, S x, S y, S z, S (&v)[3], S& n) {
  v[0] = x - p[0];
  v[1] = y - p[1];
  v[2] = z - p[2];
  n = s_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  return n - p[3];
}
// p: centre (3), world->box rotation (9, row-major), half extents (3); l the
// local point, m its excess over the half extents (>= 0), outside |m|
template <class S>
__device__ __forceinline__ S box_value(const S* p, S x, S y, S z, S (&l)[3], S (&m)[3], S& outside) {
  const S wx = x - p[0], wy = y - p[1], wz = z - p[2];
  S q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    l[i] = p[3 + 3 * i] * wx + p[4 + 3 * i] * wy + p[5 + 3 * i] * wz;
    q[i] = s_abs(l[i]) - p[12 + i];
    m[i] = s_max(q[i], S(0));
  }
  outside = s_sqrt(m[0] * m[0] + m[1] * m[1] + m[2] * m[2]);
  const S inside = s_min(s_max(q[0], s_max(q[1], q[2])), S(0));
  return outside + inside;
}
// R^T (sign(l) * m / outside); inside, the NaN comes from bad
template <class S>
__device__ __forceinline__ void box_gradient(const S* p, const S (&l)[3], const S (&m)[3], S outside,
                                             S (&gk)[3]) {
  S gl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) gl[i] = s_copysign(m[i] / outside, l[i]);
#pragma unroll
  for (int j = 0; j < 3; ++j) gk[j] = p[3 + j] * gl[0] + p[6 + j] * gl[1] + p[9 + j] * gl[2];
}
// p: segment start a (3), end b (3), radius; v from the closest point
template <class S>
__device__ __forceinline__ S capsule_value(const S* p, S x, S y, S z, S (&v)[3], S& n) {
  const S abx = p[3] - p[0], aby = p[4] - p[1], abz = p[5] - p[2];
  const S apx = x - p[0], apy = y - p[1], apz = z - p[2];
  const S t = clamp_keep_nan((apx * abx + apy * aby + apz * abz) / (abx * abx + aby * aby + abz * abz),
                             S(1));
  v[0] = x - (p[0] + t * abx);
  v[1] = y - (p[1] + t * aby);
  v[2] = z - (p[2] + t * abz);
  n = s_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  return n - p[6];
}

// The primitives folded into the running minimum d at the world point
// (x, y, z) (fold_min), with (GRAD) its gradient g.
// bad is set where JAX's gradient of its composition is NaN, whatever source
// wins: jnp.linalg.norm's gradient at the zero vector is NaN, so a point at a
// sphere's centre, on a capsule's segment or inside or on a box (every
// |local| - h <= 0) has a NaN spatial gradient there.
template <bool GRAD, class S>
__device__ __forceinline__ void compose_primitives(const ExtrasView<S>& v, S x, S y, S z, S& d,
                                                   S (&g)[3], bool& bad) {
  const S* p = v.pr;
  for (int k = 0; k < v.Ks; ++k, p += SCENE_SPHERE) {
    S u[3], n;
    const S dk = sphere_value(p, x, y, z, u, n);
    if (GRAD) bad |= n == S(0);
    if (takes(dk, d) || (GRAD && dk == d)) fold_min<GRAD, S>(dk, {u[0] / n, u[1] / n, u[2] / n}, d, g);
  }
  for (int k = 0; k < v.Kb; ++k, p += SCENE_BOX) {
    S l[3], m[3], outside;
    const S dk = box_value(p, x, y, z, l, m, outside);
    if (GRAD) bad |= outside == S(0);
    if (takes(dk, d) || (GRAD && dk == d)) {
      S gk[3];
      box_gradient(p, l, m, outside, gk);
      fold_min<GRAD, S>(dk, gk, d, g);
    }
  }
  for (int k = 0; k < v.Kc; ++k, p += SCENE_CAPSULE) {
    S u[3], n;
    const S dk = capsule_value(p, x, y, z, u, n);
    if (GRAD) bad |= n == S(0);
    // the closest point's own motion is along the segment, normal to u
    if (takes(dk, d) || (GRAD && dk == d)) fold_min<GRAD, S>(dk, {u[0] / n, u[1] / n, u[2] / n}, d, g);
  }
}

// K1's split design: the running minimum d of a sphere's sources, the
// source src it came from and whether another source ties it (the gradient
// pass then takes src's gradient alone, or at a tie folds every source's
// in the plain version's order). A NaN replaces the minimum as takes() says.
template <class S>
__device__ __forceinline__ void fold_source(S dk, int src, S& d, int& win, bool& tie) {
  if (takes(dk, d)) {
    d = dk;
    win = src;
    tie = false;
  } else if (dk == d) {
    tie = true;
  }
}

// The primitives' values folded into (d, win, tie), the first primitive as
// source src0 (spheres, then boxes, then capsules), and (GRAD) bad as
// compose_primitives sets it.
template <bool GRAD, class S>
__device__ __forceinline__ void primitives_min(const ExtrasView<S>& v, S x, S y, S z, int src0, S& d,
                                               int& win, bool& tie, bool& bad) {
  const S* p = v.pr;
  int src = src0;
  for (int k = 0; k < v.Ks; ++k, ++src, p += SCENE_SPHERE) {
    S u[3], n;
    fold_source(sphere_value(p, x, y, z, u, n), src, d, win, tie);
    if (GRAD) bad |= n == S(0);
  }
  for (int k = 0; k < v.Kb; ++k, ++src, p += SCENE_BOX) {
    S l[3], m[3], outside;
    fold_source(box_value(p, x, y, z, l, m, outside), src, d, win, tie);
    if (GRAD) bad |= outside == S(0);
  }
  for (int k = 0; k < v.Kc; ++k, ++src, p += SCENE_CAPSULE) {
    S u[3], n;
    fold_source(capsule_value(p, x, y, z, u, n), src, d, win, tie);
    if (GRAD) bad |= n == S(0);
  }
}

// The gradient at (x, y, z) of primitive k (spheres, then boxes, then
// capsules), as compose_primitives computes it.
template <class S>
__device__ __forceinline__ void primitive_gradient(const ExtrasView<S>& v, int k, S x, S y, S z,
                                                   S (&g)[3]) {
  if (k < v.Ks) {
    S u[3], n;
    sphere_value(v.pr + SCENE_SPHERE * k, x, y, z, u, n);
    g[0] = u[0] / n, g[1] = u[1] / n, g[2] = u[2] / n;
  } else if (k < v.Ks + v.Kb) {
    const S* p = v.pr + SCENE_SPHERE * v.Ks + SCENE_BOX * (k - v.Ks);
    S l[3], m[3], outside;
    box_value(p, x, y, z, l, m, outside);
    box_gradient(p, l, m, outside, g);
  } else {
    S u[3], n;
    capsule_value(v.pr + SCENE_SPHERE * v.Ks + SCENE_BOX * v.Kb + SCENE_CAPSULE * (k - v.Ks - v.Kb), x,
                  y, z, u, n);
    g[0] = u[0] / n, g[1] = u[1] / n, g[2] = u[2] / n;
  }
}

}  // namespace
