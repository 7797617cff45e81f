// Device code shared by K1 (k1_collision.cu) and K3 (k3_clearance.cu): the
// scene's lookups and their composition.
//
// A scene is the base grid plus, optionally, extra voxel grids at their own
// world offsets and analytic primitives (spheres, boxes with a world->box
// rotation, capsules): vgpmp_tpu/scene.py:Scene.distance takes the minimum
// over all of them, and so do the kernels, in the plain version's order
// (base, extra grids in order, spheres, boxes, capsules; fold_min). K1 reads each grid as the packed nearest cell (an 8-byte word:
// the bf16 value and gradient), K3 by trilinear interpolation of the float32
// grid; both compute the primitives' value, and K1 their gradient, in float32.
//
// The extras reach a kernel as device tensors (SceneExtras), which each block
// copies to shared memory beside its sphere table: moving an object rewrites a
// tensor, and no launch argument changes.
#pragma once

#include <cuda_runtime.h>

#include <math_constants.h>

#include "kernels.h"

namespace {

// ------------------------------------------------------------ packed lookup

__device__ __forceinline__ float unpack_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float unpack_lo(uint32_t w) { return __uint_as_float(w << 16); }

// the nearest cell of a mesh-frame point, clamped to the grid
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

// ------------------------------------------------------- trilinear lookup

// clamp to [0, hi]; a NaN stays a NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return v < 0.f ? 0.f : (v > hi ? hi : v);
}

// minimum and maximum that keep a NaN, as torch.min and torch.maximum do
__device__ __forceinline__ float min_keep_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// a / b rounded to nearest, from inv = 1 / b rounded to nearest: the product
// and one fused correction (Markstein's theorem), the same bits as the
// division for quotients far from under- and overflow, in three instructions
// where the division takes about eight and a branch
__device__ __forceinline__ float div_by(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv, q);
}

// The cell a trilinear lookup at the mesh-frame point (px, py, pz)
// interpolates in: corners at origin + delta * (i, j, k), outside the grid
// the border values hold. The relative position is clamped to [0, n-1] and
// the base index to [0, n-2], so the fraction reaches exactly 1 on the upper
// border. inv_delta = 1 / g.delta. Returns the flat index of the base corner
// (the binding refuses grids of 2^31 cells or more).
__device__ __forceinline__ int trilinear_cell(float px, float py, float pz, const K1Grid& g,
                                              float inv_delta, float (&f)[3]) {
  const float rx = clamp_keep_nan(div_by(px - g.ox, g.delta, inv_delta), (float)(g.nx - 1));
  const float ry = clamp_keep_nan(div_by(py - g.oy, g.delta, inv_delta), (float)(g.ny - 1));
  const float rz = clamp_keep_nan(div_by(pz - g.oz, g.delta, inv_delta), (float)(g.nz - 1));
  const int ix = min(max((int)floorf(rx), 0), g.nx - 2);  // (int)NaN is 0
  const int iy = min(max((int)floorf(ry), 0), g.ny - 2);
  const int iz = min(max((int)floorf(rz), 0), g.nz - 2);
  f[0] = rx - (float)ix;
  f[1] = ry - (float)iy;
  f[2] = rz - (float)iz;
  return (ix * g.ny + iy) * g.nz + iz;
}

// The eight corners of the cell at p, through the read-only path; the two
// z-neighbours of a pair are adjacent words.
__device__ __forceinline__ void load_corners(const float* __restrict__ p, int sy, int sx,
                                             float (&c)[8]) {
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
__device__ __forceinline__ float lerp_corners(const float (&c)[8], const float (&f)[3]) {
  const float fx = f[0], fy = f[1], fz = f[2];
  const float c00 = c[0] * (1.f - fz) + c[1] * fz;
  const float c01 = c[2] * (1.f - fz) + c[3] * fz;
  const float c10 = c[4] * (1.f - fz) + c[5] * fz;
  const float c11 = c[6] * (1.f - fz) + c[7] * fz;
  const float c0 = c00 * (1.f - fy) + c01 * fy;
  const float c1 = c10 * (1.f - fy) + c11 * fy;
  return c0 * (1.f - fx) + c1 * fx;
}

// ------------------------------------------------------------- the extras

// The extras' tables in shared memory: grid_f [G][SCENE_GRID_F], grid_i
// [G][SCENE_GRID_I] (as int bits) and the primitives, in that order.
struct ExtrasView {
  const float* gf;
  const int* gi;
  const float* pr;
  int G, Ks, Kb, Kc;
};

__host__ __device__ __forceinline__ int extras_prim_floats(const SceneExtras& e) {
  return e.Ks * SCENE_SPHERE + e.Kb * SCENE_BOX + e.Kc * SCENE_CAPSULE;
}

// the shared-memory floats the extras take
__host__ __device__ __forceinline__ int extras_floats(const SceneExtras& e) {
  return e.G * (SCENE_GRID_F + SCENE_GRID_I) + extras_prim_floats(e);
}

// Every thread of the block calls it; a __syncthreads() must follow before
// the view is read.
__device__ __forceinline__ ExtrasView extras_to_shared(const SceneExtras& e, float* dst, int tid,
                                                       int nthreads) {
  const int nf = e.G * SCENE_GRID_F, ni = e.G * SCENE_GRID_I, np = extras_prim_floats(e);
  int* di = reinterpret_cast<int*>(dst + nf);
  for (int i = tid; i < nf; i += nthreads) dst[i] = e.grid_f[i];
  for (int i = tid; i < ni; i += nthreads) di[i] = e.grid_i[i];
  for (int i = tid; i < np; i += nthreads) dst[nf + ni + i] = e.prims[i];
  return ExtrasView{dst, di, dst + nf + ni, e.G, e.Ks, e.Kb, e.Kc};
}

// extra grid e as a K1Grid (its world offset in bx, by, bz)
__device__ __forceinline__ K1Grid extra_grid(const ExtrasView& v, int e) {
  const float* f = v.gf + SCENE_GRID_F * e;
  const int* n = v.gi + SCENE_GRID_I * e;
  return K1Grid{f[0], f[1], f[2], f[3], f[4], f[5], f[6], n[0], n[1], n[2]};
}

// extra grid e's first cell in the concatenated cells
__device__ __forceinline__ int extra_start(const ExtrasView& v, int e) {
  return v.gi[SCENE_GRID_I * e + 3];
}

// Whether a source's value dk replaces the running minimum d: where it is
// smaller, and where it is NaN (a NaN minimum then stays), as torch.minimum
// propagates a NaN.
__device__ __forceinline__ bool takes(float dk, float d) { return dk < d || dk != dk; }

// Fold a source's value dk and (GRAD) gradient gk into the running minimum
// (d, g) as torch.minimum and jnp.minimum differentiate it: the gradient of
// the smaller value, and at a tie half of each (bf16 values of two packed
// grids tie often). Folding source by source in the plain version's order
// gives its weights at a tie of three as well.
template <bool GRAD>
__device__ __forceinline__ void fold_min(float dk, const float (&gk)[3], float& d, float (&g)[3]) {
  if (takes(dk, d)) {
    d = dk;
    if (GRAD) {
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = gk[i];
    }
  } else if (GRAD && dk == d) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = 0.5f * (g[i] + gk[i]);
  }
}

// The primitives folded into the running minimum d at the world point
// (x, y, z) (fold_min), with (GRAD) its gradient g.
// bad is set where JAX's gradient of its composition is NaN, whatever source
// wins: jnp.linalg.norm's gradient at the zero vector is NaN, so a point at a
// sphere's centre, on a capsule's segment or inside or on a box (every
// |local| - h <= 0) has a NaN spatial gradient there.
template <bool GRAD>
__device__ __forceinline__ void compose_primitives(const ExtrasView& v, float x, float y, float z,
                                                   float& d, float (&g)[3], bool& bad) {
  const float* p = v.pr;
  for (int k = 0; k < v.Ks; ++k, p += SCENE_SPHERE) {
    const float vx = x - p[0], vy = y - p[1], vz = z - p[2];
    const float n = sqrtf(vx * vx + vy * vy + vz * vz);
    const float dk = n - p[3];
    if (GRAD) bad |= n == 0.f;
    if (takes(dk, d) || (GRAD && dk == d)) fold_min<GRAD>(dk, {vx / n, vy / n, vz / n}, d, g);
  }
  for (int k = 0; k < v.Kb; ++k, p += SCENE_BOX) {
    // p: centre (3), world->box rotation (9, row-major), half extents (3)
    const float wx = x - p[0], wy = y - p[1], wz = z - p[2];
    float l[3], m[3], q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      l[i] = p[3 + 3 * i] * wx + p[4 + 3 * i] * wy + p[5 + 3 * i] * wz;
      q[i] = fabsf(l[i]) - p[12 + i];
      m[i] = fmaxf(q[i], 0.f);
    }
    const float outside = sqrtf(m[0] * m[0] + m[1] * m[1] + m[2] * m[2]);
    const float inside = fminf(fmaxf(q[0], fmaxf(q[1], q[2])), 0.f);
    const float dk = outside + inside;
    if (GRAD) bad |= outside == 0.f;
    if (takes(dk, d) || (GRAD && dk == d)) {
      // R^T (sign(l) * m / outside); inside, the NaN comes from bad
      float gl[3], gk[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) gl[i] = copysignf(m[i] / outside, l[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) gk[j] = p[3 + j] * gl[0] + p[6 + j] * gl[1] + p[9 + j] * gl[2];
      fold_min<GRAD>(dk, gk, d, g);
    }
  }
  for (int k = 0; k < v.Kc; ++k, p += SCENE_CAPSULE) {
    // p: segment start a (3), end b (3), radius
    const float abx = p[3] - p[0], aby = p[4] - p[1], abz = p[5] - p[2];
    const float apx = x - p[0], apy = y - p[1], apz = z - p[2];
    const float t = clamp_keep_nan((apx * abx + apy * aby + apz * abz) /
                                       (abx * abx + aby * aby + abz * abz), 1.f);
    const float vx = x - (p[0] + t * abx), vy = y - (p[1] + t * aby), vz = z - (p[2] + t * abz);
    const float n = sqrtf(vx * vx + vy * vy + vz * vz);
    const float dk = n - p[6];
    if (GRAD) bad |= n == 0.f;
    // the closest point's own motion is along the segment, normal to v
    if (takes(dk, d) || (GRAD && dk == d)) fold_min<GRAD>(dk, {vx / n, vy / n, vz / n}, d, g);
  }
}

}  // namespace
