// K5: a triangle soup voxelized into a signed-distance grid, in float64
// inside and float32 out.
//
// Replaces the host voxelizer of the JAX package's asset pipeline,
// vgpmp_tpu/native/sdfgen.cpp:vgpmp_gen_sdf (C++ threads over x-slabs; its
// numpy twin is vgpmp_tpu/sdf/_numpy_sdf.py:sdf_grid_numpy). It replaces no
// Pallas kernel: the JAX package never ran this on the TPU. The plain PyTorch
// version is vgpmp_torch/sdf/gen.py:sdf_grid_plain.
//
// What it computes, cell by cell, exactly as vgpmp_gen_sdf does:
//   - the magnitude: the exact distance from the cell's point to the nearest
//     triangle, by Ericson's closest-point regions (Real-Time Collision
//     Detection, 5.1.5), every triangle evaluated (the host's bounding-sphere
//     prune is left out: its test is a rounded lower bound, and without it
//     the minimum is the same function of the data on every schedule);
//   - the sign: per piece, the parity of the hits of the +x ray through the
//     cell's column, jittered to (y + eps, z + 0.7 eps) with eps = delta *
//     1e-4, that lie strictly beyond the cell (hx > px, the host's
//     upper_bound); a cell is inside the union if it is inside any piece. A
//     triangle whose yz determinant is below 1e-14 in magnitude is a miss.
//
// What bounds it on an H100: the float64 operations, about 60 a
// (cell, triangle) pair, every pair evaluated (27.7 M cells x 422
// triangles: 1.17e10 pairs for the industrial scene); the output (4 bytes a
// cell) is a rounding error beside them. The design keeps the triangles next
// to the arithmetic and every lane busy:
//   - a block covers one (iy, iz) column and up to SPAN = 512 of its cells
//     along x, CELLS = 4 a thread, strided by the block's width so that the
//     lanes of a warp take neighbouring cells (and the same branch of the
//     region test, mostly);
//   - the triangles come through shared memory in tiles of TILE, any count
//     of them: each tile is staged (its vertices and piece ids), and the
//     column's ray is tested against its triangles (one hit x a triangle,
//     -inf for a miss) by the block, then every thread runs its cells over
//     the tile, reading each triangle once for its four cells (a broadcast
//     read: every lane reads the same address);
//   - the wrapper sorts the triangles by piece, so that a piece's hits come
//     as one run: a thread keeps one parity bit and one inside bit a cell,
//     whatever the count of pieces (no mask of pieces);
//   - the cell's coordinates are rounded as the host rounds them (product,
//     then sum, no contraction), so that a hit and a cell compare as on the
//     host; nvcc contracts the rest of the arithmetic into FMAs where the host
//     does not, so the distances agree to a tolerance, not bit for bit.
// Output index (ix * ny + iy) * nz + iz in 64 bits (C order, x slowest).

#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "kernels.h"
#include "launch.cuh"

namespace {

namespace k5 {

constexpr int THREADS = 128;
constexpr int CELLS = 4;
constexpr int SPAN = THREADS * CELLS;
constexpr int TILE = 480;  // 480 x 84 B = 40 320 B of shared memory, under the default 48 KB
constexpr int TRI = 9;     // a, b, c
constexpr size_t TRI_BYTES = TRI * sizeof(double) + sizeof(double) + sizeof(int);

struct V3 {
  double x, y, z;
};

__device__ __forceinline__ V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Squared distance from p to the triangle (a, b, c): sdfgen.cpp's
// point_tri_dist2, region for region.
__device__ __forceinline__ double point_tri_dist2(const V3& p, const V3& a, const V3& b, const V3& c) {
  const V3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  const double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return dot(ap, ap);
  const V3 bp = sub(p, b);
  const double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return dot(bp, bp);
  const double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    const double v = d1 / (d1 - d3);
    const V3 d = sub(p, V3{a.x + v * ab.x, a.y + v * ab.y, a.z + v * ab.z});
    return dot(d, d);
  }
  const V3 cp = sub(p, c);
  const double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return dot(cp, cp);
  const double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    const double w = d2 / (d2 - d6);
    const V3 d = sub(p, V3{a.x + w * ac.x, a.y + w * ac.y, a.z + w * ac.z});
    return dot(d, d);
  }
  const double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    const double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    const V3 d = sub(p, V3{b.x + w * (c.x - b.x), b.y + w * (c.y - b.y), b.z + w * (c.z - b.z)});
    return dot(d, d);
  }
  const double denom = 1.0 / (va + vb + vc);
  const double v = vb * denom, w = vc * denom;
  const V3 d = sub(p, V3{a.x + ab.x * v + ac.x * w, a.y + ab.y * v + ac.y * w, a.z + ab.z * v + ac.z * w});
  return dot(d, d);
}

// x of the +x ray through (y, z) on the triangle, -inf for a miss
// (sdfgen.cpp's ray_x_hit, which returns NaN; either compares false)
__device__ __forceinline__ double ray_x_hit(double y, double z, const V3& a, const V3& b, const V3& c) {
  const double d1y = b.y - a.y, d1z = b.z - a.z;
  const double d2y = c.y - a.y, d2z = c.z - a.z;
  const double det = d1y * d2z - d1z * d2y;
  if (fabs(det) < 1e-14) return -INFINITY;
  const double py = y - a.y, pz = z - a.z;
  const double u = (py * d2z - pz * d2y) / det;
  const double v = (d1y * pz - d1z * py) / det;
  if (u < 0 || v < 0 || u + v > 1) return -INFINITY;
  return a.x + u * (b.x - a.x) + v * (c.x - a.x);
}

// origin + delta * i, rounded as the host rounds it
__device__ __forceinline__ double coord(double origin, double delta, long long i) {
  return __dadd_rn(origin, __dmul_rn(delta, (double)i));
}

// tri [T, 9] (a, b, c of each triangle, sorted by piece), piece [T]; one
// block a (column, segment of SPAN cells), block index = column * nseg + seg
__global__ void __launch_bounds__(THREADS) mesh_sdf_kernel(const double* __restrict__ tri,
                                                           const int32_t* __restrict__ piece,
                                                           long long T, K5Grid g,
                                                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k5_smem[];
  const int tile = (int)(T < TILE ? T : TILE);           // the launch's shared memory holds tile triangles
  double* s_tri = reinterpret_cast<double*>(k5_smem);    // [tile][9]
  double* s_hit = s_tri + tile * TRI;                    // [tile]
  int* s_piece = reinterpret_cast<int*>(s_hit + tile);   // [tile]

  const long long nseg = (g.nx + SPAN - 1) / SPAN;
  const long long col = blockIdx.x / nseg;
  const int seg = (int)(blockIdx.x % nseg);
  const int iy = (int)(col / g.nz), iz = (int)(col % g.nz);
  const double py = coord(g.oy, g.delta, iy), pz = coord(g.oz, g.delta, iz);
  const double eps = g.delta * 1e-4;
  const double ry = __dadd_rn(py, eps), rz = __dadd_rn(pz, __dmul_rn(0.7, eps));

  const int ix0 = seg * SPAN + threadIdx.x;
  int nk = 0;  // this thread's cells: ix0 + k * THREADS for k < nk
  double px[CELLS], best[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (ix0 + k * THREADS < g.nx) nk = k + 1;
    px[k] = coord(g.ox, g.delta, ix0 + k * THREADS);
    best[k] = 1e30;
  }
  unsigned par = 0, inside = 0;  // bit k: cell k's parity in the current piece, and inside any piece
  int cur = -1;                  // the piece of the current run of triangles

  for (long long t0 = 0; t0 < T; t0 += tile) {
    const int n = (int)(T - t0 < tile ? T - t0 : tile);
    __syncthreads();  // the previous tile is read
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const double* src = tri + (t0 + t) * TRI;
      double v[TRI];
#pragma unroll
      for (int i = 0; i < TRI; ++i) s_tri[t * TRI + i] = v[i] = __ldg(src + i);
      s_piece[t] = __ldg(piece + t0 + t);
      s_hit[t] = ray_x_hit(ry, rz, V3{v[0], v[1], v[2]}, V3{v[3], v[4], v[5]}, V3{v[6], v[7], v[8]});
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const double* s = s_tri + t * TRI;
      const V3 a{s[0], s[1], s[2]}, b{s[3], s[4], s[5]}, c{s[6], s[7], s[8]};
      const double hx = s_hit[t];
      const int pc = s_piece[t];
      if (pc != cur) {
        inside |= par;
        par = 0;
        cur = pc;
      }
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        if (k < nk) {
          const double d2 = point_tri_dist2(V3{px[k], py, pz}, a, b, c);
          best[k] = d2 < best[k] ? d2 : best[k];
          par ^= (unsigned)(hx > px[k]) << k;
        }
      }
    }
  }
  inside |= par;
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (k < nk) {
      const double d = sqrt(best[k]);
      const long long ix = ix0 + k * THREADS;
      out[(ix * g.ny + iy) * g.nz + iz] = (float)((inside >> k & 1u) ? -d : d);
    }
  }
}

}  // namespace k5

}  // namespace

cudaError_t k5_mesh_sdf_launch(const double* tri, const int32_t* piece, int64_t T, K5Grid g,
                               float* out, cudaStream_t stream) {
  if (T < 1 || g.nx < 1 || g.ny < 1 || g.nz < 1) return cudaErrorInvalidValue;
  const long long nseg = (g.nx + k5::SPAN - 1) / k5::SPAN;
  const long long blocks = nseg * g.ny * g.nz;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(T < k5::TILE ? T : k5::TILE) * k5::TRI_BYTES;
  return launch_smem(k5::mesh_sdf_kernel, dim3((unsigned)blocks), dim3(k5::THREADS), smem, stream, tri,
                     piece, (long long)T, g, out);
}
