// K6: the random-Fourier-feature prior at a set of points, forward and
// backward, without storing the features.
//
// Replaces the plain chain of vgpmp_torch/gp/pathwise.py (_rff_features, the
// scale and the einsum that contracts them with the basis weights). It
// replaces no Pallas kernel: XLA fused the chain on the TPU
// (vgpmp_tpu/gp/pathwise.py:_rff_features and its einsums), where PyTorch
// writes [B, L, A, nb] tensors of the argument, the cosine, the scaled
// features and, backward, their gradients.
//
// What it computes, for each problem p = (row r, latent l), its points x[p, a]
// (a < A), bases b < nb and samples s < ns:
//   out[r, s, l, a] = scale[p] * sum_b feat(x, omega[p, b], phase[p, b]) * w[r, s, l, b]
//   feat = cos(omega x + phase)            (an ordinary point)
//   feat = -omega sin(omega x + phase)     (a derivative row, flags[a] != 0;
//                                           gp/velocity.py)
// and backward, from g = dL/dout and H[a, b] = sum_s g[r, s, l, a] w[r, s, l, b]:
//   d_omega[p, b] = scale * sum_a H dfeat/domega,  d_scale[p] = sum_a,b H feat,
//   d_x[p, a] = scale * sum_b H dfeat/dx  for the first n_dx points only
// (the points that carry a gradient come first). The phase and w are noise
// and get none.
//
// What bounds it on an H100: the cosines, one a (point, basis) pair and a
// sample chunk, and the 2 ns float32 operations of the contraction; ns (7 to
// 20 in training) is too narrow for the tensor cores, and TF32 is off. The
// bytes are the inputs once (the weights dominate) and the outputs. Design:
//   - the argument is reduced to [-pi, pi] by two-part Cody-Waite (|omega
//     x| reaches a few hundred) before the special-function unit's sine and
//     cosine (__sincosf), so a pair costs one SFU operation (two backward)
//     and about six float32 ones besides the contraction; float64 takes
//     sincos;
//   - samples go in chunks of SC = 8: a chunk's sums live in registers, and
//     a chunk beyond the first computes its cosines again (ns <= 8 on the
//     cells' training paths: one chunk; 20: three);
//   - forward: a block a (problem, tile of 32 PT points), a lane PT points
//     (PT = 1 to 4 from A), the four warps a quarter of each staged tile of
//     TB bases each; a tile's (omega, phase, w chunk) are records in shared
//     memory that a warp reads as one broadcast; the warps' sums are added
//     in warp order at the end of the chunk;
//   - backward: a block a problem, a thread BT bases (a block 512 bases,
//     looped over more), each staged tile of TPA points read as broadcast
//     records (x, flag, the chunk of g); d_omega and d_scale sum in the
//     thread, d_x over the warp by shuffles, then in warp order;
//   - tools/k6_designs.py timed these constants against others on the card
//     (PERF.md): a third Cody-Waite part cost 2-4 %, 256 threads a
//     backward block 2-3 % (43 % in float64), two bases a thread 6-9 %, two
//     points a lane 32 % at wam's shape; 256 threads a forward block gained
//     3-6 % in float32 (lost 1 % at franka's shape once) and lost 37 % in
//     float64;
//   - every sum is in a fixed order: no atomics, the same bits every run.
// Offsets within the tensors are 64-bit.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "kernels.h"
#include "launch.cuh"

namespace {

namespace k6 {

constexpr int SC = 8;                         // samples a chunk
constexpr int FWD_THREADS = 128;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int TB = FWD_THREADS;               // bases a staged tile (one record a thread)
constexpr int MAX_PT = 4;                     // points a lane
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BT = 4;                         // bases a thread, backward
constexpr int TPA = BWD_THREADS;              // points a staged tile, backward
constexpr int REC = 2 + SC;                   // a record: two scalars, then a sample chunk

extern __shared__ __align__(16) unsigned char k6_smem[];

// 16-byte vectors of S: a record is RW of them
template <class S>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int W = 4;
  __device__ static V pack(const float* a) { return V{a[0], a[1], a[2], a[3]}; }
  __device__ static void unpack(const V& v, float* a) {
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
};
template <>
struct Vec<double> {
  using V = double2;
  static constexpr int W = 2;
  __device__ static V pack(const double* a) { return V{a[0], a[1]}; }
  __device__ static void unpack(const V& v, double* a) {
    a[0] = v.x;
    a[1] = v.y;
  }
};
template <class S>
__host__ __device__ constexpr int rec_vectors() { return (REC + Vec<S>::W - 1) / Vec<S>::W; }

// the forward's shared memory: the staged records or the warps' sums, then
// the tile's derivative flag
template <class S>
__host__ __device__ constexpr size_t fwd_smem_bytes(int pt) {
  const size_t recs = (size_t)TB * rec_vectors<S>() * 16;
  const size_t red = (size_t)FWD_WARPS * pt * SC * 32 * sizeof(S);
  return (recs > red ? recs : red) + 16;
}

// the backward's: the staged point records, the warps' d_x sums, the warps'
// d_scale sums
template <class S>
size_t bwd_smem_bytes(int n_dx) {
  return (size_t)TPA * rec_vectors<S>() * 16 + ((size_t)BWD_WARPS * n_dx + BWD_WARPS) * sizeof(S);
}

template <class S>
struct Math;
template <>
struct Math<float> {
  __device__ static float fma(float a, float b, float c) { return fmaf(a, b, c); }
  // the argument less the nearest multiple k of 2 pi, so that the SFU sees
  // [-pi, pi]: 2 pi split in two as CUDA's cosf splits pi/2 (the third part,
  // 2.2e-14, stays below a float32 rounding of the result for |k| < 2^20)
  __device__ static float reduce(float t) {
    const float k = rintf(t * 0.159154943f);
    const float r = fmaf(-k, 6.28318405e+00f, t);
    return fmaf(-k, 1.25566589e-06f, r);
  }
  __device__ static float cos(float t) { return __cosf(reduce(t)); }
  __device__ static void sincos(float t, float* s, float* c) { __sincosf(reduce(t), s, c); }
};
template <>
struct Math<double> {
  __device__ static double fma(double a, double b, double c) { return ::fma(a, b, c); }
  __device__ static double cos(double t) { return ::cos(t); }
  __device__ static void sincos(double t, double* s, double* c) { ::sincos(t, s, c); }
};

// load and unpack record i of recs
template <class S>
__device__ __forceinline__ void load_rec(const typename Vec<S>::V* recs, int i,
                                         S (&v)[rec_vectors<S>() * Vec<S>::W]) {
  constexpr int RW = rec_vectors<S>();
#pragma unroll
  for (int q = 0; q < RW; ++q) Vec<S>::unpack(recs[i * RW + q], v + q * Vec<S>::W);
}

template <class S>
__device__ __forceinline__ void store_rec(typename Vec<S>::V* recs, int i,
                                          const S (&v)[rec_vectors<S>() * Vec<S>::W]) {
  constexpr int RW = rec_vectors<S>();
#pragma unroll
  for (int q = 0; q < RW; ++q) recs[i * RW + q] = Vec<S>::pack(v + q * Vec<S>::W);
}

// a warp's share of one staged tile: bases warp * 32 .. + 31, PT points a lane
template <class S, int PT, bool DERIV>
__device__ __forceinline__ void fwd_tile(const typename Vec<S>::V* recs, int warp,
                                         const S (&x)[PT], const bool (&deriv)[PT],
                                         S (&acc)[PT][SC]) {
  constexpr int PER_WARP = TB / FWD_WARPS;
#pragma unroll 2
  for (int j = 0; j < PER_WARP; ++j) {
    S v[rec_vectors<S>() * Vec<S>::W];
    load_rec<S>(recs, warp * PER_WARP + j, v);
    const S om = v[0], ph = v[1];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const S t = Math<S>::fma(x[i], om, ph);
      S f;
      if (DERIV) {
        S sn, cs;
        Math<S>::sincos(t, &sn, &cs);
        f = deriv[i] ? -om * sn : cs;
      } else {
        f = Math<S>::cos(t);
      }
#pragma unroll
      for (int k = 0; k < SC; ++k) acc[i][k] = Math<S>::fma(f, v[2 + k], acc[i][k]);
    }
  }
}

// forward: block (problem, tile of 32 PT points)
template <class S, int PT>
__global__ void __launch_bounds__(FWD_THREADS) fwd_kernel(K6Args<S> a, S* __restrict__ out) {
  using V = typename Vec<S>::V;
  constexpr int RW = rec_vectors<S>();
  V* recs = reinterpret_cast<V*>(k6_smem);  // [TB][RW]
  S* red = reinterpret_cast<S*>(k6_smem);   // [FWD_WARPS][PT * SC][32], after the last tile
  int* any_deriv = reinterpret_cast<int*>(k6_smem + fwd_smem_bytes<S>(PT) - 16);

  const int64_t p = blockIdx.x;
  const int64_t r = p / a.L;
  const int l = (int)(p % a.L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a0 = blockIdx.y * 32 * PT;
  const int A = a.A, nb = a.nb, ns = a.ns;

  S x[PT];
  bool deriv[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int ai = a0 + i * 32 + lane;
    x[i] = ai < A ? __ldg(a.x + p * A + ai) : S(0);
    deriv[i] = a.flags != nullptr && ai < A && __ldg(a.flags + ai) != 0;
  }
  if (threadIdx.x == 0) {  // does the tile hold a derivative row?
    int any = 0;
    for (int ai = a0; a.flags != nullptr && ai < A && ai < a0 + 32 * PT; ++ai) any |= a.flags[ai] != 0;
    *any_deriv = any;
  }
  const S sc = __ldg(a.scale + p);

  for (int s0 = 0; s0 < ns; s0 += SC) {
    S acc[PT][SC];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int k = 0; k < SC; ++k) acc[i][k] = S(0);

    for (int b0 = 0; b0 < nb; b0 += TB) {
      __syncthreads();  // the previous tile (or chunk's sums) is read
      {
        const int b = b0 + threadIdx.x;
        S v[RW * Vec<S>::W];
#pragma unroll
        for (int q = 0; q < RW * Vec<S>::W; ++q) v[q] = S(0);
        if (b < nb) {
          v[0] = __ldg(a.omega + p * nb + b);
          v[1] = __ldg(a.phase + p * nb + b);
#pragma unroll
          for (int k = 0; k < SC; ++k)
            if (s0 + k < ns) v[2 + k] = __ldg(a.w + ((r * ns + s0 + k) * a.L + l) * nb + b);
        }
        store_rec<S>(recs, threadIdx.x, v);
      }
      __syncthreads();
      if (*any_deriv)
        fwd_tile<S, PT, true>(recs, warp, x, deriv, acc);
      else
        fwd_tile<S, PT, false>(recs, warp, x, deriv, acc);
    }

    // the warps' sums, added in warp order
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int k = 0; k < SC; ++k) red[((warp * PT + i) * SC + k) * 32 + lane] = acc[i][k];
    __syncthreads();
    for (int o = warp; o < PT * SC; o += FWD_WARPS) {
      S sum = red[o * 32 + lane];
      for (int w2 = 1; w2 < FWD_WARPS; ++w2) sum += red[(w2 * PT * SC + o) * 32 + lane];
      const int ai = a0 + (o / SC) * 32 + lane, s = s0 + o % SC;
      if (ai < A && s < ns) out[((r * ns + s) * a.L + l) * A + ai] = sc * sum;
    }
  }
}

// backward: block a problem
template <class S>
__global__ void __launch_bounds__(BWD_THREADS) bwd_kernel(K6Args<S> a, const S* __restrict__ g,
                                                          S* __restrict__ d_omega,
                                                          S* __restrict__ d_scale,
                                                          S* __restrict__ d_x, int n_dx) {
  using V = typename Vec<S>::V;
  constexpr int RW = rec_vectors<S>();
  V* prec = reinterpret_cast<V*>(k6_smem);                 // [TPA][RW]: x, flag, g chunk
  S* dxp = reinterpret_cast<S*>(prec + TPA * RW);          // [BWD_WARPS][n_dx]
  S* red = dxp + BWD_WARPS * n_dx;                         // [BWD_WARPS]

  const int64_t p = blockIdx.x;
  const int64_t r = p / a.L;
  const int l = (int)(p % a.L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int A = a.A, nb = a.nb, ns = a.ns;
  const S sc = __ldg(a.scale + p);
  for (int i = threadIdx.x; i < BWD_WARPS * n_dx; i += BWD_THREADS) dxp[i] = S(0);
  S dsc = 0;

  for (int b0 = 0; b0 < nb; b0 += BWD_THREADS * BT) {
    S om[BT], ph[BT], dom[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      const int b = b0 + threadIdx.x + j * BWD_THREADS;
      om[j] = b < nb ? __ldg(a.omega + p * nb + b) : S(0);
      ph[j] = b < nb ? __ldg(a.phase + p * nb + b) : S(0);
      dom[j] = S(0);
    }
    for (int s0 = 0; s0 < ns; s0 += SC) {
      S wv[BT][SC];
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        const int b = b0 + threadIdx.x + j * BWD_THREADS;
#pragma unroll
        for (int k = 0; k < SC; ++k)
          wv[j][k] = b < nb && s0 + k < ns ? __ldg(a.w + ((r * ns + s0 + k) * a.L + l) * nb + b) : S(0);
      }
      for (int a0 = 0; a0 < A; a0 += TPA) {
        __syncthreads();  // the previous tile is read
        {
          const int ai = a0 + threadIdx.x;
          S v[RW * Vec<S>::W];
#pragma unroll
          for (int q = 0; q < RW * Vec<S>::W; ++q) v[q] = S(0);
          if (ai < A) {
            v[0] = __ldg(a.x + p * A + ai);
            v[1] = a.flags != nullptr && __ldg(a.flags + ai) != 0 ? S(1) : S(0);
#pragma unroll
            for (int k = 0; k < SC; ++k)
              if (s0 + k < ns) v[2 + k] = __ldg(g + ((r * ns + s0 + k) * a.L + l) * A + ai);
          }
          if (threadIdx.x < TPA) store_rec<S>(prec, threadIdx.x, v);
        }
        __syncthreads();
        const int na = A - a0 < TPA ? A - a0 : TPA;
        for (int i = 0; i < na; ++i) {
          S v[RW * Vec<S>::W];
          load_rec<S>(prec, i, v);
          const S xa = v[0];
          S dxa = 0;
          if (v[1] == S(0)) {
#pragma unroll
            for (int j = 0; j < BT; ++j) {
              S H = 0;
#pragma unroll
              for (int k = 0; k < SC; ++k) H = Math<S>::fma(v[2 + k], wv[j][k], H);
              S sn, cs;
              Math<S>::sincos(Math<S>::fma(xa, om[j], ph[j]), &sn, &cs);
              const S hs = H * sn;
              dsc = Math<S>::fma(H, cs, dsc);
              dom[j] = Math<S>::fma(hs, xa, dom[j]);
              dxa = Math<S>::fma(hs, om[j], dxa);
            }
          } else {  // a derivative row: feat = -omega sin
#pragma unroll
            for (int j = 0; j < BT; ++j) {
              S H = 0;
#pragma unroll
              for (int k = 0; k < SC; ++k) H = Math<S>::fma(v[2 + k], wv[j][k], H);
              S sn, cs;
              Math<S>::sincos(Math<S>::fma(xa, om[j], ph[j]), &sn, &cs);
              const S ho = H * om[j];
              dsc = Math<S>::fma(-ho, sn, dsc);
              dom[j] = Math<S>::fma(H, Math<S>::fma(om[j] * xa, cs, sn), dom[j]);
              dxa = Math<S>::fma(ho * om[j], cs, dxa);
            }
          }
          if (a0 + i < n_dx) {  // the same for the whole block
            for (int off = 16; off > 0; off >>= 1) dxa += __shfl_xor_sync(0xffffffffu, dxa, off);
            if (lane == 0) dxp[warp * n_dx + a0 + i] += dxa;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      const int b = b0 + threadIdx.x + j * BWD_THREADS;
      if (b < nb) d_omega[p * nb + b] = -sc * dom[j];
    }
  }

  for (int off = 16; off > 0; off >>= 1) dsc += __shfl_xor_sync(0xffffffffu, dsc, off);
  if (lane == 0) red[warp] = dsc;
  __syncthreads();
  if (threadIdx.x == 0) {
    S t = red[0];
    for (int w2 = 1; w2 < BWD_WARPS; ++w2) t += red[w2];
    d_scale[p] = t;
  }
  for (int ai = threadIdx.x; ai < n_dx; ai += BWD_THREADS) {
    S t = dxp[ai];
    for (int w2 = 1; w2 < BWD_WARPS; ++w2) t += dxp[w2 * n_dx + ai];
    d_x[p * n_dx + ai] = -sc * t;
  }
}

}  // namespace k6

}  // namespace

template <class S>
cudaError_t k6_rff_launch(const K6Args<S>& a, S* out, cudaStream_t stream) {
  const int64_t P = a.R * a.L;
  if (P < 1 || P > 0x7fffffffLL || a.A < 1 || a.nb < 1 || a.ns < 1) return cudaErrorInvalidValue;
  const int pt = (a.A + 31) / 32 < k6::MAX_PT ? (a.A + 31) / 32 : k6::MAX_PT;
  const int tiles = (a.A + 32 * pt - 1) / (32 * pt);
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)P, (unsigned)tiles), block(k6::FWD_THREADS);
  const size_t smem = k6::fwd_smem_bytes<S>(pt);
  switch (pt) {
    case 1: return launch_smem(k6::fwd_kernel<S, 1>, grid, block, smem, stream, a, out);
    case 2: return launch_smem(k6::fwd_kernel<S, 2>, grid, block, smem, stream, a, out);
    case 3: return launch_smem(k6::fwd_kernel<S, 3>, grid, block, smem, stream, a, out);
    default: return launch_smem(k6::fwd_kernel<S, 4>, grid, block, smem, stream, a, out);
  }
}

template <class S>
cudaError_t k6_rff_bwd_launch(const K6Args<S>& a, const S* g, S* d_omega, S* d_scale, S* d_x,
                              int n_dx, cudaStream_t stream) {
  const int64_t P = a.R * a.L;
  if (P < 1 || P > 0x7fffffffLL || a.A < 1 || a.nb < 1 || a.ns < 1 || n_dx < 0 || n_dx > a.A ||
      (n_dx > 0 && d_x == nullptr))
    return cudaErrorInvalidValue;
  return launch_smem(k6::bwd_kernel<S>, dim3((unsigned)P), dim3(k6::BWD_THREADS),
                     k6::bwd_smem_bytes<S>(n_dx), stream, a, g, d_omega, d_scale, d_x, n_dx);
}
