// K2: batched small Cholesky and triangular solves, in float64 (the island of
// a float32 session, and float64 sessions) and in float32 (a session whose
// solve_dtype is float32, with jitter escalation). The kernel templates;
// k2_linalg.cu instantiates them in double, k2_linalg_f32.cu in float.
//
// Replaces vgpmp_tpu/ops/linalg.py:cholesky_unrolled, solve_lower_unrolled
// and solve_upper_T_unrolled (XLA-fused on the TPU), as used by
// gp/conditioned.py:cholesky_kuu, gp/pathwise.py:draw_paths/eval_paths,
// gp/kl.py:prior_kl and gp/posterior.py:predict_f. The plain PyTorch versions
// are vgpmp_torch/ops/linalg.py:cholesky_unrolled/solve_lower_unrolled/
// solve_upper_T_unrolled.
//
// What bounds it on an H100: neither bytes nor flops. The matrices are tiny
// (n = 12 on the main path, [B*L] = 252 of them), so a call moves well under
// a megabyte and does ~1e5-1e7 float64 operations; the work is a chain of n
// dependent steps per matrix, so latency per step and launch count bind.
// Written as plain eager PyTorch each factorisation or solve is dozens of
// launches; here each is one launch.
//
// Both unroll to NC, n rounded up to a multiple of 4 (n = 12 runs 12 steps),
// and pad the matrix to NC x NC with the identity, so that no step, shuffle
// or shared-memory read sits behind a test of n: the padding factors and
// substitutes to itself and never reaches the matrix's own rows. (Guarded by
// n instead, every step of the unrolled chains became a branch, and the
// factorisation took 1.3x as long.)
// chol: a segment of the warp per matrix, lane i holding row i in
// registers: two matrices a warp (half-warp shuffles, width 16) where
// n <= 16, four where n <= 8, one above, and one warp a block until the warps
// outnumber the SMs, so that T = 251 covers them. A warp's matrices arrive in
// one coalesced pass through shared memory (cp.async, every copy in flight at
// once) and leave the same way. Each column step makes one reciprocal square
// root of the pivot and scales the column by multiplying (the diagonal is
// d * r); the next pivot is updated from its owner's own entry and shuffled
// at once, so the chain of a step is rsqrt, a multiply, an FMA and a
// shuffle, and the other lanes' updates run beside it. A slot past the last
// matrix factors the identity and stores nothing.
// trsm: a block takes one matrix and a tile of up to 128 columns of B, or, up
// to 16 columns, several matrices (a thread per matrix and column, 128
// threads a block to share the copy of the factors). Every thread asks for
// its column of B before the factors' copy to shared memory and the
// reciprocals of their diagonals (computed once, in parallel) are on their
// way, so the two round trips overlap; the substitution then multiplies and
// never divides. Threads without a column pass the block's one barrier
// before they leave.
// All keep the plain version's NaN-in, NaN-out behaviour: a negative pivot
// gives NaN through rsqrt (and sqrt in the fused pair) and is never clamped.
//
// The fused pair does the main path's work in fewer launches, since the count
// of launches, each with its wrapper and glue ops, is what this work costs a
// step. factor_solve_kernel: one block per matrix factors K in warp 0 while
// every thread's column of B is already on its way from memory, keeps L and
// the reciprocals of its diagonal in shared memory and substitutes by
// multiplying, so L never goes through device memory between the two and no
// step divides. factor_solve_bwd_kernel: one block per matrix runs the whole
// backward pass of both (dB, then dK through Phi(L^T dL)), which as separate
// functions takes three launches and a dozen tensor ops. chol and trsm serve
// the callers of a lone factorisation or solve: the extraction's solves
// (gp/posterior.py) and the jitter-escalation path.
//
// Above n = 32 (K2_WARP_MAX_N) no warp holds a row a lane, and a second design
// takes over, up to n = 128 (K2_MAX_N): one block of 256 threads a matrix,
// its lower triangle packed in dynamic shared memory (n (n+1) / 2 values,
// 66 KB in float64 at n = 128; kernels above 48 KB opt in to more), beside a
// tile of right-hand-side columns. The factorisation is right-looking: a
// step scales the pivot's column by the reciprocal of its square root and
// updates the trailing triangle, the block's threads over its entries, two
// barriers a step. A solve gives each warp a column of the tile: lane l
// holds rows l, l + 32, l + 64 and l + 96 in registers, the pivot's owner
// shuffles each solved entry to the warp, and no barrier is needed (n steps
// of a shuffle and four multiply-adds). The backward of the fused pair keeps
// one n x n work matrix beside the factor (217 KB in float64 at n = 128,
// which is what bounds K2_MAX_N): the tril(dB X^T) sums over 8-column tiles,
// L^T G a warp a column, then two column solves with a transpose between.
// A block is a matrix, so a NaN from a non-positive pivot stays in its own
// matrix, as it does in the warp design's segments and slots.
#pragma once

#include <algorithm>

#include <cuda_runtime.h>

#include "kernels.h"
#include "launch.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM: the grids are sized to cover them

__device__ __forceinline__ float k2_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double k2_sqrt(double x) { return sqrt(x); }
// 1 / sqrt(x): in float32 from the correctly rounded square root and
// division (rsqrtf's ~2 ulp, amplified by a Gram of condition ~1e6, put
// the float32 island's first ELBO 4x further from float64 than the plain
// version's sqrt and division); in float64 rsqrt, within an ulp
__device__ __forceinline__ float k2_rsqrt(float x) { return 1.f / sqrtf(x); }
__device__ __forceinline__ double k2_rsqrt(double x) { return rsqrt(x); }

// An 8-byte (double) or 4-byte (float) copy from device memory to shared
// memory that no thread waits on (cp.async): every copy of a loop is in
// flight at once, none parks in a register on its way.
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lanes a matrix takes in chol_kernel: 32 / W matrices share a warp.
template <int NC>
__host__ __device__ constexpr int chol_width() {
  return NC <= 8 ? 8 : (NC <= 16 ? 16 : 32);
}
constexpr int CHOL_MAX_WARPS = 4;

// Lower Cholesky of T matrices. A warp takes 32 / W consecutive matrices, a
// segment of W lanes each, lane i of a segment holding row i.
template <class S, int NC>
__global__ void __launch_bounds__(32 * CHOL_MAX_WARPS)
    chol_kernel(const S* __restrict__ A, S* __restrict__ L, long long T, int n) {
  constexpr int W = chol_width<NC>();
  constexpr int MPW = 32 / W;
  __shared__ S tile[CHOL_MAX_WARPS][MPW * NC * NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane % W, slot = lane / W;
  const long long m0 = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * MPW;
  if (m0 >= T) return;  // uniform across the warp, and no block barrier follows
  // a slot past the last matrix takes part in every shuffle and stores nothing
  const int cnt = (int)min((long long)MPW, T - m0);
  const int nn = n * n;
  S* s = tile[warp];
  for (int e = lane; e < cnt * nn; e += 32) copy_async(s + e, A + m0 * nn + e);  // coalesced
  copy_async_wait();
  __syncwarp();
  const bool live = slot < cnt && sl < n;
  S* rs = s + slot * nn + sl * n;
  // padded to NC x NC with the identity (an empty slot is the identity whole)
  S row[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) row[c] = (live && c < n) ? rs[c] : (c == sl ? S(1) : S(0));
  // the next pivot is its owner's own update, shuffled before the others'
  S d = __shfl_sync(FULL, row[0], 0, W);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const S r = k2_rsqrt(d);
    const S cj = sl < j ? S(0) : row[j] * r;  // on lane j, d * r = sqrt(d)
    if (j + 1 < NC) d = __shfl_sync(FULL, row[j + 1] - cj * cj, j + 1, W);
    row[j] = cj;
#pragma unroll
    for (int c = j + 1; c < NC; ++c) row[c] -= cj * __shfl_sync(FULL, cj, c, W);
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < n) rs[c] = row[c];
  }
  __syncwarp();
  for (int e = lane; e < cnt * nn; e += 32) L[m0 * nn + e] = s[e];  // coalesced
}

// Solve L X = B (UPPER_T false) or L^T X = B (UPPER_T true); B, X [T, n, k].
// A block takes mb consecutive matrices and a tile of ct columns of each;
// thread t carries column t % ct of matrix t / ct through the substitution in
// registers. Shared memory holds the mb factors, padded to NC x NC with the
// identity, and the reciprocals of their diagonals.
template <class S, int NC, bool UPPER_T>
__global__ void __launch_bounds__(128)
    trsm_kernel(const S* __restrict__ L, const S* __restrict__ B, S* __restrict__ X, long long T,
                int n, int k, int mb, int ct) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  S* Ls = reinterpret_cast<S*>(k2_smem);  // [mb][NC][NC]
  S* rinv = Ls + mb * NC * NC;            // [mb][NC]
  const int nn = n * n;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * mb;
  const int cnt = (int)min((long long)mb, T - m0);
  const int slot = tid / ct;
  const int col = blockIdx.y * ct + tid % ct;
  const bool live = slot < cnt && col < k;
  const long long off = live ? (m0 + slot) * n * k + col : 0;
  // B's column first, so that its loads are in flight while L arrives
  S x[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) x[i] = (live && i < n) ? B[off + (long long)i * k] : S(0);
  // the tile entry by entry: a copy of the factor's entry, or the identity's
  for (int e = tid; e < cnt * NC * NC; e += blockDim.x) {
    const int q = e / (NC * NC), i = (e / NC) % NC, c = e % NC;
    if (i < n && c < n)
      copy_async(Ls + e, L + (m0 + q) * nn + i * n + c);
    else
      Ls[e] = i == c ? S(1) : S(0);
  }
  for (int e = tid; e < mb * NC; e += blockDim.x) {
    const int q = e / NC, i = e % NC;
    rinv[e] = (q < cnt && i < n) ? S(1) / L[(m0 + q) * nn + i * (n + 1)] : S(1);
  }
  copy_async_wait();
  __syncthreads();
  if (!live) return;  // after the block's only barrier
  const S* l = Ls + slot * NC * NC;
  const S* ri = rinv + slot * NC;
  if (!UPPER_T) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const S xi = x[i] * ri[i];
      x[i] = xi;
#pragma unroll
      for (int r = i + 1; r < NC; ++r) x[r] -= l[r * NC + i] * xi;
    }
  } else {
#pragma unroll
    for (int i = NC - 1; i >= 0; --i) {
      const S xi = x[i] * ri[i];
      x[i] = xi;
#pragma unroll
      for (int r = 0; r < i; ++r) x[r] -= l[i * NC + r] * xi;
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < n) X[off + (long long)i * k] = x[i];
}

// Back substitution L^T y = x in place, in a thread's registers; L (row-major,
// n x n) and the reciprocals of its diagonal are in shared memory.
template <class S, int NC>
__device__ __forceinline__ void solve_upper_t_regs(const S* Ls, const S* rinv, int n, S (&x)[NC]) {
#pragma unroll
  for (int i = NC - 1; i >= 0; --i) {
    if (i < n) {
      const S xi = x[i] * rinv[i];
      x[i] = xi;
#pragma unroll
      for (int r = 0; r < i; ++r) x[r] -= Ls[i * n + r] * xi;
    }
  }
}

// The fused pair, forward: L = chol(K), X = L^-1 B, one block per matrix. Every
// thread first asks for its column of B; warp 0 then factors K (lane i holding
// row i, the columns broadcast by shuffles) while those loads are in flight,
// and leaves L and the reciprocals of its diagonal in shared memory, so that
// the substitution multiplies.
template <class S, int NC>
__global__ void factor_solve_kernel(const S* __restrict__ K, const S* __restrict__ B,
                                    S* __restrict__ L, S* __restrict__ X, int n, int k) {
  __shared__ S Ls[NC * NC];
  __shared__ S rinv[NC];
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  const S* b = B + m * n * k;
  S* xo = X + m * n * k;
  int col = tid;
  S x[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) x[i] = (i < n && col < k) ? b[(long long)i * k + col] : S(0);

  if (tid < 32) {
    const int lane = tid;
    const S* a = K + m * n * n;
    S row[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) row[c] = (lane < n && c < n) ? a[lane * n + c] : S(0);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < n) {
        const S pivot = k2_sqrt(__shfl_sync(FULL, row[j], j));
        const S r = S(1) / pivot;
        S cj = lane == j ? pivot : row[j] * r;
        if (lane < j) cj = S(0);
        if (lane < n) Ls[lane * n + j] = cj;
        if (lane == 0) rinv[j] = r;
#pragma unroll
        for (int c = j + 1; c < NC; ++c) {
          const S cc = __shfl_sync(FULL, cj, c);
          row[c] -= cj * cc;
        }
      }
    }
  }
  __syncthreads();
  S* l = L + m * n * n;
  for (int i = tid; i < n * n; i += blockDim.x) l[i] = Ls[i];

  while (col < k) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < n) {
        const S xi = x[i] * rinv[i];
        x[i] = xi;
#pragma unroll
        for (int r = i + 1; r < NC; ++r)
          if (r < n) x[r] -= Ls[r * n + i] * xi;
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < n) xo[(long long)i * k + col] = x[i];
    col += blockDim.x;
    if (col < k) {
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (i < n) x[i] = b[(long long)i * k + col];
    }
  }
}

// The fused pair, backward, one block of CH threads per matrix:
//   dB = L^-T dX                      (a column per thread, CH columns a pass)
//   G  = tril(dL) - tril(dB X^T)      (summed over the passes in shared memory)
//   Phi = sym(tril(L^T G), diagonal halved),  S = L^-T Phi L^-1
//   dK = tril(S + S^T) - diag(S)      (the symmetric gradient, folded)
template <class S, int NC, int CH>
__global__ void __launch_bounds__(CH) factor_solve_bwd_kernel(
    const S* __restrict__ L, const S* __restrict__ X, const S* __restrict__ gL,
    const S* __restrict__ gX, S* __restrict__ gK, S* __restrict__ gB, int n, int k) {
  constexpr int CHP = CH + 1;  // row stride of the column tiles, against bank conflicts
  __shared__ S Ls[NC * NC];
  __shared__ S Gs[NC * NC];
  __shared__ S Ps[NC * NC];
  __shared__ S rinv[NC];
  __shared__ S Xs[NC * CHP];
  __shared__ S Bs[NC * CHP];
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n;
  for (int p = tid; p < nn; p += CH) {
    Ls[p] = L[m * nn + p];
    Gs[p] = (p / n >= p % n) ? gL[m * nn + p] : S(0);
  }
  __syncthreads();
  if (tid < n) rinv[tid] = S(1) / Ls[tid * n + tid];
  __syncthreads();

  const S* xg = X + m * n * k;
  const S* gx = gX + m * n * k;
  S* gb = gB + m * n * k;
  for (int c0 = 0; c0 < k; c0 += CH) {
    const int col = c0 + tid;
    S y[NC];
    if (col < k) {
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = (i < n) ? gx[(long long)i * k + col] : S(0);
      solve_upper_t_regs<S, NC>(Ls, rinv, n, y);
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = S(0);
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < n) {
        Bs[i * CHP + tid] = y[i];
        Xs[i * CHP + tid] = (col < k) ? xg[(long long)i * k + col] : S(0);
        if (col < k) gb[(long long)i * k + col] = y[i];
      }
    }
    __syncthreads();
    const int width = min(CH, k - c0);
    for (int p = tid; p < nn; p += CH) {
      const int i = p / n, j = p % n;
      if (i >= j) {
        S acc = S(0);
        for (int t = 0; t < width; ++t) acc += Bs[i * CHP + t] * Xs[j * CHP + t];
        Gs[p] -= acc;
      }
    }
    __syncthreads();
  }

  // Phi = 0.5 (tril(P) + strict_tril(P)^T) with P = L^T G, G lower
  for (int p = tid; p < nn; p += CH) {
    const int i = p / n, j = p % n;
    if (i >= j) {
      S acc = S(0);
      for (int r = i; r < n; ++r) acc += Ls[r * n + i] * Gs[r * n + j];
      Ps[i * n + j] = S(0.5) * acc;
      Ps[j * n + i] = S(0.5) * acc;
    }
  }
  __syncthreads();
  // Y = L^-T Phi, a column per thread, into Gs
  if (tid < n) {
    S y[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) y[i] = (i < n) ? Ps[i * n + tid] : S(0);
    solve_upper_t_regs<S, NC>(Ls, rinv, n, y);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < n) Gs[i * n + tid] = y[i];
  }
  __syncthreads();
  // S^T = L^-T Y^T: thread c takes row c of Y and leaves row c of S in Ps
  if (tid < n) {
    S y[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) y[i] = (i < n) ? Gs[tid * n + i] : S(0);
    solve_upper_t_regs<S, NC>(Ls, rinv, n, y);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < n) Ps[tid * n + i] = y[i];
  }
  __syncthreads();
  for (int p = tid; p < nn; p += CH) {
    const int i = p / n, j = p % n;
    gK[m * nn + p] = i > j ? Ps[i * n + j] + Ps[j * n + i] : (i == j ? Ps[p] : S(0));
  }
}

// ------------------------------------------------ the block design, n > 32

constexpr int BIG_THREADS = 256, BIG_WARPS = BIG_THREADS / 32;
constexpr int BIG_RPL = K2_MAX_N / 32;  // rows a lane holds in a column solve
constexpr int BIG_CT = 64;              // columns of a solve's tile
constexpr int BIG_CT_BWD = 8;           // columns of the backward's two tiles

// entry (i, j), j <= i, of a lower triangle packed row by row
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }
__host__ __device__ __forceinline__ int tri_size(int n) { return n * (n + 1) / 2; }

// the lower triangle of the row-major n x n matrix A into the packed Lp
template <class S>
__device__ __forceinline__ void load_lower(const S* __restrict__ A, S* Lp, int n) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    if (j <= i) Lp[tri(i, j)] = A[e];
  }
}

// the packed Lp out as a row-major n x n lower-triangular matrix
template <class S>
__device__ __forceinline__ void store_lower(const S* Lp, S* __restrict__ L, int n) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    L[e] = j <= i ? Lp[tri(i, j)] : S(0);
  }
}

// columns [c0, c0 + w) of the row-major [n, k] matrix M into the tile (row
// stride ld), and back: neighbouring threads on neighbouring columns
template <class S>
__device__ __forceinline__ void tile_load(const S* __restrict__ M, int n, int k, int c0, int w,
                                          S* tile, int ld) {
  for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
    const int r = e / w, c = e % w;
    tile[r * ld + c] = M[(long long)r * k + c0 + c];
  }
}
template <class S>
__device__ __forceinline__ void tile_store(const S* tile, int ld, S* __restrict__ M, int n, int k,
                                           int c0, int w) {
  for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
    const int r = e / w, c = e % w;
    M[(long long)r * k + c0 + c] = tile[r * ld + c];
  }
}

// Lower Cholesky in place on the packed triangle Lp, by the whole block;
// rinv[j] = 1 / L[j][j]. Step j: every thread reads the pivot, the column
// below it is scaled by the reciprocal of its square root; then the trailing
// triangle takes the column's outer product, and one thread writes the
// diagonal entry (which the update does not read). A non-positive pivot
// gives NaN from there on, as the plain version's sqrt does.
template <class S>
__device__ void block_chol(S* Lp, S* rinv, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < n; ++j) {
    const S piv = k2_sqrt(Lp[tri(j, j)]);
    const S r = S(1) / piv;
    for (int i = j + 1 + tid; i < n; i += nt) Lp[tri(i, j)] *= r;
    __syncthreads();
    if (tid == 0) {
      Lp[tri(j, j)] = piv;
      rinv[j] = r;
    }
    const int m = n - j - 1;
    for (int e = tid; e < m * m; e += nt) {
      const int a = e / m, b = e % m;
      if (b <= a) {
        const int i = j + 1 + a, k = j + 1 + b;
        Lp[tri(i, k)] -= Lp[tri(i, j)] * Lp[tri(k, j)];
      }
    }
    __syncthreads();
  }
}

// Solve L y = b (UPPER_T false) or L^T y = b (UPPER_T true) in place for one
// column of shared memory (entries col[r * stride], r < n), by one warp:
// lane l holds rows l, l + 32, ...; each step the pivot row's lane
// multiplies by the reciprocal and shuffles the solved entry to the warp,
// and every lane updates its rows below (above) it. Every lane calls it.
template <class S, bool UPPER_T>
__device__ void warp_solve(const S* Lp, const S* rinv, S* col, int stride, int n, int lane) {
  S b[BIG_RPL];
#pragma unroll
  for (int q = 0; q < BIG_RPL; ++q) {
    const int r = lane + 32 * q;
    b[q] = r < n ? col[r * stride] : S(0);
  }
  for (int t = 0; t < n; ++t) {
    const int i = UPPER_T ? n - 1 - t : t;
    const int qi = i >> 5;
    S bi = b[0];
#pragma unroll
    for (int q = 1; q < BIG_RPL; ++q)
      if (q == qi) bi = b[q];
    const S xi = __shfl_sync(FULL, bi * rinv[i], i & 31);
#pragma unroll
    for (int q = 0; q < BIG_RPL; ++q) {
      const int r = lane + 32 * q;
      if (r == i)
        b[q] = xi;
      else if (r < n && (UPPER_T ? r < i : r > i))
        b[q] -= (UPPER_T ? Lp[tri(i, r)] : Lp[tri(r, i)]) * xi;
    }
  }
#pragma unroll
  for (int q = 0; q < BIG_RPL; ++q) {
    const int r = lane + 32 * q;
    if (r < n) col[r * stride] = b[q];
  }
}

template <class S>
__global__ void __launch_bounds__(BIG_THREADS)
    big_chol_kernel(const S* __restrict__ A, S* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  S* Lp = reinterpret_cast<S*>(k2_smem);  // [tri_size(n)]
  S* rinv = Lp + tri_size(n);             // [n]
  const long long off = (long long)blockIdx.x * n * n;
  load_lower(A + off, Lp, n);
  __syncthreads();
  block_chol(Lp, rinv, n);
  store_lower(Lp, L + off, n);
}

// block (m, y): matrix m, columns [y * ct, y * ct + ct) of B
template <class S, bool UPPER_T>
__global__ void __launch_bounds__(BIG_THREADS)
    big_trsm_kernel(const S* __restrict__ L, const S* __restrict__ B, S* __restrict__ X, int n,
                    int k, int ct) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  S* Lp = reinterpret_cast<S*>(k2_smem);  // [tri_size(n)]
  S* rinv = Lp + tri_size(n);             // [n]
  S* tile = rinv + n;                     // [n][ct + 1]
  const int ld = ct + 1, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = blockIdx.x;
  const int c0 = blockIdx.y * ct, w = min(ct, k - c0);
  const S* l = L + m * n * n;
  load_lower(l, Lp, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) rinv[i] = S(1) / l[i * (n + 1)];
  tile_load(B + m * n * k, n, k, c0, w, tile, ld);
  __syncthreads();
  for (int c = warp; c < w; c += BIG_WARPS) warp_solve<S, UPPER_T>(Lp, rinv, tile + c, ld, n, lane);
  __syncthreads();
  tile_store(tile, ld, X + m * n * k, n, k, c0, w);
}

// the fused pair, forward: factor, write L, then the tiles of B in turn
template <class S>
__global__ void __launch_bounds__(BIG_THREADS)
    big_factor_solve_kernel(const S* __restrict__ K, const S* __restrict__ B, S* __restrict__ L,
                            S* __restrict__ X, int n, int k) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  S* Lp = reinterpret_cast<S*>(k2_smem);  // [tri_size(n)]
  S* rinv = Lp + tri_size(n);             // [n]
  S* tile = rinv + n;                     // [n][BIG_CT + 1]
  const int ld = BIG_CT + 1, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = blockIdx.x;
  load_lower(K + m * n * n, Lp, n);
  __syncthreads();
  block_chol(Lp, rinv, n);
  store_lower(Lp, L + m * n * n, n);
  for (int c0 = 0; c0 < k; c0 += BIG_CT) {
    const int w = min(BIG_CT, k - c0);
    tile_load(B + m * n * k, n, k, c0, w, tile, ld);
    __syncthreads();
    for (int c = warp; c < w; c += BIG_WARPS) warp_solve<S, false>(Lp, rinv, tile + c, ld, n, lane);
    __syncthreads();
    tile_store(tile, ld, X + m * n * k, n, k, c0, w);
    __syncthreads();
  }
}

// The fused pair, backward, one block a matrix (the warp design's steps):
//   dB = L^-T dX, a tile of columns at a time, and G = tril(dL) - tril(dB X^T)
//   summed over the tiles into the work matrix W;
//   Phi = sym(tril(L^T G), diagonal halved), a warp a column of W;
//   Y = L^-T Phi in W, W = Y^T, W = L^-T W = S^T with S = L^-T Phi L^-1;
//   dK = tril(S + S^T) - diag(S)
template <class S>
__global__ void __launch_bounds__(BIG_THREADS) big_factor_solve_bwd_kernel(
    const S* __restrict__ L, const S* __restrict__ X, const S* __restrict__ gL,
    const S* __restrict__ gX, S* __restrict__ gK, S* __restrict__ gB, int n, int k) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int ldw = n + 1, ldt = BIG_CT_BWD + 1;
  S* Lp = reinterpret_cast<S*>(k2_smem);  // [tri_size(n)]
  S* rinv = Lp + tri_size(n);             // [n]
  S* W = rinv + n;                        // [n][n + 1]
  S* T1 = W + n * ldw;                    // [n][BIG_CT_BWD + 1]: dX, then dB
  S* T2 = T1 + n * ldt;                   // [n][BIG_CT_BWD + 1]: X
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m = blockIdx.x, nn = (long long)n * n;
  const S* l = L + m * nn;
  load_lower(l, Lp, n);
  for (int i = tid; i < n; i += blockDim.x) rinv[i] = S(1) / l[i * (n + 1)];
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    W[i * ldw + j] = j <= i ? gL[m * nn + e] : S(0);
  }
  __syncthreads();
  for (int c0 = 0; c0 < k; c0 += BIG_CT_BWD) {
    const int w = min(BIG_CT_BWD, k - c0);
    tile_load(gX + m * n * k, n, k, c0, w, T1, ldt);
    tile_load(X + m * n * k, n, k, c0, w, T2, ldt);
    __syncthreads();
    for (int c = warp; c < w; c += BIG_WARPS) warp_solve<S, true>(Lp, rinv, T1 + c, ldt, n, lane);
    __syncthreads();
    tile_store(T1, ldt, gB + m * n * k, n, k, c0, w);
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int i = e / n, j = e % n;
      if (j <= i) {
        S acc = S(0);
        for (int t = 0; t < w; ++t) acc += T1[i * ldt + t] * T2[j * ldt + t];
        W[i * ldw + j] -= acc;
      }
    }
    __syncthreads();
  }
  // Phi's lower triangle: column j of P = L^T G reads column j of G only, so
  // a warp takes a column, sums into registers, then overwrites it
  for (int j = warp; j < n; j += BIG_WARPS) {
    S p[BIG_RPL];
#pragma unroll
    for (int q = 0; q < BIG_RPL; ++q) {
      const int i = lane + 32 * q;
      S acc = S(0);
      if (i < n && i >= j)
        for (int r = i; r < n; ++r) acc += Lp[tri(r, i)] * W[r * ldw + j];
      p[q] = acc;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < BIG_RPL; ++q) {
      const int i = lane + 32 * q;
      if (i < n && i >= j) W[i * ldw + j] = S(0.5) * p[q];
    }
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += blockDim.x) {  // Phi's upper triangle
    const int i = e / n, j = e % n;
    if (i > j) W[j * ldw + i] = W[i * ldw + j];
  }
  __syncthreads();
  for (int c = warp; c < n; c += BIG_WARPS) warp_solve<S, true>(Lp, rinv, W + c, ldw, n, lane);
  __syncthreads();
  for (int e = tid; e < n * n; e += blockDim.x) {  // W = Y^T
    const int i = e / n, j = e % n;
    if (i < j) {
      const S t = W[i * ldw + j];
      W[i * ldw + j] = W[j * ldw + i];
      W[j * ldw + i] = t;
    }
  }
  __syncthreads();
  for (int c = warp; c < n; c += BIG_WARPS) warp_solve<S, true>(Lp, rinv, W + c, ldw, n, lane);
  __syncthreads();
  for (int e = tid; e < n * n; e += blockDim.x) {  // W = S^T
    const int i = e / n, j = e % n;
    gK[m * nn + e] = i > j ? W[i * ldw + j] + W[j * ldw + i] : (i == j ? W[i * ldw + i] : S(0));
  }
}

// dynamic shared memory of the block design's kernels, in values of S
__host__ __forceinline__ size_t big_solve_slots(int n) {
  return (size_t)tri_size(n) + n + (size_t)n * (BIG_CT + 1);
}
__host__ __forceinline__ size_t big_bwd_slots(int n) {
  return (size_t)tri_size(n) + n + (size_t)n * (n + 1) + 2 * (size_t)n * (BIG_CT_BWD + 1);
}

// ------------------------------------------------ launches of the warp design

template <class S, int NC>
cudaError_t chol_launch_nc(const S* A, S* L, long long T, int n, cudaStream_t st) {
  constexpr int MPW = 32 / chol_width<NC>();
  const long long warps = (T + MPW - 1) / MPW;
  // one warp a block until the warps outnumber the SMs
  const int wpb = (int)std::max(1LL, std::min((long long)CHOL_MAX_WARPS, warps / SMS));
  chol_kernel<S, NC><<<(unsigned)((warps + wpb - 1) / wpb), 32 * wpb, 0, st>>>(A, L, T, n);
  return cudaGetLastError();
}

template <class S, int NC>
cudaError_t trsm_launch_nc(const S* L, const S* B, S* X, long long T, int n, int k, bool upper_t,
                           cudaStream_t st) {
  // 128-column tiles of one matrix; up to 16 columns, several matrices a
  // block: as many as keeps every SM busy, at least two, at most a column
  // for each of 128 threads and 48 KB of factors
  const int ct = std::min(k, 128);
  int mb = 1;
  if (k <= 16) {
    const int fit = 49152 / ((NC * NC + NC) * (int)sizeof(S));
    mb = (int)std::max(2LL, std::min(T / SMS, (long long)std::min(128 / k, fit)));
  }
  // a packed block has 128 threads whatever its columns, to share the copy
  // of its factors
  const int threads = k <= 16 ? 128 : (ct + 31) / 32 * 32;
  const dim3 grid((unsigned)((T + mb - 1) / mb), (unsigned)((k + ct - 1) / ct));
  const size_t smem = (size_t)mb * (NC * NC + NC) * sizeof(S);
  if (upper_t)
    trsm_kernel<S, NC, true><<<grid, threads, smem, st>>>(L, B, X, T, n, k, mb, ct);
  else
    trsm_kernel<S, NC, false><<<grid, threads, smem, st>>>(L, B, X, T, n, k, mb, ct);
  return cudaGetLastError();
}

template <class S, int NC>
cudaError_t factor_solve_launch_nc(const S* K, const S* B, S* L, S* X, long long T, int n, int k,
                                   cudaStream_t st) {
  const int threads = k >= 256 ? 256 : ((k + 31) / 32) * 32;
  factor_solve_kernel<S, NC><<<(unsigned)T, threads, 0, st>>>(K, B, L, X, n, k);
  return cudaGetLastError();
}

template <class S, int NC, int CH>
cudaError_t factor_solve_bwd_launch_nc(const S* L, const S* X, const S* gL, const S* gX, S* gK,
                                       S* gB, long long T, int n, int k, cudaStream_t st) {
  factor_solve_bwd_kernel<S, NC, CH><<<(unsigned)T, CH, 0, st>>>(L, X, gL, gX, gK, gB, n, k);
  return cudaGetLastError();
}

}  // namespace

// The warp design's unroll depth NC is n rounded up to a multiple of 4.
#define K2_BY_NC(launch, S, ...)                                                   \
  switch ((n + 3) / 4) {                                                           \
    case 1: return launch<S, 4>(__VA_ARGS__);                                       \
    case 2: return launch<S, 8>(__VA_ARGS__);                                       \
    case 3: return launch<S, 12>(__VA_ARGS__);                                      \
    case 4: return launch<S, 16>(__VA_ARGS__);                                      \
    case 5: return launch<S, 20>(__VA_ARGS__);                                      \
    case 6: return launch<S, 24>(__VA_ARGS__);                                      \
    case 7: return launch<S, 28>(__VA_ARGS__);                                      \
    case 8: return launch<S, 32>(__VA_ARGS__);                                      \
    default: return cudaErrorInvalidValue;                                         \
  }

template <class S>
cudaError_t k2_chol_launch(const S* A, S* L, int64_t T, int n, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1 || n > K2_MAX_N) return cudaErrorInvalidValue;
  if (n > K2_WARP_MAX_N)
    return launch_smem(big_chol_kernel<S>, dim3((unsigned)T), dim3(BIG_THREADS),
                          ((size_t)tri_size(n) + n) * sizeof(S), st, A, L, n);
  K2_BY_NC(chol_launch_nc, S, A, L, T, n, st)
}

template <class S>
cudaError_t k2_trsm_launch(const S* L, const S* B, S* X, int64_t T, int n, int k, bool upper_t,
                           cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1 || k < 1 || n > K2_MAX_N) return cudaErrorInvalidValue;
  if (n > K2_WARP_MAX_N) {
    const int ct = std::min(k, BIG_CT);
    const dim3 grid((unsigned)T, (unsigned)((k + ct - 1) / ct));
    const size_t smem = ((size_t)tri_size(n) + n + (size_t)n * (ct + 1)) * sizeof(S);
    if (upper_t)
      return launch_smem(big_trsm_kernel<S, true>, grid, dim3(BIG_THREADS), smem, st, L, B, X,
                            n, k, ct);
    return launch_smem(big_trsm_kernel<S, false>, grid, dim3(BIG_THREADS), smem, st, L, B, X, n,
                          k, ct);
  }
  K2_BY_NC(trsm_launch_nc, S, L, B, X, T, n, k, upper_t, st)
}

template <class S>
cudaError_t k2_factor_solve_launch(const S* K, const S* B, S* L, S* X, int64_t T, int n, int k,
                                   cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  if (n <= 8) return factor_solve_launch_nc<S, 8>(K, B, L, X, T, n, k, st);
  if (n <= 16) return factor_solve_launch_nc<S, 16>(K, B, L, X, T, n, k, st);
  if (n <= 32) return factor_solve_launch_nc<S, 32>(K, B, L, X, T, n, k, st);
  if (n <= K2_MAX_N)
    return launch_smem(big_factor_solve_kernel<S>, dim3((unsigned)T), dim3(BIG_THREADS),
                          big_solve_slots(n) * sizeof(S), st, K, B, L, X, n, k);
  return cudaErrorInvalidValue;
}

// The column tiles hold CH columns of X and dB; CH shrinks with n so that the
// block's shared memory stays under 48 KB.
template <class S>
cudaError_t k2_factor_solve_bwd_launch(const S* L, const S* X, const S* gL, const S* gX, S* gK,
                                       S* gB, int64_t T, int n, int k, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  if (n <= 8) return factor_solve_bwd_launch_nc<S, 8, 128>(L, X, gL, gX, gK, gB, T, n, k, st);
  if (n <= 16) return factor_solve_bwd_launch_nc<S, 16, 128>(L, X, gL, gX, gK, gB, T, n, k, st);
  if (n <= 32) return factor_solve_bwd_launch_nc<S, 32, 32>(L, X, gL, gX, gK, gB, T, n, k, st);
  if (n <= K2_MAX_N)
    return launch_smem(big_factor_solve_bwd_kernel<S>, dim3((unsigned)T), dim3(BIG_THREADS),
                          big_bwd_slots(n) * sizeof(S), st, L, X, gL, gX, gK, gB, n, k);
  return cudaErrorInvalidValue;
}

// Every entry in S, for the instantiating source to name.
#define K2_INSTANTIATE(S)                                                                     \
  template cudaError_t k2_chol_launch<S>(const S*, S*, int64_t, int, cudaStream_t);           \
  template cudaError_t k2_trsm_launch<S>(const S*, const S*, S*, int64_t, int, int, bool,     \
                                         cudaStream_t);                                       \
  template cudaError_t k2_factor_solve_launch<S>(const S*, const S*, S*, S*, int64_t, int, int, \
                                                 cudaStream_t);                               \
  template cudaError_t k2_factor_solve_bwd_launch<S>(const S*, const S*, const S*, const S*,  \
                                                     S*, S*, int64_t, int, int, cudaStream_t);
