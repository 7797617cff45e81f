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
// Above n = 32 (K2_WARP_MAX_N) no warp holds a row a lane, and the block
// design takes over, up to n = 128 (K2_MAX_N): panels of 32 rows, their
// products on the float64 matrix unit (the note above its section).
#pragma once

#include <algorithm>
#include <type_traits>

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
//
// Replaces vgpmp_tpu/ops/linalg.py:cholesky_unrolled, solve_lower_unrolled and
// solve_upper_T_unrolled above n = 32 (XLA-fused on the TPU, where they are
// n vector passes over the batch), for Grams of Mc = 33 to 128 (K2_MAX_N).
//
// What bounds it on an H100: at T = 252 matrices a call moves 2-180 MB (each
// input read once, each output written once: 0.0007-0.053 ms at 3.35 TB/s)
// and does n^3/3 (factor) to 2 n^2 k + 7 n^3 / 3 (backward) float64
// operations a matrix, at most 0.03 ms at the 67 TFLOP/s of the float64
// matrix unit. Bytes bind on paper; what a design has to beat is the chain
// of dependent steps a matrix takes (n pivots, each a reciprocal square root
// and a broadcast), and a block's shared memory, which decides how many
// matrices an SM holds at once.
//
// The design: the matrix is cut into panels of 32 rows (PANEL; the last one
// padded with the identity where n is not a multiple of 32), and its lower
// tiles of 32 x 32 sit in dynamic shared memory block column by block
// column, each tile's rows at a stride of 36 values (LDT: 36 = 4 mod 16, so
// that the float64 operands of the matrix unit load without bank
// conflicts, transposed or not). One block of 256 threads a matrix.
// - Cholesky, right-looking by panels: one warp factors the diagonal tile as
//   chol_kernel does (lane a row, the pivot shuffled, the reciprocal square
//   root of the pivot kept; the column broadcast through shared memory); the
//   tiles below it are solved against it by substitution, a thread a row,
//   multiplying by those reciprocals; the trailing lower tiles take the
//   panel's product on the matrix unit (DMMA, mma.sync m8n8k4 in float64), a
//   warp a 16 x 16 unit. Three barriers a panel: 12 at n = 128 in place of
//   256. The first panel starts while the other block columns are still on
//   their way (cp.async groups), and each finished block column of L goes out
//   while warp 0 factors the next diagonal tile.
// - Solves, by block rows: a block row's diagonal tile by substitution in
//   sub-blocks of 8 rows (lanes a column each, multiplying by the reciprocals
//   of the diagonal; the tile's other sub-blocks a product), a warp 16
//   columns; never by an inverted tile, which multiplies the error by the
//   tile's condition (the real Grams reach ~1e10). Then the block rows still
//   to solve take the product with the solved one on the matrix unit. A lone
//   solve gives a block one matrix and up to 128 columns (its L arrives a
//   group of tiles at a time, each waited for by the step that reads it); the
//   fused pair solves its columns in tiles of up to 128 after the factor.
// - The backward of the fused pair, one block a matrix: dB = L^-T dX a tile of
//   columns at a time, G = tril(dL) - tril(dB X^T) summed into a second set of
//   lower tiles (a product); Phi = sym(tril(L^T G), diagonal halved) by block
//   rows (a product); Y = L^-T Phi a block column at a time, of which only
//   the blocks on and above the diagonal are kept, transposed into the lower
//   tiles; then Z = L^-T Y^T restricted to the lower triangle (block column J
//   solved from block row J down, which reads only those blocks); dK = 2 Z
//   below the diagonal and Z on it (Z is S = L^-T Phi L^-1, symmetric; the
//   plain version adds S and S^T). Two sets of lower tiles and a tile of
//   columns: 221 KB in float64 at n = 128, one block an SM; below that the
//   column tile is chosen so that two blocks share an SM.
// - float32: the same blocking, with the products in register tiles on the
//   FMA units (no TF32: it keeps 10 mantissa bits, and float32 barely
//   factors the real Grams as it is).
// A block is a matrix (a lone solve: a matrix and a tile of its columns), so
// a NaN from a non-positive pivot stays in its own matrix.

constexpr int BLK_THREADS = 256, BLK_WARPS = BLK_THREADS / 32;
constexpr int PANEL = 32;             // rows of a panel; the tiles are PANEL x PANEL
constexpr int LDT = PANEL + 4;        // row stride of a tile
constexpr int TILE = PANEL * LDT;     // values of a tile
constexpr int SUB = 8;                // rows of a diagonal tile's sub-block in a solve
// most columns of a solve's tile (a lone solve's block, the fused pair's
// tile): at n = 128, k = 100 one block a matrix (0.070 ms on an H100) beat 64
// columns a block (0.095) and 32 (0.152), tools/k2_designs.py: every block of
// a matrix loads all of L
constexpr int BLK_CT = 128;
static_assert(2 * BLK_WARPS >= 4 * (K2_MAX_N / PANEL), "a block row of units: two a warp at most");
static_assert(16 * BLK_WARPS >= BLK_CT, "a solve: 16 columns a warp");

__host__ __device__ constexpr int panels(int n) { return (n + PANEL - 1) / PANEL; }
__host__ __device__ constexpr int lower_tiles(int nb) { return nb * (nb + 1) / 2; }
__host__ __device__ constexpr int round16(int k) { return (k + 15) / 16 * 16; }

// the lower tile (I, J), J <= I, of nb panels, stored block column by block
// column: a block column's tiles follow each other
__device__ __forceinline__ int tile_at(int nb, int I, int J) {
  return J * nb - J * (J - 1) / 2 + I - J;
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of the committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_async_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void copy_async_wait_pending(int n) {
  switch (n) {
    case 0: copy_async_wait_prior<0>(); break;
    case 1: copy_async_wait_prior<1>(); break;
    case 2: copy_async_wait_prior<2>(); break;
    default: copy_async_wait_prior<3>();
  }
}

// C (8 x 8) += A (8 x 4) B (4 x 8) in float64 on the matrix unit: lane l
// holds A[l / 4][l % 4], B[l % 4][l / 4] and C[l / 4][2 (l % 4) + e]
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// entry (r, c) of an operand in shared memory, row-major at stride ld, or
// its transpose (T)
template <class S, bool T>
__device__ __forceinline__ S opd(const S* p, int ld, int r, int c) {
  return T ? p[c * ld + r] : p[r * ld + c];
}

// A warp's 16 x 16 unit of a product: lane l holds entries
// (8 ti + l / 4, 8 tj + 2 (l % 4) + e) at acc[ti][tj][e].
template <class S>
using Unit = S[2][2][2];

// acc -= A B over a depth of K (a multiple of 4): A the unit's 16 rows,
// B its 16 columns. float64 on the matrix unit; float32 on the FMA units.
template <class S, bool TA, bool TB>
__device__ __forceinline__ void unit_sub(Unit<S>& acc, const S* A, int lda, const S* B, int ldb,
                                         int K, int lane) {
  const int g = lane >> 2, q = lane & 3;
  if constexpr (std::is_same<S, double>::value) {
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 4) {
      const double a[2] = {-opd<S, TA>(A, lda, g, k0 + q), -opd<S, TA>(A, lda, 8 + g, k0 + q)};
      const double b[2] = {opd<S, TB>(B, ldb, k0 + q, g), opd<S, TB>(B, ldb, k0 + q, 8 + g)};
#pragma unroll
      for (int ti = 0; ti < 2; ++ti)
#pragma unroll
        for (int tj = 0; tj < 2; ++tj) dmma(acc[ti][tj], a[ti], b[tj]);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const S a[2] = {opd<S, TA>(A, lda, g, k), opd<S, TA>(A, lda, 8 + g, k)};
#pragma unroll
      for (int tj = 0; tj < 2; ++tj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const S b = opd<S, TB>(B, ldb, k, 8 * tj + 2 * q + e);
#pragma unroll
          for (int ti = 0; ti < 2; ++ti) acc[ti][tj][e] -= a[ti] * b;
        }
    }
  }
}

template <class S>
__device__ __forceinline__ void unit_load(Unit<S>& acc, const S* C, int ld, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int tj = 0; tj < 2; ++tj)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[ti][tj][e] = C[(8 * ti + g) * ld + 8 * tj + 2 * q + e];
}

template <class S>
__device__ __forceinline__ void unit_zero(Unit<S>& acc) {
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int tj = 0; tj < 2; ++tj) acc[ti][tj][0] = acc[ti][tj][1] = S(0);
}

// scale * acc into C; on_diag: the unit lies on a diagonal tile's diagonal,
// and its entries above that diagonal are left as they are
template <class S>
__device__ __forceinline__ void unit_store(const Unit<S>& acc, S* C, int ld, int lane, bool on_diag,
                                           S scale = S(1)) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int tj = 0; tj < 2; ++tj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * ti + g, c = 8 * tj + 2 * q + e;
        if (!on_diag || c <= r) C[r * ld + c] = scale * acc[ti][tj][e];
      }
}

// The lower tiles of block column g (by_row: block row g) of the row-major
// n x n matrix A into Lt (nb panels) by cp.async, the diagonal tile whole; the
// padding is the identity's. With tril, the entries above the diagonal and
// the padding are zero. A warp a row of a tile column.
template <class S>
__device__ void load_tiles(const S* __restrict__ A, S* Lt, int n, int nb, int g, bool by_row,
                           bool tril) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = by_row ? g + 1 : nb - g;
  for (int e = warp; e < ntiles * PANEL; e += BLK_WARPS) {
    const int I = by_row ? g : g + e / PANEL, J = by_row ? e / PANEL : g;
    const int i = I * PANEL + e % PANEL, j = J * PANEL + lane;
    S* dst = Lt + tile_at(nb, I, J) * TILE + (i % PANEL) * LDT + lane;
    if (i < n && j < n && (!tril || j <= i))
      copy_async(dst, A + (long long)i * n + j);
    else
      *dst = (!tril && i == j) ? S(1) : S(0);
  }
}

// All the lower tiles, a block column at a time.
template <class S>
__device__ void load_lower_tiles(const S* __restrict__ A, S* Lt, int n, int nb, bool tril) {
  for (int g = 0; g < nb; ++g) load_tiles(A, Lt, n, nb, g, false, tril);
}

// Columns [32 p, 32 p + 32) of the tiles' lower triangle out to the
// row-major n x n matrix L, zero above the diagonal (all columns: p < 0);
// fold: twice every entry below the diagonal. Warps w0 .. BLK_WARPS - 1
// store.
template <class S>
__device__ void store_lower_tiles(const S* Lt, S* __restrict__ L, int n, int nb, bool fold,
                                  int p = -1, int w0 = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = p < 0 ? 0 : p * PANEL, j1 = p < 0 ? n : min(n, j0 + PANEL);
  for (int i = warp - w0; i < n; i += BLK_WARPS - w0)
    for (int j = j0 + lane; j < j1; j += 32) {
      S v = S(0);
      if (j <= i) {
        v = Lt[tile_at(nb, i / PANEL, j / PANEL) * TILE + (i % PANEL) * LDT + j % PANEL];
        if (fold && j < i) v += v;
      }
      L[(long long)i * n + j] = v;
    }
}

// Columns [c0, c0 + w) of the row-major [n, k] matrix M into the tile X (np
// rows at stride ld, ct columns; zero outside M) by cp.async, and back.
template <class S>
__device__ void load_cols(const S* __restrict__ M, int n, int k, int c0, int w, S* X, int ld, int np,
                          int ct) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < np; i += BLK_WARPS)
    for (int j = lane; j < ct; j += 32) {
      if (i < n && j < w)
        copy_async(X + i * ld + j, M + (long long)i * k + c0 + j);
      else
        X[i * ld + j] = S(0);
    }
}
template <class S>
__device__ void store_cols(const S* X, int ld, S* __restrict__ M, int n, int k, int c0, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += BLK_WARPS)
    for (int j = lane; j < w; j += 32) M[(long long)i * k + c0 + j] = X[i * ld + j];
}

// rinv[i] = 1 / L[i][i] of the row-major n x n L; 1 on the padding
template <class S>
__device__ void load_rinv(const S* __restrict__ L, S* rinv, int n, int np) {
  for (int i = threadIdx.x; i < np; i += BLK_THREADS)
    rinv[i] = i < n ? S(1) / L[(long long)i * (n + 1)] : S(1);
}

// The diagonal tile D factored in place by one warp as chol_kernel factors a
// matrix (lane a row, the next pivot shuffled from its owner's update); r[j]
// is the reciprocal square root of pivot j, 1 / L[j][j]. Each step's column
// reaches the lanes through shared memory (cb, two buffers in turn: one
// store and a broadcast load an entry, where a shuffle of a double is two
// instructions; it halved the tile's time in float64, and shuffles were no
// faster in float32). The steps stop after the tile's nr rows of the
// matrix: the rest is the padding's identity, which factors to itself (one
// instantiation with the test in the loop: a second, unrolled without it
// for full panels, doubled the code and made the factorisation slower).
template <class S>
__device__ void warp_chol_tile(S* D, S* r, int nr, int lane) {
  __shared__ __align__(16) S cb[2][PANEL];
  S row[PANEL];
#pragma unroll
  for (int c = 0; c < PANEL; ++c) row[c] = D[lane * LDT + c];
  r[lane] = S(1);
  S d = __shfl_sync(FULL, row[0], 0);
#pragma unroll
  for (int j = 0; j < PANEL; ++j) {
    if (j == nr) break;
    const S rj = k2_rsqrt(d);
    const S cj = lane < j ? S(0) : row[j] * rj;  // on lane j, d * r = sqrt(d)
    if (j + 1 < PANEL) d = __shfl_sync(FULL, row[j + 1] - cj * cj, j + 1);
    row[j] = cj;
    if (lane == j) r[j] = rj;
    cb[j & 1][lane] = cj;
    __syncwarp();
#pragma unroll
    for (int c = j + 1; c < PANEL; ++c) row[c] -= cj * cb[j & 1][c];
  }
#pragma unroll
  for (int c = 0; c < PANEL; ++c) D[lane * LDT + c] = row[c];
}

// The tiles below the diagonal tile of panel p, a thread a row x:
// x L_pp^T = a by forward substitution, multiplying by the reciprocals r
// (the padding's rows stay zero).
template <class S>
__device__ void panel_solve(S* Lt, const S* r, int n, int nb, int p) {
  const int t = threadIdx.x;
  if (t >= n - (p + 1) * PANEL) return;
  const S* D = Lt + tile_at(nb, p, p) * TILE;
  S* xr = Lt + tile_at(nb, p + 1 + t / PANEL, p) * TILE + (t % PANEL) * LDT;
  S x[PANEL];
#pragma unroll
  for (int c = 0; c < PANEL; ++c) x[c] = xr[c];
#pragma unroll
  for (int c = 0; c < PANEL; ++c) {
    const S xc = x[c] * r[c];
    x[c] = xc;
#pragma unroll
    for (int q = c + 1; q < PANEL; ++q) x[q] -= D[q * LDT + c] * xc;
  }
#pragma unroll
  for (int c = 0; c < PANEL; ++c) xr[c] = x[c];
}

// A[I, J] -= L[I, p] L[J, p]^T for p < J <= I, a warp a unit (a diagonal
// tile's unit above its diagonal is skipped: nothing reads it).
template <class S>
__device__ void trailing_update(S* Lt, int nb, int p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = nb - 1 - p;
  for (int u = warp; u < 4 * m * m; u += BLK_WARPS) {
    const int I = p + 1 + (u / 4) / m, J = p + 1 + (u / 4) % m, ru = (u >> 1) & 1, cu = u & 1;
    if (J > I || (J == I && cu > ru)) continue;
    Unit<S> acc;
    S* C = Lt + tile_at(nb, I, J) * TILE + 16 * ru * LDT + 16 * cu;
    unit_load(acc, C, LDT, lane);
    unit_sub<S, false, true>(acc, Lt + tile_at(nb, I, p) * TILE + 16 * ru * LDT, LDT,
                             Lt + tile_at(nb, J, p) * TILE + 16 * cu * LDT, LDT, PANEL, lane);
    unit_store(acc, C, LDT, lane, false);
  }
}

// Lower Cholesky in place on the tiles, right-looking by panels; rinv[j] =
// 1 / L[j][j]. A non-positive pivot gives NaN from there on, as the plain
// version's sqrt does, in this matrix only. The tiles arrive in two groups
// of copies, block column 0 and the rest, with `later` groups committed
// after them (0 or 1): the first panel starts on its own column. Each block
// column of L goes out to Lg (row-major n x n) while warp 0 factors the next
// diagonal tile.
template <class S>
__device__ void blocked_chol(S* Lt, S* rinv, int n, int nb, int later, S* __restrict__ Lg) {
  if (later) copy_async_wait_prior<2>(); else copy_async_wait_prior<1>();
  __syncthreads();
  for (int p = 0; p < nb; ++p) {
    S* D = Lt + tile_at(nb, p, p) * TILE;
    const int nr = n - p * PANEL;
    if (threadIdx.x < 32) {
      warp_chol_tile(D, rinv + p * PANEL, nr, threadIdx.x);
    } else if (p > 0) {
      store_lower_tiles(Lt, Lg, n, nb, false, p - 1, 1);
    }
    __syncthreads();
    if (p + 1 < nb) {
      panel_solve(Lt, rinv + p * PANEL, n, nb, p);
      if (p == 0) {
        if (later) copy_async_wait_prior<1>(); else copy_async_wait_prior<0>();
      }
      __syncthreads();
      trailing_update(Lt, nb, p);
      __syncthreads();
    }
  }
  store_lower_tiles(Lt, Lg, n, nb, false, nb - 1);
}

// acc (a warp's 8 x 16 block: lane l holds entries (l / 4, 8 tj + 2 (l % 4) + e)
// at acc[tj][e]) -= A B over a depth of SUB: A the block's 8 rows (or, TA,
// its transpose's), B its 16 columns. float64 on the matrix unit; float32 on
// the FMA units.
template <class S>
using Half = S[2][2];
template <class S, bool TA>
__device__ __forceinline__ void half_sub(Half<S>& acc, const S* A, int lda, const S* B, int ldb,
                                         int lane) {
  const int g = lane >> 2, q = lane & 3;
  if constexpr (std::is_same<S, double>::value) {
#pragma unroll
    for (int k0 = 0; k0 < SUB; k0 += 4) {
      const double a = -opd<S, TA>(A, lda, g, k0 + q);
#pragma unroll
      for (int tj = 0; tj < 2; ++tj) dmma(acc[tj], a, opd<S, false>(B, ldb, k0 + q, 8 * tj + g));
    }
  } else {
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      const S a = opd<S, TA>(A, lda, g, k);
#pragma unroll
      for (int tj = 0; tj < 2; ++tj)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[tj][e] -= a * opd<S, false>(B, ldb, k, 8 * tj + 2 * q + e);
    }
  }
}

// A diagonal tile D's solve, by one warp, for the 16 columns of X from its
// pointer on (rows at stride ld): in sub-blocks of SUB rows, each by
// substitution (lanes 0-15 a column each, multiplying by the reciprocals r),
// after which the tile's sub-blocks still to solve take its product on the
// matrix unit. A sub-block from row nr on is the padding's: it stays zero.
template <class S, bool UPPER_T>
__device__ void tile_solve(const S* D, const S* r, S* X, int ld, int nr, int lane) {
  constexpr int NS = PANEL / SUB;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r0 = (UPPER_T ? NS - 1 - s : s) * SUB;
    if (r0 >= nr) continue;
    if (lane < 16) {
      S x[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) x[i] = X[(r0 + i) * ld + lane];
      if (!UPPER_T) {
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          const S xi = x[i] * r[r0 + i];
          x[i] = xi;
#pragma unroll
          for (int t = i + 1; t < SUB; ++t) x[t] -= D[(r0 + t) * LDT + r0 + i] * xi;
        }
      } else {
#pragma unroll
        for (int i = SUB - 1; i >= 0; --i) {
          const S xi = x[i] * r[r0 + i];
          x[i] = xi;
#pragma unroll
          for (int t = 0; t < i; ++t) x[t] -= D[(r0 + i) * LDT + r0 + t] * xi;
        }
      }
#pragma unroll
      for (int i = 0; i < SUB; ++i) X[(r0 + i) * ld + lane] = x[i];
    }
    __syncwarp();
#pragma unroll
    for (int s1 = s + 1; s1 < NS; ++s1) {  // below (lower) or above (transposed)
      const int r1 = (UPPER_T ? NS - 1 - s1 : s1) * SUB;
      if (r1 >= nr) continue;
      S* C = X + (r1 + g) * ld + 2 * q;
      Half<S> acc = {{C[0], C[1]}, {C[8], C[9]}};
      if (!UPPER_T)  // X[r1] -= D[r1, r0] X[r0]
        half_sub<S, false>(acc, D + r1 * LDT + r0, LDT, X + r0 * ld, ld, lane);
      else           // X[r1] -= D[r0, r1]^T X[r0]
        half_sub<S, true>(acc, D + r0 * LDT + r1, LDT, X + r0 * ld, ld, lane);
      C[0] = acc[0][0], C[1] = acc[0][1], C[8] = acc[1][0], C[9] = acc[1][1];
    }
    __syncwarp();
  }
}

// X <- L^-1 X (UPPER_T false) or L^-T X (true) in place, for a tile of ct
// columns (a multiple of 16, at most 16 a warp): block row I of X at X + (I
// - j0) * xs, rows at stride ld, for the block rows j0 .. nb - 1 (j0 > 0
// only transposed: the trailing part of L from panel j0). A block row's
// diagonal tile by tile_solve, a warp 16 columns; then the block rows still
// to solve take its product with L on the matrix unit. streamed: L's tiles
// arrive in nb groups of copies in the order of the steps.
template <class S, bool UPPER_T>
__device__ void blocked_solve(const S* Lt, const S* rinv, S* X, int ld, int xs, int n, int nb,
                              int j0, int ct, bool streamed = false) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cu = ct / 16;
  for (int s = j0; s < nb; ++s) {
    const int I = UPPER_T ? nb - 1 - (s - j0) : s;
    S* XI = X + (I - j0) * xs;
    if (warp < ct / 16)
      tile_solve<S, UPPER_T>(Lt + tile_at(nb, I, I) * TILE, rinv + I * PANEL, XI + 16 * warp, ld,
                             n - I * PANEL, lane);
    __syncthreads();
    // the block rows still to solve: below I (lower), j0 .. I - 1 (transposed)
    const int m = UPPER_T ? I - j0 : nb - 1 - I;
    if (m == 0) continue;
    for (int u = warp; u < 2 * cu * m; u += BLK_WARPS) {
      const int J = (UPPER_T ? j0 : I + 1) + u / (2 * cu), ru = (u / cu) & 1, cc = u % cu;
      Unit<S> acc;
      S* C = X + (J - j0) * xs + 16 * ru * ld + 16 * cc;
      unit_load(acc, C, ld, lane);
      if (!UPPER_T)  // X[J] -= L[J, I] X[I]
        unit_sub<S, false, false>(acc, Lt + tile_at(nb, J, I) * TILE + 16 * ru * LDT, LDT,
                                  XI + 16 * cc, ld, PANEL, lane);
      else           // X[J] -= L[I, J]^T X[I]
        unit_sub<S, true, false>(acc, Lt + tile_at(nb, I, J) * TILE + 16 * ru, LDT, XI + 16 * cc, ld,
                                 PANEL, lane);
      unit_store(acc, C, ld, lane, false);
    }
    if (streamed) copy_async_wait_pending(nb - 2 - s);  // the next step's group of L
    __syncthreads();
  }
}

template <class S>
__global__ void __launch_bounds__(BLK_THREADS)
    blk_chol_kernel(const S* __restrict__ A, S* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int nb = panels(n);
  S* Lt = reinterpret_cast<S*>(k2_smem);  // [lower_tiles(nb)][TILE]
  S* rinv = Lt + lower_tiles(nb) * TILE;  // [nb * PANEL]
  const long long off = (long long)blockIdx.x * n * n;
  load_tiles(A + off, Lt, n, nb, 0, false, false);
  copy_async_commit();
  for (int g = 1; g < nb; ++g) load_tiles(A + off, Lt, n, nb, g, false, false);
  copy_async_commit();
  blocked_chol(Lt, rinv, n, nb, 0, L + off);
}

// block (m, y): matrix m, columns [y * ct, y * ct + ct) of B; L's tiles
// arrive a block column (a block row, transposed) at a time, each group
// waited for just before the step that reads it
template <class S, bool UPPER_T>
__global__ void __launch_bounds__(BLK_THREADS)
    blk_trsm_kernel(const S* __restrict__ L, const S* __restrict__ B, S* __restrict__ X, int n, int k,
                    int ct) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int nb = panels(n), np = nb * PANEL, ld = ct + 4;
  S* Lt = reinterpret_cast<S*>(k2_smem);  // [lower_tiles(nb)][TILE]
  S* rinv = Lt + lower_tiles(nb) * TILE;  // [np]
  S* Xt = rinv + np;                      // [np][ct + 4]
  const long long m = blockIdx.x;
  const int c0 = blockIdx.y * ct, w = min(ct, k - c0);
  const S* l = L + m * n * n;
  load_cols(B + m * n * k, n, k, c0, w, Xt, ld, np, ct);
  for (int s = 0; s < nb; ++s) {  // the tiles in the order the solve takes them
    load_tiles(l, Lt, n, nb, UPPER_T ? nb - 1 - s : s, UPPER_T, false);
    copy_async_commit();
  }
  load_rinv(l, rinv, n, np);
  copy_async_wait_pending(nb - 1);
  __syncthreads();
  blocked_solve<S, UPPER_T>(Lt, rinv, Xt, ld, PANEL * ld, n, nb, 0, ct, true);
  store_cols(Xt, ld, X + m * n * k, n, k, c0, w);
}

// The fused pair, forward: factor (L goes out a block column at a time),
// then the tiles of B in turn; the first tile's columns arrive while the
// factorisation runs.
template <class S>
__global__ void __launch_bounds__(BLK_THREADS)
    blk_factor_solve_kernel(const S* __restrict__ K, const S* __restrict__ B, S* __restrict__ L,
                            S* __restrict__ X, int n, int k, int ct) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int nb = panels(n), np = nb * PANEL, ld = ct + 4;
  S* Lt = reinterpret_cast<S*>(k2_smem);  // [lower_tiles(nb)][TILE]
  S* rinv = Lt + lower_tiles(nb) * TILE;  // [np]
  S* Xt = rinv + np;                      // [np][ct + 4]
  const long long m = blockIdx.x;
  const S* b = B + m * n * k;
  S* x = X + m * n * k;
  const S* a = K + m * n * n;
  load_tiles(a, Lt, n, nb, 0, false, false);
  copy_async_commit();
  for (int g = 1; g < nb; ++g) load_tiles(a, Lt, n, nb, g, false, false);
  copy_async_commit();
  load_cols(b, n, k, 0, min(ct, k), Xt, ld, np, ct);
  copy_async_commit();
  blocked_chol(Lt, rinv, n, nb, 1, L + m * n * n);
  for (int c0 = 0; c0 < k; c0 += ct) {
    const int w = min(ct, k - c0);
    if (c0 > 0) load_cols(b, n, k, c0, w, Xt, ld, np, ct);
    copy_async_wait();
    __syncthreads();
    blocked_solve<S, false>(Lt, rinv, Xt, ld, PANEL * ld, n, nb, 0, ct);
    store_cols(Xt, ld, x, n, k, c0, w);
    __syncthreads();
  }
}

// The fused pair, backward, one block a matrix (the plain version's steps):
//   dB = L^-T dX a tile of ct columns at a time, G = tril(dL) - tril(dB X^T)
//   summed over the tiles into the lower tiles W;
//   Phi = sym(tril(L^T G), diagonal halved): W's block row I from block rows
//   I .. nb - 1 of G, so block rows go in order;
//   Y = L^-T Phi a block column C at a time (Phi's column gathered from its
//   lower triangle), Y's blocks (J, C), J <= C, transposed into W's (C, J);
//   Z = L^-T Y^T below the diagonal, block column J from block row J down;
//   dK = 2 Z below the diagonal, Z on it.
template <class S>
__global__ void __launch_bounds__(BLK_THREADS) blk_factor_solve_bwd_kernel(
    const S* __restrict__ L, const S* __restrict__ X, const S* __restrict__ gL,
    const S* __restrict__ gX, S* __restrict__ gK, S* __restrict__ gB, int n, int k, int ct) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int nb = panels(n), np = nb * PANEL, nt = lower_tiles(nb), ld = ct + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  S* Lt = reinterpret_cast<S*>(k2_smem);  // [nt][TILE]: L
  S* W = Lt + nt * TILE;                  // [nt][TILE]: G, Phi, Y^T, Z
  S* rinv = W + nt * TILE;                // [np]
  S* T1 = rinv + np;                      // [np][ct + 4]: dX, then dB; Y's block column [np][LDT]
  S* T2 = T1 + np * ld;                   // [np][ct + 4]: X
  const long long m = blockIdx.x, nn = (long long)n * n, nk = (long long)n * k;
  load_lower_tiles(L + m * nn, Lt, n, nb, false);
  load_lower_tiles(gL + m * nn, W, n, nb, true);
  load_rinv(L + m * nn, rinv, n, np);
  for (int c0 = 0; c0 < k; c0 += ct) {
    const int w = min(ct, k - c0);
    load_cols(gX + m * nk, n, k, c0, w, T1, ld, np, ct);
    load_cols(X + m * nk, n, k, c0, w, T2, ld, np, ct);
    copy_async_wait();
    __syncthreads();
    blocked_solve<S, true>(Lt, rinv, T1, ld, PANEL * ld, n, nb, 0, ct);
    store_cols(T1, ld, gB + m * nk, n, k, c0, w);
    for (int u = warp; u < 4 * nt; u += BLK_WARPS) {  // G -= tril(dB X^T)
      int J = 0, t = u / 4;
      while (t >= nb - J) t -= nb - J++;
      const int I = J + t, ru = (u >> 1) & 1, cu = u & 1;
      if (I == J && cu > ru) continue;
      Unit<S> acc;
      S* C = W + (u / 4) * TILE + 16 * ru * LDT + 16 * cu;
      unit_load(acc, C, LDT, lane);
      unit_sub<S, false, true>(acc, T1 + (I * PANEL + 16 * ru) * ld, ld, T2 + (J * PANEL + 16 * cu) * ld,
                               ld, ct, lane);
      unit_store(acc, C, LDT, lane, I == J && ru == cu);
    }
    __syncthreads();
  }
  for (int I = 0; I < nb; ++I) {  // Phi's block row I: 0.5 sum over K >= I of L[K, I]^T G[K, J]
    Unit<S> acc[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int u = warp + s * BLK_WARPS, J = u / 4, ru = (u >> 1) & 1, cu = u & 1;
      unit_zero(acc[s]);
      if (J <= I && !(J == I && cu > ru))
        for (int Kb = I; Kb < nb; ++Kb)
          unit_sub<S, true, false>(acc[s], Lt + tile_at(nb, Kb, I) * TILE + 16 * ru, LDT,
                                   W + tile_at(nb, Kb, J) * TILE + 16 * cu, LDT, PANEL, lane);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int u = warp + s * BLK_WARPS, J = u / 4, ru = (u >> 1) & 1, cu = u & 1;
      if (J <= I && !(J == I && cu > ru))  // acc holds -P
        unit_store(acc[s], W + tile_at(nb, I, J) * TILE + 16 * ru * LDT + 16 * cu, LDT, lane,
                   J == I && ru == cu, S(-0.5));
    }
    __syncthreads();
  }
  for (int C = 0; C < nb; ++C) {  // Y = L^-T Phi, block column C
    for (int i = warp; i < np; i += BLK_WARPS) {
      const int j = C * PANEL + lane;
      T1[i * LDT + lane] = i >= j ? W[tile_at(nb, i / PANEL, C) * TILE + (i % PANEL) * LDT + lane]
                                  : W[tile_at(nb, C, i / PANEL) * TILE + lane * LDT + i % PANEL];
    }
    __syncthreads();
    blocked_solve<S, true>(Lt, rinv, T1, LDT, TILE, n, nb, 0, PANEL);
    for (int e = tid; e < (C + 1) * PANEL * PANEL; e += BLK_THREADS) {
      const int J = e / (PANEL * PANEL), a = (e / PANEL) % PANEL, b = e % PANEL;
      W[tile_at(nb, C, J) * TILE + a * LDT + b] = T1[(J * PANEL + b) * LDT + a];
    }
    __syncthreads();
  }
  for (int J = 0; J < nb; ++J)  // Z = L^-T Y^T, block column J from block row J
    blocked_solve<S, true>(Lt, rinv, W + tile_at(nb, J, J) * TILE, LDT, TILE, n, nb, J, PANEL);
  store_lower_tiles(W, gK + m * nn, n, nb, true);
}

// dynamic shared memory of the block design's kernels, in bytes: the lower
// tiles (twice in the backward), the reciprocals, and `tiles` tiles of ct
// columns
template <class S>
size_t blk_smem(int nb, int lower_sets, int tiles, int ct) {
  return ((size_t)lower_sets * lower_tiles(nb) * TILE +
          (size_t)nb * PANEL * (1 + (size_t)tiles * (ct + 4))) * sizeof(S);
}

// the backward's column tile, no wider than k rounded up to 16: the widest
// of 64, 32 and 16 columns with which two blocks share an SM's 228 KB (a
// block is one matrix's chain of steps: two hide each other's latency; at
// n = 40 this took the backward from 0.070 to 0.049 ms against 64 columns
// and one block on an H100, tools/k2_designs.py), else the widest that one
// block holds (16 in float64 at n > 96)
template <class S>
int blk_bwd_ct(int nb, int k) {
  constexpr size_t TWO_A_SM = 115712;  // (228 KB - 2 x 1 KB reserved) / 2
  for (int ct = 64; ct >= 16; ct /= 2)
    if (blk_smem<S>(nb, 2, 2, ct) <= TWO_A_SM) return std::min(ct, round16(k));
  int ct = 64;
  while (ct > 16 && blk_smem<S>(nb, 2, 2, ct) > MAX_SMEM) ct /= 2;
  return std::min(ct, round16(k));
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
    return launch_smem(blk_chol_kernel<S>, dim3((unsigned)T), dim3(BLK_THREADS),
                       blk_smem<S>(panels(n), 1, 0, 0), st, A, L, n);
  K2_BY_NC(chol_launch_nc, S, A, L, T, n, st)
}

template <class S>
cudaError_t k2_trsm_launch(const S* L, const S* B, S* X, int64_t T, int n, int k, bool upper_t,
                           cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1 || k < 1 || n > K2_MAX_N) return cudaErrorInvalidValue;
  if (n > K2_WARP_MAX_N) {
    // a block a matrix and a tile of up to BLK_CT columns
    const int ct = std::min(round16(k), BLK_CT);
    const dim3 grid((unsigned)T, (unsigned)((k + ct - 1) / ct));
    const size_t smem = blk_smem<S>(panels(n), 1, 1, ct);
    if (upper_t)
      return launch_smem(blk_trsm_kernel<S, true>, grid, dim3(BLK_THREADS), smem, st, L, B, X, n, k,
                         ct);
    return launch_smem(blk_trsm_kernel<S, false>, grid, dim3(BLK_THREADS), smem, st, L, B, X, n, k,
                       ct);
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
  if (n <= K2_MAX_N) {  // a block a matrix; its columns in tiles of up to BLK_CT
    const int ct = std::min(round16(k), BLK_CT);
    return launch_smem(blk_factor_solve_kernel<S>, dim3((unsigned)T), dim3(BLK_THREADS),
                       blk_smem<S>(panels(n), 1, 1, ct), st, K, B, L, X, n, k, ct);
  }
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
  if (n <= K2_MAX_N) {
    const int nb = panels(n), ct = blk_bwd_ct<S>(nb, k);
    return launch_smem(blk_factor_solve_bwd_kernel<S>, dim3((unsigned)T), dim3(BLK_THREADS),
                       blk_smem<S>(nb, 2, 2, ct), st, L, X, gL, gX, gK, gB, n, k, ct);
  }
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
