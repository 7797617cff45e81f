// K2: batched small float64 Cholesky and triangular solves.
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

#include <algorithm>

#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM: the grids are sized to cover them

// An 8-byte copy from device memory to shared memory that no thread waits on
// (cp.async): every copy of a loop is in flight at once, none parks in a
// register on its way.
__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
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
template <int NC>
__global__ void __launch_bounds__(32 * CHOL_MAX_WARPS)
    chol_kernel(const double* __restrict__ A, double* __restrict__ L, long long T, int n) {
  constexpr int W = chol_width<NC>();
  constexpr int MPW = 32 / W;
  __shared__ double tile[CHOL_MAX_WARPS][MPW * NC * NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane % W, slot = lane / W;
  const long long m0 = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * MPW;
  if (m0 >= T) return;  // uniform across the warp, and no block barrier follows
  // a slot past the last matrix takes part in every shuffle and stores nothing
  const int cnt = (int)min((long long)MPW, T - m0);
  const int nn = n * n;
  double* s = tile[warp];
  for (int e = lane; e < cnt * nn; e += 32) copy_async8(s + e, A + m0 * nn + e);  // coalesced
  copy_async_wait();
  __syncwarp();
  const bool live = slot < cnt && sl < n;
  double* rs = s + slot * nn + sl * n;
  // padded to NC x NC with the identity (an empty slot is the identity whole)
  double row[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) row[c] = (live && c < n) ? rs[c] : (c == sl ? 1.0 : 0.0);
  // the next pivot is its owner's own update, shuffled before the others'
  double d = __shfl_sync(FULL, row[0], 0, W);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const double r = rsqrt(d);
    const double cj = sl < j ? 0.0 : row[j] * r;  // on lane j, d * r = sqrt(d)
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
template <int NC, bool UPPER_T>
__global__ void __launch_bounds__(128)
    trsm_kernel(const double* __restrict__ L, const double* __restrict__ B, double* __restrict__ X,
                long long T, int n, int k, int mb, int ct) {
  extern __shared__ double smem[];
  double* Ls = smem;                   // [mb][NC][NC]
  double* rinv = smem + mb * NC * NC;  // [mb][NC]
  const int nn = n * n;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * mb;
  const int cnt = (int)min((long long)mb, T - m0);
  const int slot = tid / ct;
  const int col = blockIdx.y * ct + tid % ct;
  const bool live = slot < cnt && col < k;
  const long long off = live ? (m0 + slot) * n * k + col : 0;
  // B's column first, so that its loads are in flight while L arrives
  double x[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) x[i] = (live && i < n) ? B[off + (long long)i * k] : 0.0;
  // the tile entry by entry: a copy of the factor's entry, or the identity's
  for (int e = tid; e < cnt * NC * NC; e += blockDim.x) {
    const int q = e / (NC * NC), i = (e / NC) % NC, c = e % NC;
    if (i < n && c < n)
      copy_async8(Ls + e, L + (m0 + q) * nn + i * n + c);
    else
      Ls[e] = i == c ? 1.0 : 0.0;
  }
  for (int e = tid; e < mb * NC; e += blockDim.x) {
    const int q = e / NC, i = e % NC;
    rinv[e] = (q < cnt && i < n) ? 1.0 / L[(m0 + q) * nn + i * (n + 1)] : 1.0;
  }
  copy_async_wait();
  __syncthreads();
  if (!live) return;  // after the block's only barrier
  const double* l = Ls + slot * NC * NC;
  const double* ri = rinv + slot * NC;
  if (!UPPER_T) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const double xi = x[i] * ri[i];
      x[i] = xi;
#pragma unroll
      for (int r = i + 1; r < NC; ++r) x[r] -= l[r * NC + i] * xi;
    }
  } else {
#pragma unroll
    for (int i = NC - 1; i >= 0; --i) {
      const double xi = x[i] * ri[i];
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
template <int NC>
__device__ __forceinline__ void solve_upper_t_regs(const double* Ls, const double* rinv, int n,
                                                   double (&x)[NC]) {
#pragma unroll
  for (int i = NC - 1; i >= 0; --i) {
    if (i < n) {
      const double xi = x[i] * rinv[i];
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
template <int NC>
__global__ void factor_solve_kernel(const double* __restrict__ K, const double* __restrict__ B,
                                    double* __restrict__ L, double* __restrict__ X, int n, int k) {
  __shared__ double Ls[NC * NC];
  __shared__ double rinv[NC];
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  const double* b = B + m * n * k;
  double* xo = X + m * n * k;
  int col = tid;
  double x[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) x[i] = (i < n && col < k) ? b[(long long)i * k + col] : 0.0;

  if (tid < 32) {
    const int lane = tid;
    const double* a = K + m * n * n;
    double row[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) row[c] = (lane < n && c < n) ? a[lane * n + c] : 0.0;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < n) {
        const double pivot = sqrt(__shfl_sync(FULL, row[j], j));
        const double r = 1.0 / pivot;
        double cj = lane == j ? pivot : row[j] * r;
        if (lane < j) cj = 0.0;
        if (lane < n) Ls[lane * n + j] = cj;
        if (lane == 0) rinv[j] = r;
#pragma unroll
        for (int c = j + 1; c < NC; ++c) {
          const double cc = __shfl_sync(FULL, cj, c);
          row[c] -= cj * cc;
        }
      }
    }
  }
  __syncthreads();
  double* l = L + m * n * n;
  for (int i = tid; i < n * n; i += blockDim.x) l[i] = Ls[i];

  while (col < k) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < n) {
        const double xi = x[i] * rinv[i];
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
template <int NC, int CH>
__global__ void __launch_bounds__(CH) factor_solve_bwd_kernel(
    const double* __restrict__ L, const double* __restrict__ X, const double* __restrict__ gL,
    const double* __restrict__ gX, double* __restrict__ gK, double* __restrict__ gB, int n, int k) {
  constexpr int CHP = CH + 1;  // row stride of the column tiles, against bank conflicts
  __shared__ double Ls[NC * NC];
  __shared__ double Gs[NC * NC];
  __shared__ double Ps[NC * NC];
  __shared__ double rinv[NC];
  __shared__ double Xs[NC * CHP];
  __shared__ double Bs[NC * CHP];
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n;
  for (int p = tid; p < nn; p += CH) {
    Ls[p] = L[m * nn + p];
    Gs[p] = (p / n >= p % n) ? gL[m * nn + p] : 0.0;
  }
  __syncthreads();
  if (tid < n) rinv[tid] = 1.0 / Ls[tid * n + tid];
  __syncthreads();

  const double* xg = X + m * n * k;
  const double* gx = gX + m * n * k;
  double* gb = gB + m * n * k;
  for (int c0 = 0; c0 < k; c0 += CH) {
    const int col = c0 + tid;
    double y[NC];
    if (col < k) {
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = (i < n) ? gx[(long long)i * k + col] : 0.0;
      solve_upper_t_regs<NC>(Ls, rinv, n, y);
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = 0.0;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < n) {
        Bs[i * CHP + tid] = y[i];
        Xs[i * CHP + tid] = (col < k) ? xg[(long long)i * k + col] : 0.0;
        if (col < k) gb[(long long)i * k + col] = y[i];
      }
    }
    __syncthreads();
    const int width = min(CH, k - c0);
    for (int p = tid; p < nn; p += CH) {
      const int i = p / n, j = p % n;
      if (i >= j) {
        double acc = 0.0;
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
      double acc = 0.0;
      for (int r = i; r < n; ++r) acc += Ls[r * n + i] * Gs[r * n + j];
      Ps[i * n + j] = 0.5 * acc;
      Ps[j * n + i] = 0.5 * acc;
    }
  }
  __syncthreads();
  // Y = L^-T Phi, a column per thread, into Gs
  if (tid < n) {
    double y[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) y[i] = (i < n) ? Ps[i * n + tid] : 0.0;
    solve_upper_t_regs<NC>(Ls, rinv, n, y);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < n) Gs[i * n + tid] = y[i];
  }
  __syncthreads();
  // S^T = L^-T Y^T: thread c takes row c of Y and leaves row c of S in Ps
  if (tid < n) {
    double y[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) y[i] = (i < n) ? Gs[tid * n + i] : 0.0;
    solve_upper_t_regs<NC>(Ls, rinv, n, y);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (i < n) Ps[tid * n + i] = y[i];
  }
  __syncthreads();
  for (int p = tid; p < nn; p += CH) {
    const int i = p / n, j = p % n;
    gK[m * nn + p] = i > j ? Ps[i * n + j] + Ps[j * n + i] : (i == j ? Ps[p] : 0.0);
  }
}

template <int NC>
cudaError_t chol_launch_nc(const double* A, double* L, long long T, int n, cudaStream_t st) {
  constexpr int MPW = 32 / chol_width<NC>();
  const long long warps = (T + MPW - 1) / MPW;
  // one warp a block until the warps outnumber the SMs
  const int wpb = (int)std::max(1LL, std::min((long long)CHOL_MAX_WARPS, warps / SMS));
  chol_kernel<NC><<<(unsigned)((warps + wpb - 1) / wpb), 32 * wpb, 0, st>>>(A, L, T, n);
  return cudaGetLastError();
}

template <int NC>
cudaError_t trsm_launch_nc(const double* L, const double* B, double* X, long long T, int n, int k,
                           bool upper_t, cudaStream_t st) {
  // 128-column tiles of one matrix; up to 16 columns, several matrices a
  // block: as many as keeps every SM busy, at least two, at most a column
  // for each of 128 threads and 48 KB of factors
  const int ct = std::min(k, 128);
  int mb = 1;
  if (k <= 16) {
    const int fit = 49152 / ((NC * NC + NC) * 8);
    mb = (int)std::max(2LL, std::min(T / SMS, (long long)std::min(128 / k, fit)));
  }
  // a packed block has 128 threads whatever its columns, to share the copy
  // of its factors
  const int threads = k <= 16 ? 128 : (ct + 31) / 32 * 32;
  const dim3 grid((unsigned)((T + mb - 1) / mb), (unsigned)((k + ct - 1) / ct));
  const size_t smem = (size_t)mb * (NC * NC + NC) * sizeof(double);
  if (upper_t)
    trsm_kernel<NC, true><<<grid, threads, smem, st>>>(L, B, X, T, n, k, mb, ct);
  else
    trsm_kernel<NC, false><<<grid, threads, smem, st>>>(L, B, X, T, n, k, mb, ct);
  return cudaGetLastError();
}

template <int NC>
cudaError_t factor_solve_launch_nc(const double* K, const double* B, double* L, double* X,
                                   long long T, int n, int k, cudaStream_t st) {
  const int threads = k >= 256 ? 256 : ((k + 31) / 32) * 32;
  factor_solve_kernel<NC><<<(unsigned)T, threads, 0, st>>>(K, B, L, X, n, k);
  return cudaGetLastError();
}

template <int NC, int CH>
cudaError_t factor_solve_bwd_launch_nc(const double* L, const double* X, const double* gL,
                                       const double* gX, double* gK, double* gB, long long T,
                                       int n, int k, cudaStream_t st) {
  factor_solve_bwd_kernel<NC, CH><<<(unsigned)T, CH, 0, st>>>(L, X, gL, gX, gK, gB, n, k);
  return cudaGetLastError();
}

}  // namespace

// The unroll depth NC is n rounded up to a multiple of 4.
#define K2_BY_NC(launch, ...)                                                      \
  switch ((n + 3) / 4) {                                                           \
    case 1: return launch<4>(__VA_ARGS__);                                          \
    case 2: return launch<8>(__VA_ARGS__);                                          \
    case 3: return launch<12>(__VA_ARGS__);                                         \
    case 4: return launch<16>(__VA_ARGS__);                                         \
    case 5: return launch<20>(__VA_ARGS__);                                         \
    case 6: return launch<24>(__VA_ARGS__);                                         \
    case 7: return launch<28>(__VA_ARGS__);                                         \
    case 8: return launch<32>(__VA_ARGS__);                                         \
    default: return cudaErrorInvalidValue;                                         \
  }

cudaError_t k2_chol_launch(const double* A, double* L, int64_t T, int n, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1) return cudaErrorInvalidValue;
  K2_BY_NC(chol_launch_nc, A, L, T, n, st)
}

cudaError_t k2_trsm_launch(const double* L, const double* B, double* X, int64_t T, int n, int k,
                           bool upper_t, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  K2_BY_NC(trsm_launch_nc, L, B, X, T, n, k, upper_t, st)
}

cudaError_t k2_factor_solve_launch(const double* K, const double* B, double* L, double* X,
                                   int64_t T, int n, int k, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n <= 8) return factor_solve_launch_nc<8>(K, B, L, X, T, n, k, st);
  if (n <= 16) return factor_solve_launch_nc<16>(K, B, L, X, T, n, k, st);
  if (n <= 32) return factor_solve_launch_nc<32>(K, B, L, X, T, n, k, st);
  return cudaErrorInvalidValue;
}

// The column tiles hold CH columns of X and dB; CH shrinks with n so that the
// block's shared memory stays under 48 KB.
cudaError_t k2_factor_solve_bwd_launch(const double* L, const double* X, const double* gL,
                                       const double* gX, double* gK, double* gB, int64_t T, int n,
                                       int k, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n <= 8) return factor_solve_bwd_launch_nc<8, 128>(L, X, gL, gX, gK, gB, T, n, k, st);
  if (n <= 16) return factor_solve_bwd_launch_nc<16, 128>(L, X, gL, gX, gK, gB, T, n, k, st);
  if (n <= 32) return factor_solve_bwd_launch_nc<32, 32>(L, X, gL, gX, gK, gB, T, n, k, st);
  return cudaErrorInvalidValue;
}
