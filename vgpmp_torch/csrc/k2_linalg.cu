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
// Design: chol runs one warp per matrix, lane i holding row i in registers;
// each column step broadcasts the pivot and the new column by warp shuffles,
// so no shared memory and no block barrier is needed. trsm runs one block per
// matrix (and column tile): L goes to shared memory once, each thread carries
// one right-hand-side column through the substitution in registers.
// All keep the plain version's NaN-in, NaN-out behaviour: a negative pivot
// gives NaN through sqrt and is never clamped.
//
// The fused pair does the main path's work in fewer launches, since the count
// of launches, each with its wrapper and glue ops, is what this work costs a
// step. factor_solve_kernel: one block per matrix factors K in warp 0 while
// every thread's column of B is already on its way from memory, keeps L and
// the reciprocals of its diagonal in shared memory and substitutes by
// multiplying, so L never goes through device memory between the two and no
// step divides. factor_solve_bwd_kernel: one block per matrix runs the whole
// backward pass of both (dB, then dK through Phi(L^T dL)), which as separate
// functions takes three launches and a dozen tensor ops. chol and trsm stay
// for the callers of a lone factorisation or solve.

#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <int NC>
__global__ void chol_kernel(const double* __restrict__ A, double* __restrict__ L, long long T,
                            int n) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= T) return;  // uniform across the warp
  const double* a = A + m * n * n;
  double row[NC];
  double out[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    row[k] = (lane < n && k < n) ? a[lane * n + k] : 0.0;
    out[k] = 0.0;
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < n) {
      const double pivot = sqrt(__shfl_sync(FULL, row[j], j));
      double col = row[j] / pivot;
      if (lane < j) col = 0.0;
      out[j] = col;
#pragma unroll
      for (int k = j + 1; k < NC; ++k) {
        const double ck = __shfl_sync(FULL, col, k);
        row[k] -= col * ck;
      }
    }
  }
  if (lane < n) {
    double* l = L + m * n * n + lane * n;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < n) l[k] = out[k];
  }
}

// Solve L X = B (UPPER_T false) or L^T X = B (UPPER_T true); B, X [T, n, k].
template <int NC, bool UPPER_T>
__global__ void trsm_kernel(const double* __restrict__ L, const double* __restrict__ B,
                            double* __restrict__ X, int n, int k) {
  __shared__ double Ls[32 * 32];
  const long long m = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const double* l = L + m * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) Ls[i] = l[i];
  __syncthreads();
  if (col >= k) return;
  const double* b = B + m * n * k + col;
  double x[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) x[i] = (i < n) ? b[(long long)i * k] : 0.0;
  if (!UPPER_T) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < n) {
        const double xi = x[i] / Ls[i * n + i];
        x[i] = xi;
#pragma unroll
        for (int r = i + 1; r < NC; ++r)
          if (r < n) x[r] -= Ls[r * n + i] * xi;
      }
    }
  } else {
#pragma unroll
    for (int i = NC - 1; i >= 0; --i) {
      if (i < n) {
        const double xi = x[i] / Ls[i * n + i];
        x[i] = xi;
#pragma unroll
        for (int r = 0; r < i; ++r) x[r] -= Ls[i * n + r] * xi;
      }
    }
  }
  double* out = X + m * n * k + col;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < n) out[(long long)i * k] = x[i];
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
// thread first asks for its column of B; warp 0 then factors K by chol_kernel's
// shuffle scheme while those loads are in flight, and leaves L and the
// reciprocals of its diagonal in shared memory, so that the substitution
// multiplies where trsm_kernel divides.
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
  const int warps = 4;
  chol_kernel<NC><<<(unsigned)((T + warps - 1) / warps), 32 * warps, 0, st>>>(A, L, T, n);
  return cudaGetLastError();
}

template <int NC>
cudaError_t trsm_launch_nc(const double* L, const double* B, double* X, long long T, int n, int k,
                           bool upper_t, cudaStream_t st) {
  const int threads = k >= 128 ? 128 : ((k + 31) / 32) * 32;
  const dim3 grid((unsigned)T, (unsigned)((k + threads - 1) / threads));
  if (upper_t)
    trsm_kernel<NC, true><<<grid, threads, 0, st>>>(L, B, X, n, k);
  else
    trsm_kernel<NC, false><<<grid, threads, 0, st>>>(L, B, X, n, k);
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

cudaError_t k2_chol_launch(const double* A, double* L, int64_t T, int n, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n <= 8) return chol_launch_nc<8>(A, L, T, n, st);
  if (n <= 16) return chol_launch_nc<16>(A, L, T, n, st);
  if (n <= 32) return chol_launch_nc<32>(A, L, T, n, st);
  return cudaErrorInvalidValue;
}

cudaError_t k2_trsm_launch(const double* L, const double* B, double* X, int64_t T, int n, int k,
                           bool upper_t, cudaStream_t st) {
  if (T == 0) return cudaSuccess;
  if (n <= 8) return trsm_launch_nc<8>(L, B, X, T, n, k, upper_t, st);
  if (n <= 16) return trsm_launch_nc<16>(L, B, X, T, n, k, upper_t, st);
  if (n <= 32) return trsm_launch_nc<32>(L, B, X, T, n, k, upper_t, st);
  return cudaErrorInvalidValue;
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
