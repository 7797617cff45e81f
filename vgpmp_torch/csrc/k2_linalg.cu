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
// Both keep the plain version's NaN-in, NaN-out behaviour: a negative pivot
// gives NaN through sqrt and is never clamped.

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
