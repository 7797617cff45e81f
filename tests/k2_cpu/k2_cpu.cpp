// K2's four entries on the CPU (cuda_runtime.h here), with a C interface
// for ctypes: the rewritten k2_linalg.cuh, both dtypes, and the choices of
// the block design the tests' numpy emulation of its order must follow.
#include "k2_linalg.cuh"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
namespace {  // where the kernels' `extern __shared__ k2_smem` is declared
alignas(16) unsigned char k2_smem[K2_CPU_SMEM];
}
unsigned char* k2_cpu_smem = k2_smem;
std::barrier<>* k2_cpu_block;
std::barrier<>* k2_cpu_warp[32];
double k2_cpu_xa[32][32], k2_cpu_xb[32][32];

K2_INSTANTIATE(double)
K2_INSTANTIATE(float)

#define K2_CPU_ENTRIES(S, tag)                                                                             \
  int chol_##tag(const S* A, S* L, long long T, int n) { return k2_chol_launch<S>(A, L, T, n, 0); }         \
  int trsm_##tag(const S* L, const S* B, S* X, long long T, int n, int k, int up) {                      \
    return k2_trsm_launch<S>(L, B, X, T, n, k, up, 0);                                                     \
  }                                                                                                        \
  int pair_##tag(const S* K, const S* B, S* L, S* X, long long T, int n, int k) {                        \
    return k2_factor_solve_launch<S>(K, B, L, X, T, n, k, 0);                                              \
  }                                                                                                        \
  int bwd_##tag(const S* L, const S* X, const S* gL, const S* gX, S* gK, S* gB, long long T, int n, int k) { \
    return k2_factor_solve_bwd_launch<S>(L, X, gL, gX, gK, gB, T, n, k, 0);                                \
  }

extern "C" {
K2_CPU_ENTRIES(double, f64)
K2_CPU_ENTRIES(float, f32)
int panel_rows() { return PANEL; }
int sub_rows() { return SUB; }
int bwd_tile_f64(int nb, int k) { return blk_bwd_ct<double>(nb, k); }
}
