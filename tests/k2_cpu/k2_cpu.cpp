// K2's four entries on the CPU (cuda_runtime.h here), with a C interface
// for ctypes: the rewritten k2_linalg.cuh, both dtypes, the scratch of the
// streamed design, and the choices of the block design the tests' numpy
// emulation of its order must follow.
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

// each entry that takes the streamed design's scratch (n > 128; the caller
// allocates it, k2_scratch_values a matrix) with it and without it (null),
// and the lone solve, which takes none
#define K2_CPU_ENTRIES(S, tag)                                                                             \
  int schol_##tag(const S* A, S* L, long long T, int n, S* w) { return k2_chol_launch<S>(A, L, T, n, w, 0); } \
  int spair_##tag(const S* K, const S* B, S* L, S* X, long long T, int n, int k, S* w) {                \
    return k2_factor_solve_launch<S>(K, B, L, X, T, n, k, w, 0);                                           \
  }                                                                                                        \
  int sbwd_##tag(const S* L, const S* X, const S* gL, const S* gX, S* gK, S* gB, long long T, int n, int k, \
                 S* w) {                                                                                   \
    return k2_factor_solve_bwd_launch<S>(L, X, gL, gX, gK, gB, T, n, k, w, 0);                             \
  }                                                                                                        \
  int chol_##tag(const S* A, S* L, long long T, int n) { return schol_##tag(A, L, T, n, nullptr); }        \
  int trsm_##tag(const S* L, const S* B, S* X, long long T, int n, int k, int up) {                      \
    return k2_trsm_launch<S>(L, B, X, T, n, k, up, 0);                                                     \
  }                                                                                                        \
  int pair_##tag(const S* K, const S* B, S* L, S* X, long long T, int n, int k) {                        \
    return spair_##tag(K, B, L, X, T, n, k, nullptr);                                                      \
  }                                                                                                        \
  int bwd_##tag(const S* L, const S* X, const S* gL, const S* gX, S* gK, S* gB, long long T, int n, int k) { \
    return sbwd_##tag(L, X, gL, gX, gK, gB, T, n, k, nullptr);                                             \
  }                                                                                                        \
  long long scratch_##tag(int entry, int n) { return k2_scratch_values<S>((K2Entry)entry, n); }

extern "C" {
K2_CPU_ENTRIES(double, f64)
K2_CPU_ENTRIES(float, f32)
int panel_rows() { return PANEL; }
int sub_rows() { return SUB; }
int bwd_tile_f64(int nb, int k) { return blk_bwd_ct<double>(nb, k); }
}
