// K1 on the CPU (cuda_runtime.h here), with a C interface for ctypes: the
// rewritten k1_collision.cuh, float32 in the packed and nearest modes and
// float64 in the packed mode.
#include "k1_collision.cuh"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
namespace {  // where the kernel's `extern __shared__ k1_smem` is declared
alignas(16) unsigned char k1_smem[K2_CPU_SMEM];
}
unsigned char* k2_cpu_smem = k1_smem;
std::barrier<>* k2_cpu_block;
std::barrier<>* k2_cpu_warp[32];
double k2_cpu_xa[32][32], k2_cpu_xb[32][32];

template cudaError_t k1_loglik_launch<float, K1_PACKED>(const K1Args<float>&, cudaStream_t);
template cudaError_t k1_loglik_launch<float, K1_NEAREST>(const K1Args<float>&, cudaStream_t);
template cudaError_t k1_loglik_launch<double, K1_PACKED>(const K1Args<double>&, cudaStream_t);

// grid: base offset (3), origin (3), delta; shape: nx, ny, nz; the extras as
// SceneExtras; lik [T], dlik [T, dof] (grad), h2 [P, T] (when not null)
#define K1_CPU_ENTRY(S, tag)                                                                          \
  extern "C" int k1_##tag(int mode, const S* q, const S* sigma, const S* robot, const S* spheres,    \
                          const void* table, const S* grid, const int* shape, const S* grid_f,       \
                          const int* grid_i, const void* cells, const S* prims, const int* counts,   \
                          S* lik, S* dlik, S* h2, long long T, long long K, int P, int dof, int craig, \
                          int grad, S eps) {                                                          \
    const SceneExtras ex{grid_f, grid_i, cells, prims, counts[0], counts[1], counts[2], counts[3]};  \
    const GridArgs<S> g{grid[0], grid[1], grid[2], grid[3], grid[4], grid[5], grid[6],               \
                        shape[0], shape[1], shape[2]};                                                \
    const K1Args<S> a{q, sigma, robot, spheres, table, ex, lik, dlik, h2, T, K, P, dof,              \
                      craig != 0, grad != 0, g, eps};                                                 \
    return k1_dispatch(mode, a);                                                                      \
  }

static int k1_dispatch(int mode, const K1Args<float>& a) {
  return mode == K1_PACKED ? k1_loglik_launch<float, K1_PACKED>(a, nullptr)
                           : k1_loglik_launch<float, K1_NEAREST>(a, nullptr);
}
static int k1_dispatch(int mode, const K1Args<double>& a) {
  return mode == K1_PACKED ? k1_loglik_launch<double, K1_PACKED>(a, nullptr) : cudaErrorInvalidValue;
}
K1_CPU_ENTRY(float, f32)
K1_CPU_ENTRY(double, f64)

template <class S>
static int split_design(int mode, int extra) {
  if (mode == K1_PACKED)
    return extra ? k1_split<S, K1_PACKED, true>() : k1_split<S, K1_PACKED, false>();
  if (mode == K1_NEAREST)
    return extra ? k1_split<S, K1_NEAREST, true>() : k1_split<S, K1_NEAREST, false>();
  return extra ? k1_split<S, K1_TRILINEAR, true>() : k1_split<S, K1_TRILINEAR, false>();
}

// whether the instantiation of (mode, extras, float64) takes the split design
extern "C" int k1_split_design(int mode, int extra, int f64) {
  return f64 ? split_design<double>(mode, extra) : split_design<float>(mode, extra);
}

// the flat index of the nearest cell (scene.cuh:nearest_cell) of n float64
// points p [n, 3] in the grid (origin (3), delta; shape)
extern "C" void k1_nearest_cells_f64(const double* p, long long n, const double* grid, const int* shape,
                                     long long* out) {
  const GridArgs<double> g{0, 0, 0, grid[0], grid[1], grid[2], grid[3], shape[0], shape[1], shape[2]};
  for (long long k = 0; k < n; ++k) {
    int i[3];
    out[k] = nearest_cell(p[3 * k], p[3 * k + 1], p[3 * k + 2], g, i);
  }
}
