// K1 on the CPU (cuda_runtime.h here), with a C interface for ctypes: the
// rewritten k1_collision.cuh, float32 in the packed, nearest and trilinear
// modes and float64 in the packed and trilinear modes, and k1_dsigma in both.
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
template cudaError_t k1_loglik_launch<float, K1_TRILINEAR>(const K1Args<float>&, cudaStream_t);
template cudaError_t k1_loglik_launch<double, K1_PACKED>(const K1Args<double>&, cudaStream_t);
template cudaError_t k1_loglik_launch<double, K1_TRILINEAR>(const K1Args<double>&, cudaStream_t);

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
  return mode == K1_PACKED    ? k1_loglik_launch<float, K1_PACKED>(a, nullptr)
         : mode == K1_NEAREST ? k1_loglik_launch<float, K1_NEAREST>(a, nullptr)
                              : k1_loglik_launch<float, K1_TRILINEAR>(a, nullptr);
}
static int k1_dispatch(int mode, const K1Args<double>& a) {
  return mode == K1_PACKED      ? k1_loglik_launch<double, K1_PACKED>(a, nullptr)
         : mode == K1_TRILINEAR ? k1_loglik_launch<double, K1_TRILINEAR>(a, nullptr)
                                : cudaErrorInvalidValue;
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

// k1_dsigma: g [T], h2 [P, T] (T = R K), sigma and out [R, P]
extern "C" int k1_dsigma_f32(const float* g, const float* h2, const float* sigma, float* out, long long T,
                             long long K, int P) {
  return k1_dsigma_launch<float>(g, h2, sigma, out, T, K, P, nullptr);
}
extern "C" int k1_dsigma_f64(const double* g, const double* h2, const double* sigma, double* out,
                             long long T, long long K, int P) {
  return k1_dsigma_launch<double>(g, h2, sigma, out, T, K, P, nullptr);
}

// the parts (warps) a k1_dsigma segment of K values takes
extern "C" int k1_dsigma_parts(long long K, int f64) {
  return f64 ? dsigma_parts<double>(K) : dsigma_parts<float>(K);
}

// The trilinear lookup that K1's split design calls (GridLookup<S,
// K1_TRILINEAR>::value_at, gradient_at) at n world points p [n, 3] of the
// grid (offset (3), origin (3), delta; shape) with values data: value [n],
// grad [n, 3]
template <class S>
static void trilinear_at(const S* p, long long n, const S* grid, const int* shape, const S* data, S* value,
                         S* grad) {
  const GridArgs<S> g{grid[0], grid[1], grid[2], grid[3], grid[4], grid[5], grid[6], shape[0], shape[1], shape[2]};
  using Lookup = GridLookup<S, K1_TRILINEAR>;
  for (long long k = 0; k < n; ++k) {
    const S x = p[3 * k] - g.bx, y = p[3 * k + 1] - g.by, z = p[3 * k + 2] - g.bz;
    S gr[3];
    value[k] = Lookup::value_at(data, g, x, y, z);
    Lookup::gradient_at(data, g, x, y, z, gr);
    for (int a = 0; a < 3; ++a) grad[3 * k + a] = gr[a];
  }
}
extern "C" void k1_trilinear_at_f32(const float* p, long long n, const float* grid, const int* shape,
                                    const float* data, float* value, float* grad) {
  trilinear_at<float>(p, n, grid, shape, data, value, grad);
}
extern "C" void k1_trilinear_at_f64(const double* p, long long n, const double* grid, const int* shape,
                                    const double* data, double* value, double* grad) {
  trilinear_at<double>(p, n, grid, shape, data, value, grad);
}
