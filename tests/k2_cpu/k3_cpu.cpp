// K3 on the CPU (cuda_runtime.h here), with a C interface for ctypes: the
// rewritten k3_clearance.cuh, both entries, float32 and float64.
#include "k3_clearance.cuh"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
namespace {  // where the kernel's `extern __shared__ k3_smem` is declared
alignas(16) unsigned char k3_smem[K2_CPU_SMEM];
}
unsigned char* k2_cpu_smem = k3_smem;
std::barrier<>* k2_cpu_block;
std::barrier<>* k2_cpu_warp[32];
double k2_cpu_xa[32][32], k2_cpu_xb[32][32];
unsigned long long k2_cpu_xk[32][32];
std::atomic<unsigned> k2_cpu_posted[32][32];
unsigned k2_cpu_epoch[32];

// grid: base offset (3), origin (3), delta; shape: nx, ny, nz; the extras as
// SceneExtras; out [n]. The probe entry (probe not null): q_s, q_g [B, dof],
// depth_s, depth_g [B], visited [B], seg_idx [B, G], seg_count [B, T] (zeroed),
// sizes (G, T), floor (1 / radius, slack).
#define K3_CPU_ENTRY(S, tag)                                                                           \
  extern "C" int k3_##tag(const S* q, const S* robot, const S* spheres, const S* sdf, const S* grid,  \
                          const int* shape, const S* grid_f, const int* grid_i, const S* cells,       \
                          const S* prims, const int* counts, S* out, long long n, int P, int dof,     \
                          int craig, int probe, const S* q_s, const S* q_g, const S* depth_s,         \
                          const S* depth_g, const bool* visited, const long long* seg_idx,            \
                          int* seg_count, const long long* sizes, const S* floor) {                   \
    const SceneExtras ex{grid_f, grid_i, cells, prims, counts[0], counts[1], counts[2], counts[3]};   \
    const GridArgs<S> g{grid[0], grid[1], grid[2], grid[3], grid[4], grid[5], grid[6],                \
                        shape[0], shape[1], shape[2]};                                                 \
    if (!probe)                                                                                        \
      return k3_min_clearance_launch<S>(q, robot, spheres, sdf, ex, out, n, P, dof, craig != 0, g,    \
                                        nullptr);                                                      \
    const K3Probe<S> pa{q_s,     q_g,       depth_s,  depth_g,  visited, (const int64_t*)seg_idx,      \
                        seg_count, sizes[0], sizes[1], floor[0], floor[1]};                            \
    return k3_probe_clearance_launch<S>(q, robot, spheres, sdf, ex, out, n, P, dof, craig != 0, g, pa, \
                                        nullptr);                                                      \
  }

K3_CPU_ENTRY(float, f32)
K3_CPU_ENTRY(double, f64)
