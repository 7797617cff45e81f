// K6 on the CPU (cuda_runtime.h here), with a C interface for ctypes:
// k6_rff.cuh as it is, float32 and float64, forward and backward.
#include "k6_rff.cuh"

thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
namespace {
namespace k6 {  // where the kernels' `extern __shared__ k6_smem` is declared
alignas(16) unsigned char k6_smem[K2_CPU_SMEM];
}
}  // namespace
unsigned char* k2_cpu_smem = k6::k6_smem;
std::barrier<>* k2_cpu_block;
std::barrier<>* k2_cpu_warp[32];
double k2_cpu_xa[32][32], k2_cpu_xb[32][32];

// dims: R, L, A, nb, ns; flags [A] or null; out [R, ns, L, A]; the backward
// writes d_omega [P, nb], d_scale [P] and d_x [P, n_dx]
#define K6_CPU_ENTRY(S, tag)                                                                       \
  extern "C" int k6_##tag(const S* x, const S* omega, const S* phase, const S* scale, const S* w, \
                          const unsigned char* flags, const long long* dims, S* out) {            \
    const K6Args<S> a{x, omega, phase, scale, w, flags, dims[0], (int)dims[1], (int)dims[2],      \
                      (int)dims[3], (int)dims[4]};                                                 \
    return k6_rff_launch<S>(a, out, nullptr);                                                      \
  }                                                                                                \
  extern "C" int k6_bwd_##tag(const S* x, const S* omega, const S* phase, const S* scale,         \
                              const S* w, const unsigned char* flags, const long long* dims,      \
                              const S* g, S* d_omega, S* d_scale, S* d_x, int n_dx) {             \
    const K6Args<S> a{x, omega, phase, scale, w, flags, dims[0], (int)dims[1], (int)dims[2],      \
                      (int)dims[3], (int)dims[4]};                                                 \
    return k6_rff_bwd_launch<S>(a, g, d_omega, d_scale, d_x, n_dx, nullptr);                      \
  }

K6_CPU_ENTRY(float, f32)
K6_CPU_ENTRY(double, f64)
