// K1's float32 packed-table instantiations (the main path) and K1's d/dsigma
// reduction in float and double. The kernel and its design are in
// k1_collision.cuh; each other lookup mode and scalar type is instantiated in
// a source of its own (k1_nearest.cu, k1_trilinear.cu, k1_packed_f64.cu,
// k1_nearest_f64.cu, k1_trilinear_f64.cu), so that nvcc compiles them side by
// side.

#include "k1_collision.cuh"

template cudaError_t k1_loglik_launch<float, K1_PACKED>(const K1Args<float>&, cudaStream_t);
template cudaError_t k1_dsigma_launch<float>(const float*, const float*, const float*, float*,
                                             int64_t, int64_t, int, cudaStream_t);
template cudaError_t k1_dsigma_launch<double>(const double*, const double*, const double*, double*,
                                              int64_t, int64_t, int, cudaStream_t);
