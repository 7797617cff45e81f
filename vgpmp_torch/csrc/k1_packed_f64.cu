// K1's float64 packed-table instantiations (design: k1_collision.cuh).

#include "k1_collision.cuh"

template cudaError_t k1_loglik_launch<double, K1_PACKED>(const K1Args<double>&, cudaStream_t);
