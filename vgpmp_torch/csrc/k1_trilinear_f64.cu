// K1's float64 trilinear instantiations (design: k1_collision.cuh).

#include "k1_collision.cuh"

template cudaError_t k1_loglik_launch<double, K1_TRILINEAR>(const K1Args<double>&, cudaStream_t);
