// K1's float32 trilinear instantiations (design: k1_collision.cuh).

#include "k1_collision.cuh"

template cudaError_t k1_loglik_launch<float, K1_TRILINEAR>(const K1Args<float>&, cudaStream_t);
