// K1's float32 nearest-cell instantiations (design: k1_collision.cuh).

#include "k1_collision.cuh"

template cudaError_t k1_loglik_launch<float, K1_NEAREST>(const K1Args<float>&, cudaStream_t);
