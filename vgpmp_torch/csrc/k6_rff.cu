// K6's instantiations, float32 and float64, forward and backward (design:
// k6_rff.cuh).

#include "k6_rff.cuh"

template cudaError_t k6_rff_launch<float>(const K6Args<float>&, float*, cudaStream_t);
template cudaError_t k6_rff_launch<double>(const K6Args<double>&, double*, cudaStream_t);
template cudaError_t k6_rff_bwd_launch<float>(const K6Args<float>&, const float*, float*, float*,
                                              float*, int, cudaStream_t);
template cudaError_t k6_rff_bwd_launch<double>(const K6Args<double>&, const double*, double*,
                                               double*, double*, int, cudaStream_t);
