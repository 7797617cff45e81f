// K3's float32 instantiations, both entries (design: k3_clearance.cuh); the
// float64 ones are in k3_clearance_f64.cu, compiled beside this source.

#include "k3_clearance.cuh"

template cudaError_t k3_min_clearance_launch<float>(const float*, const float*, const float*,
                                                    const float*, const SceneExtras&, float*,
                                                    int64_t, int, int, bool, GridArgs<float>,
                                                    cudaStream_t);
template cudaError_t k3_probe_clearance_launch<float>(const float*, const float*, const float*,
                                                      const float*, const SceneExtras&, float*,
                                                      int64_t, int, int, bool, GridArgs<float>,
                                                      const K3Probe<float>&, cudaStream_t);
