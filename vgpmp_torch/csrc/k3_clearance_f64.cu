// K3's float64 instantiations, both entries (design: k3_clearance.cuh).

#include "k3_clearance.cuh"

template cudaError_t k3_min_clearance_launch<double>(const double*, const double*, const double*,
                                                     const double*, const SceneExtras&, double*,
                                                     int64_t, int, int, bool, GridArgs<double>,
                                                     cudaStream_t);
template cudaError_t k3_probe_clearance_launch<double>(const double*, const double*, const double*,
                                                       const double*, const SceneExtras&, double*,
                                                       int64_t, int, int, bool, GridArgs<double>,
                                                       const K3Probe<double>&, cudaStream_t);
