// K2's float64 instantiations (design: k2_linalg.cuh): the island of a
// float32 session and every float64 session. The float32 ones are in
// k2_linalg_f32.cu, compiled beside this source.

#include "k2_linalg.cuh"

K2_INSTANTIATE(double)
