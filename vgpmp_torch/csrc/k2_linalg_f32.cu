// K2's float32 instantiations (design: k2_linalg.cuh): a session whose
// solve_dtype is float32, through the jitter-escalation path.

#include "k2_linalg.cuh"

K2_INSTANTIATE(float)
