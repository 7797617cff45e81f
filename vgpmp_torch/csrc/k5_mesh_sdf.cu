// K5's one instantiation: float64 arithmetic, float32 grid (design:
// k5_mesh_sdf.cuh).

#include "k5_mesh_sdf.cuh"
