// Host launch functions of the port's CUDA kernels. The .cu files define them
// with no PyTorch headers; bindings.cpp checks the tensors and calls them.
// Each returns the launch's cudaError_t.
#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

struct K1Grid {
  float bx, by, bz;  // scene base offset (world -> mesh frame)
  float ox, oy, oz;  // grid origin in the mesh frame
  float delta;
  int nx, ny, nz;
};

// K1 (k1_collision.cu). q [T, dof] f32; sigma [T/K, P] f32 (config t uses row
// t / K); robot [6*dof + 12] and spheres [P, 5] f32; words [ncells, 2] packed
// table; lik [T]; dlik [T, dof], not written when grad is false. dof is 6 or 7.
cudaError_t k1_loglik_launch(const float* q, const float* sigma, const float* robot,
                             const float* spheres, const void* words, float* lik, float* dlik,
                             int64_t T, int64_t K, int P, int dof, bool craig, bool grad,
                             K1Grid g, float eps, cudaStream_t stream);

// K2 (k2_linalg.cu), float64, 1 <= n <= 32. A, L [T, n, n]; B, X [T, n, k].
cudaError_t k2_chol_launch(const double* A, double* L, int64_t T, int n, cudaStream_t stream);
cudaError_t k2_trsm_launch(const double* L, const double* B, double* X, int64_t T, int n, int k,
                           bool upper_t, cudaStream_t stream);

// K3 (k3_clearance.cu). q [T, dof] f32; robot and spheres as K1; sdf
// [nx, ny, nz] f32 with every size >= 2; out [T], the minimum over spheres of
// the trilinear clearance. dof is 6 or 7.
cudaError_t k3_min_clearance_launch(const float* q, const float* robot, const float* spheres,
                                    const float* sdf, float* out, int64_t T, int P, int dof,
                                    bool craig, K1Grid g, cudaStream_t stream);

// K4 (k4_gather.cu). table [ncells] entries of entry_bytes (4 or 8, aligned
// to that); idx [n] int32, clamped to the table; out [n] entries.
cudaError_t k4_gather_launch(const void* table, const int32_t* idx, void* out, int64_t n,
                             int64_t ncells, int entry_bytes, cudaStream_t stream);
