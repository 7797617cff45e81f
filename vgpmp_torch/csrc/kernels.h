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
// table; lik [T]; dlik [T, dof], not written when grad is false; h2 [P, T],
// the squared hinge per sphere and config, written only when not null (and
// then grad must be true). dof is 6 or 7.
cudaError_t k1_loglik_launch(const float* q, const float* sigma, const float* robot,
                             const float* spheres, const void* words, float* lik, float* dlik,
                             float* h2, int64_t T, int64_t K, int P, int dof, bool craig,
                             bool grad, K1Grid g, float eps, cudaStream_t stream);
// K1's d/dsigma from the forward's h2 [P, T] and the upstream gradient g [T]:
// out [T/K, P], out[r, p] = 1/2 sum over row r's K configs t of g[t] h2[p, t]
// / sigma[r, p]^2.
cudaError_t k1_dsigma_launch(const float* g, const float* h2, const float* sigma, float* out,
                             int64_t T, int64_t K, int P, cudaStream_t stream);

// K2 (k2_linalg.cu), float64, 1 <= n <= 32. A, L [T, n, n]; B, X [T, n, k].
cudaError_t k2_chol_launch(const double* A, double* L, int64_t T, int n, cudaStream_t stream);
cudaError_t k2_trsm_launch(const double* L, const double* B, double* X, int64_t T, int n, int k,
                           bool upper_t, cudaStream_t stream);

// The fused pair: L = chol(K) and X = L^-1 B in one launch, and its backward
// in one launch: given dL and dX it writes dB = L^-T dX and dK, the gradient
// of the symmetric K folded onto the lower triangle (the factorisation reads
// only that triangle). K, L, gL, gK [T, n, n]; B, X, gX, gB [T, n, k].
cudaError_t k2_factor_solve_launch(const double* K, const double* B, double* L, double* X,
                                   int64_t T, int n, int k, cudaStream_t stream);
cudaError_t k2_factor_solve_bwd_launch(const double* L, const double* X, const double* gL,
                                       const double* gX, double* gK, double* gB, int64_t T, int n,
                                       int k, cudaStream_t stream);

// K3 (k3_clearance.cu). q [T, dof] f32; robot and spheres as K1; sdf
// [nx, ny, nz] f32 with every size >= 2 and fewer than 2^31 cells; out [T],
// the minimum over spheres of the trilinear clearance. dof is 6 or 7.
cudaError_t k3_min_clearance_launch(const float* q, const float* robot, const float* spheres,
                                    const float* sdf, float* out, int64_t T, int P, int dof,
                                    bool craig, K1Grid g, cudaStream_t stream);

// The metric's floor compare, fused into K3's second entry. The n = B * G
// probes q are rows of B PD paths of G probes each; row b has the query
// endpoints q_s, q_g [B, dof], their penetration depths depth_s, depth_g [B]
// and visited [B]. Probe i of row b is violated when visited[b] and its
// clearance lies below the tapered floor; seg_count [B, T] (zeroed by the
// caller) gains one for each violated probe at seg_count[b, seg_idx[b, i]].
struct K3Probe {
  const float* q_s;
  const float* q_g;
  const float* depth_s;
  const float* depth_g;
  const bool* visited;
  const int64_t* seg_idx;  // [B, G]; an index outside [0, T) is not counted
  int32_t* seg_count;      // [B, T]
  int64_t G, T;
  float inv_radius;        // 1 / taper radius, rounded to float32
  float slack;
};
cudaError_t k3_probe_clearance_launch(const float* q, const float* robot, const float* spheres,
                                      const float* sdf, float* out, int64_t n, int P, int dof,
                                      bool craig, K1Grid g, const K3Probe& probe,
                                      cudaStream_t stream);

// K4 (k4_gather.cu). table [ncells] entries of entry_bytes (4 or 8, aligned
// to that); idx [n] int32, clamped to the table; out [n] entries.
cudaError_t k4_gather_launch(const void* table, const int32_t* idx, void* out, int64_t n,
                             int64_t ncells, int entry_bytes, cudaStream_t stream);
