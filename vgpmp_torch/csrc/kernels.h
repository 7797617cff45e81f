// Host launch functions of the port's CUDA kernels. The .cu files define them
// with no PyTorch headers; bindings.cpp checks the tensors and calls them.
// Each returns the launch's cudaError_t. A template is declared here and
// instantiated explicitly, one scalar type (float or double) and, for K1, one
// lookup mode a source file, so that nvcc compiles the instantiations side
// by side.
#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

// A voxel grid's placement, in the session's scalar type S: the offset of its
// frame in the world (bx, by, bz; the scene's base offset, or an extra grid's
// world offset), its origin in that frame and its voxel edge; its shape.
template <class S>
struct GridArgs {
  S bx, by, bz;
  S ox, oy, oz;
  S delta;
  int nx, ny, nz;
};

// A scene's sources beyond the base grid (scene.cuh composes them), as
// device tensors in S: grid_f [G, SCENE_GRID_F] (world offset, origin,
// delta), grid_i [G, SCENE_GRID_I] int32 (nx, ny, nz, first cell in cells),
// cells (K1 packed: the grids' packed words [cells, 2] int32, concatenated;
// K1 nearest or trilinear, and K3: their values in S), prims: Ks spheres
// (centre, radius), then Kb boxes (centre, world->box rotation row-major,
// half extents), then Kc capsules (segment start, end, radius). All counts 0:
// the base grid alone.
constexpr int SCENE_GRID_F = 7, SCENE_GRID_I = 4;
constexpr int SCENE_SPHERE = 4, SCENE_BOX = 15, SCENE_CAPSULE = 7;
struct SceneExtras {
  const void* grid_f;
  const int32_t* grid_i;
  const void* cells;
  const void* prims;
  int G, Ks, Kb, Kc;
};

// K1's lookup of a grid: the packed nearest cell (one 8-byte word: the bf16
// value and gradient), the reference's nearest cell (the value, and the
// central difference of its six neighbours, with an exactly-zero component
// replaced by 0.1), or trilinear interpolation (the eight corners, and the
// exact derivative of the interpolation).
enum K1Mode : int { K1_PACKED = 0, K1_NEAREST = 1, K1_TRILINEAR = 2 };

// K1 (k1_collision.cuh). q [T, dof]; sigma [T/K, P] (config t uses row
// t / K); robot [6*dof + 12] and spheres [P, 5]; table: the base grid
// (K1_PACKED: its packed words [ncells, 2]; otherwise its values [ncells] in
// S); lik [T]; dlik [T, dof], not written when grad is false; h2 [P, T], the
// squared hinge per sphere and config, written only when not null (and then
// grad must be true); ex: the scene's other sources, looked up in the same
// mode. Every pointer but table and ex's cells is of S. dof is 6 or 7.
template <class S>
struct K1Args {
  const S* q;
  const S* sigma;
  const S* robot;
  const S* spheres;
  const void* table;
  SceneExtras ex;
  S* lik;
  S* dlik;
  S* h2;
  int64_t T, K;
  int P, dof;
  bool craig, grad;
  GridArgs<S> g;
  S eps;
};
template <class S, int MODE>
cudaError_t k1_loglik_launch(const K1Args<S>& a, cudaStream_t stream);

// K1's d/dsigma from the forward's h2 [P, T] and the upstream gradient g [T]:
// out [T/K, P], out[r, p] = 1/2 sum over row r's K configs t of g[t] h2[p, t]
// / sigma[r, p]^2.
template <class S>
cudaError_t k1_dsigma_launch(const S* g, const S* h2, const S* sigma, S* out, int64_t T,
                             int64_t K, int P, cudaStream_t stream);

// K2 (k2_linalg.cuh), float or double, any n >= 1: a warp's rows for n <=
// K2_WARP_MAX_N, a block a matrix in shared memory up to K2_BLOCK_MAX_N (what
// a block's shared memory holds in float64), and above it a block a matrix
// whose lower tiles live in device memory: the factorisation, the pair and
// its backward take them in `scratch`, T * k2_scratch_values(entry, n) values
// of S (null where that is 0); the lone solve reads L's tiles in place. A, L
// [T, n, n]; B, X [T, n, k]. Offsets within the tensors are 64-bit.
constexpr int K2_WARP_MAX_N = 32, K2_BLOCK_MAX_N = 128;
enum K2Entry : int { K2_CHOL = 0, K2_TRSM = 1, K2_PAIR = 2, K2_BWD = 3 };
// tools/k2_designs.py's shim tells this interface (with scratch) from the
// one before it by this macro
#define K2_TAKES_SCRATCH 1
template <class S>
int64_t k2_scratch_values(K2Entry entry, int n);
template <class S>
cudaError_t k2_chol_launch(const S* A, S* L, int64_t T, int n, S* scratch, cudaStream_t stream);
template <class S>
cudaError_t k2_trsm_launch(const S* L, const S* B, S* X, int64_t T, int n, int k, bool upper_t,
                           cudaStream_t stream);

// The fused pair: L = chol(K) and X = L^-1 B in one launch, and its backward
// in one launch: given dL and dX it writes dB = L^-T dX and dK, the gradient
// of the symmetric K folded onto the lower triangle (the factorisation reads
// only that triangle). K, L, gL, gK [T, n, n]; B, X, gX, gB [T, n, k].
template <class S>
cudaError_t k2_factor_solve_launch(const S* K, const S* B, S* L, S* X, int64_t T, int n, int k,
                                   S* scratch, cudaStream_t stream);
template <class S>
cudaError_t k2_factor_solve_bwd_launch(const S* L, const S* X, const S* gL, const S* gX, S* gK,
                                       S* gB, int64_t T, int n, int k, S* scratch,
                                       cudaStream_t stream);

// K3 (k3_clearance.cuh). q [T, dof]; robot and spheres as K1; sdf
// [nx, ny, nz] with every size >= 2 and fewer than 2^31 cells; ex: the
// scene's other sources (cells of S, fewer than 2^31 in all, each grid's
// sizes >= 2); out [T], the minimum over spheres of the trilinear clearance.
// Every pointer is of S. dof is 6 or 7.
template <class S>
cudaError_t k3_min_clearance_launch(const S* q, const S* robot, const S* spheres, const S* sdf,
                                    const SceneExtras& ex, S* out, int64_t T, int P, int dof,
                                    bool craig, GridArgs<S> g, cudaStream_t stream);

// The metric's floor compare, fused into K3's second entry. The n = B * G
// probes q are rows of B PD paths of G probes each; row b has the query
// endpoints q_s, q_g [B, dof], their penetration depths depth_s, depth_g [B]
// and visited [B]. Probe i of row b is violated when visited[b] and its
// clearance lies below the tapered floor; seg_count [B, T] (zeroed by the
// caller) gains one for each violated probe at seg_count[b, seg_idx[b, i]].
template <class S>
struct K3Probe {
  const S* q_s;
  const S* q_g;
  const S* depth_s;
  const S* depth_g;
  const bool* visited;
  const int64_t* seg_idx;  // [B, G]; an index outside [0, T) is not counted
  int32_t* seg_count;      // [B, T]
  int64_t G, T;
  S inv_radius;            // 1 / taper radius, rounded to S
  S slack;
};
template <class S>
cudaError_t k3_probe_clearance_launch(const S* q, const S* robot, const S* spheres, const S* sdf,
                                      const SceneExtras& ex, S* out, int64_t n, int P, int dof,
                                      bool craig, GridArgs<S> g, const K3Probe<S>& probe,
                                      cudaStream_t stream);

// K4 (k4_gather.cu). table [ncells] entries of entry_bytes (4 or 8, aligned
// to that); idx [n] int32, clamped to the table; out [n] entries.
cudaError_t k4_gather_launch(const void* table, const int32_t* idx, void* out, int64_t n,
                             int64_t ncells, int entry_bytes, cudaStream_t stream);

// K5 (k5_mesh_sdf.cuh): a triangle soup's signed-distance grid. Cell (ix,
// iy, iz) lies at origin + delta * (ix, iy, iz); out [nx, ny, nz] float32.
struct K5Grid {
  double ox, oy, oz;
  double delta;
  int nx, ny, nz;
};
// tri [T, 9] float64 (each triangle's vertices a, b, c), piece [T] int32,
// sorted so that each piece's triangles are one run; T >= 1, any count.
cudaError_t k5_mesh_sdf_launch(const double* tri, const int32_t* piece, int64_t T, K5Grid g,
                               float* out, cudaStream_t stream);

// K6 (k6_rff.cuh): the random-Fourier-feature prior at A points of each of
// the P = R * L problems (row r, latent l; p = r * L + l), float or double.
// x [P, A]; omega, phase [P, nb]; scale [P]; w [R, ns, L, nb]; flags [A]
// (nonzero: a derivative row, feature -omega sin) or null; out [R, ns, L, A].
// The backward takes g [R, ns, L, A] (the gradient of out) and writes d_omega
// [P, nb], d_scale [P] and, for the first n_dx points, d_x [P, n_dx] (null
// where n_dx is 0). P < 2^31.
template <class S>
struct K6Args {
  const S* x;
  const S* omega;
  const S* phase;
  const S* scale;
  const S* w;
  const uint8_t* flags;
  int64_t R;
  int L, A, nb, ns;
};
template <class S>
cudaError_t k6_rff_launch(const K6Args<S>& a, S* out, cudaStream_t stream);
template <class S>
cudaError_t k6_rff_bwd_launch(const K6Args<S>& a, const S* g, S* d_omega, S* d_scale, S* d_x,
                              int n_dx, cudaStream_t stream);
