// PyTorch binding of the port's CUDA kernels: checks each tensor's device,
// dtype, shape and contiguity, launches on the current stream and raises on a
// launch error. The only source here that includes PyTorch's headers.

#include <torch/extension.h>

#include <cstdint>
#include <string>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

// A tensor's shape for an error message. Written out by hand: streaming
// x.sizes() into a TORCH_CHECK message has crashed the process on the build
// this extension was tested with.
std::string shape_str(const at::Tensor& x) {
  std::string s = "[";
  for (int64_t i = 0; i < x.dim(); ++i) s += (i ? ", " : "") + std::to_string(x.size(i));
  return s + "]";
}

void check(const at::Tensor& x, at::ScalarType dtype, int64_t ndim, const char* what,
           const char* name) {
  TORCH_CHECK_VALUE(x.is_cuda(), what, ": ", name, " must be a CUDA tensor");
  TORCH_CHECK_TYPE(x.scalar_type() == dtype, what, ": ", name, " must be ", dtype, ", got ",
                   x.scalar_type());
  TORCH_CHECK_VALUE(x.is_contiguous(), what, ": ", name, " must be contiguous");
  TORCH_CHECK_VALUE(x.dim() == ndim, what, ": ", name, " must have ", ndim, " dims, got ",
                    shape_str(x));
}

void same_device(const at::Tensor& a, const at::Tensor& b, const char* what) {
  TORCH_CHECK_VALUE(a.device() == b.device(), what, ": tensors on ", a.device(), " and ",
                    b.device());
}

// float or double: the scalar type every tensor of a K1 or K3 call shares with
// q (the bindings' float and double entries)
void check_scalar(const at::Tensor& q, const char* what) {
  TORCH_CHECK_TYPE(q.scalar_type() == at::kFloat || q.scalar_type() == at::kDouble, what,
                   ": q must be float32 or float64, got ", q.scalar_type());
}

// The most values a scene's extras may take in a block's shared memory
// (4 096: the room K1's and K3's float32 tiles leave under 48 KB). The
// composed K3 keeps 8 more a primitive beside them (k3_clearance.cuh:
// PRIM_BOUND), so a scene near the limit takes it above 48 KB: launch_smem
// opts in to more, and the SM holds fewer of its blocks
constexpr int64_t EXTRAS_FLOATS = 4096;

// The checks of a scene's extras (kernels.h:SceneExtras): grid_f [G, 7] and
// prims [4 Ks + 15 Kb + 7 Kc] of the session's type S (ref's), grid_i [G, 4]
// int32, cells [n, 2] int32 (packed: K1 in packed mode) or [n] of S (K1's
// other modes, K3), counts (Ks, Kb, Kc). Each grid's shape and first cell
// live on the device and are not read here: the caller
// (likelihoods/collision.py:SceneTables) builds them and checks them against
// cells.
SceneExtras extras_checks(const at::Tensor& ref, const at::Tensor& grid_f,
                          const at::Tensor& grid_i, const at::Tensor& cells, bool packed,
                          const at::Tensor& prims, const std::vector<int64_t>& counts,
                          const char* what) {
  const at::ScalarType st = ref.scalar_type();
  check(grid_f, st, 2, what, "grid_f");
  check(grid_i, at::kInt, 2, what, "grid_i");
  check(cells, packed ? at::kInt : st, packed ? 2 : 1, what, "cells");
  check(prims, st, 1, what, "prims");
  same_device(ref, grid_f, what);
  same_device(ref, grid_i, what);
  same_device(ref, cells, what);
  same_device(ref, prims, what);
  const int64_t G = grid_f.size(0);
  TORCH_CHECK_VALUE(grid_f.size(1) == SCENE_GRID_F && grid_i.size(0) == G &&
                        grid_i.size(1) == SCENE_GRID_I,
                    what, ": grid_f ", shape_str(grid_f), " and grid_i ", shape_str(grid_i),
                    " are not [G, 7] and [G, 4]");
  TORCH_CHECK_VALUE(!packed || cells.size(1) == 2, what, ": packed cells must be [n, 2], got ",
                    shape_str(cells));
  TORCH_CHECK_VALUE(cells.size(0) < (int64_t(1) << 31), what,
                    ": the extra grids must have fewer than 2^31 cells, got ", shape_str(cells));
  TORCH_CHECK_VALUE(G == 0 || cells.size(0) > 0, what, ": extra grids without cells");
  TORCH_CHECK_VALUE(counts.size() == 3 && counts[0] >= 0 && counts[1] >= 0 && counts[2] >= 0,
                    what, ": counts must be 3 sizes (spheres, boxes, capsules)");
  const int64_t np = counts[0] * SCENE_SPHERE + counts[1] * SCENE_BOX + counts[2] * SCENE_CAPSULE;
  TORCH_CHECK_VALUE(prims.numel() == np, what, ": prims has ", prims.numel(),
                    " values, the counts need ", np);
  TORCH_CHECK_VALUE(G * (SCENE_GRID_F + SCENE_GRID_I) + np <= EXTRAS_FLOATS, what,
                    ": the extras need ", G * (SCENE_GRID_F + SCENE_GRID_I) + np,
                    " values of shared memory, more than ", EXTRAS_FLOATS);
  return SceneExtras{grid_f.data_ptr(), grid_i.data_ptr<int32_t>(), cells.data_ptr(),
                     prims.data_ptr(), (int)G, (int)counts[0], (int)counts[1], (int)counts[2]};
}

template <class S>
GridArgs<S> grid_args(const std::vector<double>& grid, int64_t nx, int64_t ny, int64_t nz) {
  return GridArgs<S>{(S)grid[0], (S)grid[1], (S)grid[2], (S)grid[3], (S)grid[4], (S)grid[5],
                     (S)grid[6], (int)nx, (int)ny, (int)nz};
}

template <class S>
cudaError_t k1_launch_mode(int64_t mode, const K1Args<S>& a, cudaStream_t st) {
  if (mode == K1_PACKED) return k1_loglik_launch<S, K1_PACKED>(a, st);
  if (mode == K1_NEAREST) return k1_loglik_launch<S, K1_NEAREST>(a, st);
  return k1_loglik_launch<S, K1_TRILINEAR>(a, st);
}

template <class S>
std::vector<at::Tensor> k1_run(const at::Tensor& q, const at::Tensor& sigma,
                               const at::Tensor& robot, const at::Tensor& spheres,
                               const at::Tensor& table, int64_t mode, const SceneExtras& ex,
                               bool craig, bool grad, bool h2, const GridArgs<S>& g, double eps) {
  const int64_t T = q.size(0), dof = q.size(1), R = sigma.size(0), P = sigma.size(1);
  auto lik = at::empty({T}, q.options());
  at::Tensor dlik, sq;
  if (grad) dlik = at::empty({T, dof}, q.options());
  if (h2) sq = at::empty({P, T}, q.options());
  const K1Args<S> a{q.data_ptr<S>(), sigma.data_ptr<S>(), robot.data_ptr<S>(),
                    spheres.data_ptr<S>(), table.data_ptr(), ex, lik.data_ptr<S>(),
                    grad ? dlik.data_ptr<S>() : nullptr, h2 ? sq.data_ptr<S>() : nullptr, T, T / R,
                    (int)P, (int)dof, craig, grad, g, (S)eps};
  C10_CUDA_CHECK(k1_launch_mode<S>(mode, a, at::cuda::getCurrentCUDAStream()));
  return {lik, dlik, sq};
}

// mode: K1_PACKED (table: the packed words [ncells, 2] int32), K1_NEAREST or
// K1_TRILINEAR (table: the grid [nx, ny, nz] of q's type). q and every other
// floating tensor share one type, float32 or float64. grid: base offset (3),
// origin (3), delta; shape: nx, ny, nz. h2: also return the squared hinges
// [P, T] (needs grad). grid_f, grid_i, ext_cells, prims, counts: the scene's
// extras in the same mode (extras_checks), all empty for the base grid alone
std::vector<at::Tensor> k1_loglik(const at::Tensor& q, const at::Tensor& sigma,
                                  const at::Tensor& robot, const at::Tensor& spheres,
                                  const at::Tensor& table, int64_t mode, bool craig, bool grad,
                                  bool h2, std::vector<double> grid, std::vector<int64_t> shape,
                                  double eps, const at::Tensor& grid_f, const at::Tensor& grid_i,
                                  const at::Tensor& ext_cells, const at::Tensor& prims,
                                  std::vector<int64_t> counts) {
  const char* what = "k1_loglik";
  check_scalar(q, what);
  const at::ScalarType st = q.scalar_type();
  const bool packed = mode == K1_PACKED;
  TORCH_CHECK_VALUE(mode == K1_PACKED || mode == K1_NEAREST || mode == K1_TRILINEAR, what,
                    ": mode must be 0 (packed), 1 (nearest) or 2 (trilinear), got ", mode);
  check(q, st, 2, what, "q");
  check(sigma, st, 2, what, "sigma");
  check(robot, st, 1, what, "robot");
  check(spheres, st, 2, what, "spheres");
  check(table, packed ? at::kInt : st, packed ? 2 : 3, what, "table");
  same_device(q, sigma, what);
  same_device(q, robot, what);
  same_device(q, spheres, what);
  same_device(q, table, what);
  const SceneExtras ex = extras_checks(q, grid_f, grid_i, ext_cells, packed, prims, counts, what);
  const int64_t T = q.size(0), dof = q.size(1), R = sigma.size(0), P = sigma.size(1);
  TORCH_CHECK_VALUE(dof == 6 || dof == 7, what, ": built for 6 or 7 joints, got ", dof);
  TORCH_CHECK_VALUE(robot.numel() == 6 * dof + 12, what, ": robot constants do not match ", dof,
                    " joints");
  TORCH_CHECK_VALUE(spheres.size(0) == P && spheres.size(1) == 5, what, ": spheres ",
                    shape_str(spheres), " do not match sigma ", shape_str(sigma));
  TORCH_CHECK_VALUE(R > 0 && T % R == 0, what, ": sigma ", shape_str(sigma), " does not match q ",
                    shape_str(q));
  TORCH_CHECK_VALUE(!packed || table.size(1) == 2, what, ": words must be [ncells, 2]");
  TORCH_CHECK_VALUE(grad || !h2, what, ": h2 is written only beside the gradient");
  TORCH_CHECK_VALUE(grid.size() == 7 && shape.size() == 3, what, ": grid needs 7 numbers and 3 sizes");
  const int64_t ncells = shape[0] * shape[1] * shape[2];
  TORCH_CHECK_VALUE((packed ? table.size(0) : table.numel()) == ncells, what,
                    ": the table does not match the grid shape");
  TORCH_CHECK_VALUE(packed || (shape[0] >= 2 && shape[1] >= 2 && shape[2] >= 2 &&
                               ncells < (int64_t(1) << 31)),
                    what, ": the grid needs at least 2 cells along each axis and fewer than 2^31 ",
                    "in all");
  const c10::cuda::CUDAGuard guard(q.device());
  if (st == at::kDouble)
    return k1_run<double>(q, sigma, robot, spheres, table, mode, ex, craig, grad, h2,
                          grid_args<double>(grid, shape[0], shape[1], shape[2]), eps);
  return k1_run<float>(q, sigma, robot, spheres, table, mode, ex, craig, grad, h2,
                       grid_args<float>(grid, shape[0], shape[1], shape[2]), eps);
}

// g [T], h2 [P, T], sigma [R, P] with T a multiple of R, float32 or float64 ->
// dL/dsigma [R, P]
at::Tensor k1_dsigma(const at::Tensor& g, const at::Tensor& h2, const at::Tensor& sigma) {
  const char* what = "k1_dsigma";
  check_scalar(g, what);
  const at::ScalarType st = g.scalar_type();
  check(g, st, 1, what, "g");
  check(h2, st, 2, what, "h2");
  check(sigma, st, 2, what, "sigma");
  same_device(g, h2, what);
  same_device(g, sigma, what);
  const int64_t T = g.size(0), R = sigma.size(0), P = sigma.size(1);
  TORCH_CHECK_VALUE(h2.size(0) == P && h2.size(1) == T, what, ": h2 ", shape_str(h2),
                    " is not [P, T] for g ", shape_str(g), " and sigma ", shape_str(sigma));
  TORCH_CHECK_VALUE(R > 0 && T % R == 0 && R < (int64_t(1) << 31), what, ": sigma ",
                    shape_str(sigma), " does not match g ", shape_str(g));
  const c10::cuda::CUDAGuard guard(g.device());
  auto out = at::empty({R, P}, sigma.options());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  if (st == at::kDouble)
    C10_CUDA_CHECK(k1_dsigma_launch<double>(g.data_ptr<double>(), h2.data_ptr<double>(),
                                            sigma.data_ptr<double>(), out.data_ptr<double>(), T,
                                            T / R, (int)P, stream));
  else
    C10_CUDA_CHECK(k1_dsigma_launch<float>(g.data_ptr<float>(), h2.data_ptr<float>(),
                                           sigma.data_ptr<float>(), out.data_ptr<float>(), T,
                                           T / R, (int)P, stream));
  return out;
}

// K2's matrices: float32 or float64, square, 1 <= n < 2^31 (any n the
// device memory holds: above K2_BLOCK_MAX_N the streamed design), fewer than
// 2^31 of them (a grid's first dimension)
int64_t square_n(const at::Tensor& L, const char* what) {
  TORCH_CHECK_TYPE(L.scalar_type() == at::kFloat || L.scalar_type() == at::kDouble, what,
                   ": takes float32 or float64, got ", L.scalar_type());
  check(L, L.scalar_type(), 3, what, "the matrices");
  const int64_t n = L.size(1);
  TORCH_CHECK_VALUE(L.size(2) == n && n >= 1 && n <= INT32_MAX && L.size(0) <= INT32_MAX, what,
                    ": needs square matrices, fewer than 2^31 of them, got ", shape_str(L));
  return n;
}

// the right-hand sides' columns k: at least one, and few enough that a lone
// solve's grid of 128-column tiles fits a grid's second dimension
void check_k(const at::Tensor& B, const char* what) {
  TORCH_CHECK_VALUE(B.size(2) >= 1 && B.size(2) <= 65535LL * 128, what,
                    ": needs 1 to 65535 x 128 columns, got ", shape_str(B));
}

// the streamed design's scratch for T matrices of an entry (an undefined
// tensor where it takes none)
template <class S>
at::Tensor k2_scratch(const at::Tensor& like, K2Entry entry) {
  const int64_t per = k2_scratch_values<S>(entry, (int)like.size(1));
  if (per == 0) return at::Tensor();
  TORCH_CHECK_VALUE(like.size(0) <= INT64_MAX / per, "K2: the scratch of ", shape_str(like),
                    " overflows 64 bits");
  return at::empty({like.size(0) * per}, like.options());
}
template <class S>
S* ptr_or_null(const at::Tensor& t) {
  return t.defined() ? t.data_ptr<S>() : nullptr;
}

template <class S>
void chol_run(const at::Tensor& K, at::Tensor& L) {
  const auto w = k2_scratch<S>(K, K2_CHOL);
  C10_CUDA_CHECK(k2_chol_launch<S>(K.data_ptr<S>(), L.data_ptr<S>(), K.size(0), (int)K.size(1),
                                   ptr_or_null<S>(w), at::cuda::getCurrentCUDAStream()));
}

at::Tensor k2_chol(const at::Tensor& K) {
  square_n(K, "k2_chol");
  const c10::cuda::CUDAGuard guard(K.device());
  auto L = at::empty_like(K);
  if (K.scalar_type() == at::kDouble)
    chol_run<double>(K, L);
  else
    chol_run<float>(K, L);
  return L;
}

template <class S>
void trsm_run(const at::Tensor& L, const at::Tensor& B, at::Tensor& X, bool upper_t) {
  C10_CUDA_CHECK(k2_trsm_launch<S>(L.data_ptr<S>(), B.data_ptr<S>(), X.data_ptr<S>(), L.size(0),
                                   (int)L.size(1), (int)B.size(2), upper_t,
                                   at::cuda::getCurrentCUDAStream()));
}

at::Tensor k2_trsm(const at::Tensor& L, const at::Tensor& B, bool upper_t) {
  const int64_t n = square_n(L, "k2_trsm");
  check(B, L.scalar_type(), 3, "k2_trsm", "B");
  same_device(L, B, "k2_trsm");
  TORCH_CHECK_VALUE(B.size(0) == L.size(0) && B.size(1) == n && B.size(2) >= 1,
                    "k2_trsm: B ", shape_str(B), " does not match L ", shape_str(L));
  check_k(B, "k2_trsm");
  const c10::cuda::CUDAGuard guard(L.device());
  auto X = at::empty_like(B);
  if (L.scalar_type() == at::kDouble)
    trsm_run<double>(L, B, X, upper_t);
  else
    trsm_run<float>(L, B, X, upper_t);
  return X;
}

template <class S>
void factor_solve_run(const at::Tensor& K, const at::Tensor& B, at::Tensor& L, at::Tensor& X) {
  const auto w = k2_scratch<S>(K, K2_PAIR);
  C10_CUDA_CHECK(k2_factor_solve_launch<S>(K.data_ptr<S>(), B.data_ptr<S>(), L.data_ptr<S>(),
                                           X.data_ptr<S>(), K.size(0), (int)K.size(1),
                                           (int)B.size(2), ptr_or_null<S>(w),
                                           at::cuda::getCurrentCUDAStream()));
}

// K [T, n, n], B [T, n, k] -> (L = chol(K), X = L^-1 B), one launch
std::vector<at::Tensor> k2_factor_solve(const at::Tensor& K, const at::Tensor& B) {
  const char* what = "k2_factor_solve";
  const int64_t n = square_n(K, what);
  check(B, K.scalar_type(), 3, what, "B");
  same_device(K, B, what);
  TORCH_CHECK_VALUE(B.size(0) == K.size(0) && B.size(1) == n && B.size(2) >= 1, what, ": B ",
                    shape_str(B), " does not match K ", shape_str(K));
  check_k(B, what);
  const c10::cuda::CUDAGuard guard(K.device());
  auto L = at::empty_like(K);
  auto X = at::empty_like(B);
  if (K.scalar_type() == at::kDouble)
    factor_solve_run<double>(K, B, L, X);
  else
    factor_solve_run<float>(K, B, L, X);
  return {L, X};
}

template <class S>
void factor_solve_bwd_run(const at::Tensor& L, const at::Tensor& X, const at::Tensor& gL,
                          const at::Tensor& gX, at::Tensor& gK, at::Tensor& gB) {
  const auto w = k2_scratch<S>(L, K2_BWD);
  C10_CUDA_CHECK(k2_factor_solve_bwd_launch<S>(
      L.data_ptr<S>(), X.data_ptr<S>(), gL.data_ptr<S>(), gX.data_ptr<S>(), gK.data_ptr<S>(),
      gB.data_ptr<S>(), L.size(0), (int)L.size(1), (int)X.size(2), ptr_or_null<S>(w),
      at::cuda::getCurrentCUDAStream()));
}

// the pair's backward: (L, X, dL, dX) -> (dK folded onto the lower triangle, dB)
std::vector<at::Tensor> k2_factor_solve_bwd(const at::Tensor& L, const at::Tensor& X,
                                            const at::Tensor& gL, const at::Tensor& gX) {
  const char* what = "k2_factor_solve_bwd";
  const int64_t n = square_n(L, what);
  check(X, L.scalar_type(), 3, what, "X");
  check(gL, L.scalar_type(), 3, what, "gL");
  check(gX, L.scalar_type(), 3, what, "gX");
  same_device(L, X, what);
  same_device(L, gL, what);
  same_device(L, gX, what);
  TORCH_CHECK_VALUE(X.size(0) == L.size(0) && X.size(1) == n && X.size(2) >= 1, what, ": X ",
                    shape_str(X), " does not match L ", shape_str(L));
  TORCH_CHECK_VALUE(gL.sizes() == L.sizes() && gX.sizes() == X.sizes(), what, ": gradients ",
                    shape_str(gL), " and ", shape_str(gX), " do not match L ", shape_str(L),
                    " and X ", shape_str(X));
  check_k(X, what);
  const c10::cuda::CUDAGuard guard(L.device());
  auto gK = at::empty_like(L);
  auto gB = at::empty_like(X);
  if (L.scalar_type() == at::kDouble)
    factor_solve_bwd_run<double>(L, X, gL, gX, gK, gB);
  else
    factor_solve_bwd_run<float>(L, X, gL, gX, gK, gB);
  return {gK, gB};
}

// K3's common checks of the configs q [n, dof], the robot and sphere tables
// and the grid, all float32 or all float64; grid: base offset (3), origin
// (3), delta, and sdf carries the shape
void k3_checks(const at::Tensor& q, const at::Tensor& robot, const at::Tensor& spheres,
               const at::Tensor& sdf, const std::vector<double>& grid, const char* what) {
  check_scalar(q, what);
  const at::ScalarType st = q.scalar_type();
  check(q, st, 2, what, "q");
  check(robot, st, 1, what, "robot");
  check(spheres, st, 2, what, "spheres");
  check(sdf, st, 3, what, "sdf");
  same_device(q, robot, what);
  same_device(q, spheres, what);
  same_device(q, sdf, what);
  const int64_t dof = q.size(1);
  TORCH_CHECK_VALUE(dof == 6 || dof == 7, what, ": built for 6 or 7 joints, got ", dof);
  TORCH_CHECK_VALUE(robot.numel() == 6 * dof + 12, what, ": robot constants do not match ", dof,
                    " joints");
  TORCH_CHECK_VALUE(spheres.size(0) >= 1 && spheres.size(1) == 5, what,
                    ": spheres must be [P, 5], got ", shape_str(spheres));
  TORCH_CHECK_VALUE(sdf.size(0) >= 2 && sdf.size(1) >= 2 && sdf.size(2) >= 2, what,
                    ": the grid needs at least 2 cells along each axis, got ", shape_str(sdf));
  TORCH_CHECK_VALUE(sdf.numel() < (int64_t(1) << 31), what,
                    ": the grid must have fewer than 2^31 cells, got ", shape_str(sdf));
  TORCH_CHECK_VALUE(grid.size() == 7, what, ": grid needs 7 numbers");
}

template <class S>
void k3_min_run(const at::Tensor& q, const at::Tensor& robot, const at::Tensor& spheres,
                const at::Tensor& sdf, const SceneExtras& ex, at::Tensor& out, bool craig,
                const std::vector<double>& grid) {
  C10_CUDA_CHECK(k3_min_clearance_launch<S>(
      q.data_ptr<S>(), robot.data_ptr<S>(), spheres.data_ptr<S>(), sdf.data_ptr<S>(), ex,
      out.data_ptr<S>(), q.size(0), (int)spheres.size(0), (int)q.size(1), craig,
      grid_args<S>(grid, sdf.size(0), sdf.size(1), sdf.size(2)),
      at::cuda::getCurrentCUDAStream()));
}

// grid_f, grid_i, ext_data, prims, counts: the scene's extras (extras_checks)
at::Tensor k3_min_clearance(const at::Tensor& q, const at::Tensor& robot,
                            const at::Tensor& spheres, const at::Tensor& sdf, bool craig,
                            std::vector<double> grid, const at::Tensor& grid_f,
                            const at::Tensor& grid_i, const at::Tensor& ext_data,
                            const at::Tensor& prims, std::vector<int64_t> counts) {
  const char* what = "k3_min_clearance";
  k3_checks(q, robot, spheres, sdf, grid, what);
  const SceneExtras ex = extras_checks(q, grid_f, grid_i, ext_data, false, prims, counts, what);
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = at::empty({q.size(0)}, q.options());
  if (q.scalar_type() == at::kDouble)
    k3_min_run<double>(q, robot, spheres, sdf, ex, out, craig, grid);
  else
    k3_min_run<float>(q, robot, spheres, sdf, ex, out, craig, grid);
  return out;
}

template <class S>
void k3_probe_run(const at::Tensor& qs, const at::Tensor& robot, const at::Tensor& spheres,
                  const at::Tensor& sdf, const SceneExtras& ex, bool craig,
                  const std::vector<double>& grid, const at::Tensor& q_s, const at::Tensor& q_g,
                  const at::Tensor& depth_s, const at::Tensor& depth_g, const at::Tensor& visited,
                  const at::Tensor& seg_idx, int64_t T, double radius, double slack,
                  at::Tensor& clear, at::Tensor& count) {
  // the division by the radius as PyTorch's CUDA division by a scalar takes
  // it: a multiply by the reciprocal, in S, of the radius rounded to S
  const K3Probe<S> probe{q_s.data_ptr<S>(), q_g.data_ptr<S>(), depth_s.data_ptr<S>(),
                         depth_g.data_ptr<S>(), visited.data_ptr<bool>(),
                         seg_idx.data_ptr<int64_t>(), count.data_ptr<int32_t>(), seg_idx.size(1),
                         T, S(1) / (S)radius, (S)slack};
  C10_CUDA_CHECK(k3_probe_clearance_launch<S>(
      qs.data_ptr<S>(), robot.data_ptr<S>(), spheres.data_ptr<S>(), sdf.data_ptr<S>(), ex,
      clear.data_ptr<S>(), qs.size(0), (int)spheres.size(0), (int)qs.size(1), craig,
      grid_args<S>(grid, sdf.size(0), sdf.size(1), sdf.size(2)), probe,
      at::cuda::getCurrentCUDAStream()));
}

// qs [B*G, dof] probes; q_s, q_g [B, dof]; depth_s, depth_g [B] (all of qs's
// type); visited [B] bool; seg_idx [B, G] int64 -> (clear [B*G], seg_count
// [B, T] int32); grid_f, grid_i, ext_data, prims, counts: the scene's extras
// (extras_checks)
std::vector<at::Tensor> k3_probe_clearance(const at::Tensor& qs, const at::Tensor& robot,
                                           const at::Tensor& spheres, const at::Tensor& sdf,
                                           bool craig, std::vector<double> grid,
                                           const at::Tensor& q_s, const at::Tensor& q_g,
                                           const at::Tensor& depth_s, const at::Tensor& depth_g,
                                           const at::Tensor& visited, const at::Tensor& seg_idx,
                                           int64_t T, double radius, double slack,
                                           const at::Tensor& grid_f, const at::Tensor& grid_i,
                                           const at::Tensor& ext_data, const at::Tensor& prims,
                                           std::vector<int64_t> counts) {
  const char* what = "k3_probe_clearance";
  k3_checks(qs, robot, spheres, sdf, grid, what);
  const at::ScalarType st = qs.scalar_type();
  const SceneExtras ex = extras_checks(qs, grid_f, grid_i, ext_data, false, prims, counts, what);
  check(q_s, st, 2, what, "q_s");
  check(q_g, st, 2, what, "q_g");
  check(depth_s, st, 1, what, "depth_s");
  check(depth_g, st, 1, what, "depth_g");
  check(visited, at::kBool, 1, what, "visited");
  check(seg_idx, at::kLong, 2, what, "seg_idx");
  same_device(qs, q_s, what);
  same_device(qs, q_g, what);
  same_device(qs, depth_s, what);
  same_device(qs, depth_g, what);
  same_device(qs, visited, what);
  same_device(qs, seg_idx, what);
  const int64_t B = seg_idx.size(0), G = seg_idx.size(1), dof = qs.size(1);
  TORCH_CHECK_VALUE(B >= 1 && G >= 1 && qs.size(0) == B * G, what, ": qs ", shape_str(qs),
                    " does not hold the probes of seg_idx ", shape_str(seg_idx));
  TORCH_CHECK_VALUE(q_s.size(0) == B && q_s.size(1) == dof && q_g.size(0) == B &&
                        q_g.size(1) == dof,
                    what, ": the endpoints must be [B, dof], got ", shape_str(q_s), " and ",
                    shape_str(q_g));
  TORCH_CHECK_VALUE(depth_s.size(0) == B && depth_g.size(0) == B && visited.size(0) == B, what,
                    ": the depths and visited must be [B], got ", shape_str(depth_s), ", ",
                    shape_str(depth_g), " and ", shape_str(visited));
  TORCH_CHECK_VALUE(T >= 1, what, ": needs T >= 1 segments, got ", T);
  const c10::cuda::CUDAGuard guard(qs.device());
  auto clear = at::empty({B * G}, qs.options());
  auto count = at::zeros({B, T}, qs.options().dtype(at::kInt));
  if (st == at::kDouble)
    k3_probe_run<double>(qs, robot, spheres, sdf, ex, craig, grid, q_s, q_g, depth_s, depth_g,
                         visited, seg_idx, T, radius, slack, clear, count);
  else
    k3_probe_run<float>(qs, robot, spheres, sdf, ex, craig, grid, q_s, q_g, depth_s, depth_g,
                        visited, seg_idx, T, radius, slack, clear, count);
  return {clear, count};
}

// table [ncells] (4-byte entries) or [ncells, 2] (8-byte entries), int32;
// idx int32 of any shape -> idx's shape, plus the trailing 2 of a row table
at::Tensor k4_gather(const at::Tensor& table, const at::Tensor& idx) {
  const char* what = "k4_gather";
  TORCH_CHECK_VALUE(table.dim() == 1 || (table.dim() == 2 && table.size(1) == 2), what,
                    ": table must be [ncells] or [ncells, 2], got ", shape_str(table));
  check(table, at::kInt, table.dim(), what, "table");
  check(idx, at::kInt, idx.dim(), what, "idx");
  same_device(table, idx, what);
  TORCH_CHECK_VALUE(table.size(0) >= 1, what, ": empty table");
  const int entry_bytes = table.dim() == 2 ? 8 : 4;
  TORCH_CHECK_VALUE(reinterpret_cast<std::uintptr_t>(table.data_ptr()) % entry_bytes == 0, what,
                    ": table is not aligned to its ", entry_bytes, "-byte entries");
  auto sizes = idx.sizes().vec();
  if (entry_bytes == 8) sizes.push_back(2);
  const c10::cuda::CUDAGuard guard(table.device());
  auto out = at::empty(sizes, table.options());
  C10_CUDA_CHECK(k4_gather_launch(table.data_ptr(), idx.data_ptr<int32_t>(), out.data_ptr(),
                                  idx.numel(), table.size(0), entry_bytes,
                                  at::cuda::getCurrentCUDAStream()));
  return out;
}

// tri [T, 9] float64 (vertices a, b, c of each triangle, each piece's
// triangles one run), piece [T] int32; the grid's origin, voxel edge and
// shape -> [nx, ny, nz] float32 signed distances (the Python wrapper,
// sdf/gen.py:k5_mesh_sdf, sorts by piece and checks the shapes first)
at::Tensor k5_mesh_sdf(const at::Tensor& tri, const at::Tensor& piece, std::vector<double> origin,
                       double delta, std::vector<int64_t> dims) {
  const char* what = "k5_mesh_sdf";
  check(tri, at::kDouble, 2, what, "tri");
  check(piece, at::kInt, 1, what, "piece");
  same_device(tri, piece, what);
  const int64_t T = tri.size(0);
  TORCH_CHECK_VALUE(T >= 1 && tri.size(1) == 9 && piece.size(0) == T, what, ": tri ",
                    shape_str(tri), " and piece ", shape_str(piece), " are not [T, 9] and [T]");
  TORCH_CHECK_VALUE(origin.size() == 3 && dims.size() == 3, what,
                    ": origin and dims must have 3 entries");
  const int64_t nx = dims[0], ny = dims[1], nz = dims[2];
  TORCH_CHECK_VALUE(nx >= 1 && ny >= 1 && nz >= 1 && nx < (1LL << 31) && ny < (1LL << 31) &&
                        nz < (1LL << 31),
                    what, ": each of dims must lie in [1, 2^31)");
  const c10::cuda::CUDAGuard guard(tri.device());
  auto out = at::empty({nx, ny, nz}, tri.options().dtype(at::kFloat));
  const K5Grid g{origin[0], origin[1], origin[2], delta, (int)nx, (int)ny, (int)nz};
  C10_CUDA_CHECK(k5_mesh_sdf_launch(tri.data_ptr<double>(), piece.data_ptr<int32_t>(), T, g,
                                    out.data_ptr<float>(), at::cuda::getCurrentCUDAStream()));
  return out;
}

// K6's shapes (kernels.h:K6Args): x [P, A], omega and phase [P, nb], scale
// [P], w [R, ns, L, nb] with P = R * L, flags [A] uint8 or empty (no
// derivative rows), all but flags of x's type (the Python wrapper,
// ops/rff.py, flattens the leading axes)
template <class S>
K6Args<S> k6_args(const at::Tensor& x, const at::Tensor& omega, const at::Tensor& phase,
                  const at::Tensor& scale, const at::Tensor& w, const at::Tensor& flags,
                  const char* what) {
  const at::ScalarType st = x.scalar_type();
  check(x, st, 2, what, "x");
  check(omega, st, 2, what, "omega");
  check(phase, st, 2, what, "phase");
  check(scale, st, 1, what, "scale");
  check(w, st, 4, what, "w");
  for (const at::Tensor* t : {&omega, &phase, &scale, &w}) same_device(x, *t, what);
  const int64_t P = x.size(0), A = x.size(1), R = w.size(0), ns = w.size(1), L = w.size(2),
                nb = w.size(3);
  TORCH_CHECK_VALUE(P >= 1 && A >= 1 && nb >= 1 && ns >= 1 && R * L == P && omega.size(0) == P &&
                        omega.size(1) == nb && phase.sizes() == omega.sizes() &&
                        scale.size(0) == P,
                    what, ": x ", shape_str(x), ", omega ", shape_str(omega), ", phase ",
                    shape_str(phase), ", scale ", shape_str(scale), " and w ", shape_str(w),
                    " are not [R*L, A], [R*L, nb], [R*L, nb], [R*L] and [R, ns, L, nb]");
  TORCH_CHECK_VALUE(P < (1LL << 31) && A < (1LL << 31) && nb < (1LL << 31) && ns < (1LL << 31),
                    what, ": sizes must lie below 2^31");
  const uint8_t* fl = nullptr;
  if (flags.numel() > 0) {
    check(flags, at::kByte, 1, what, "flags");
    same_device(x, flags, what);
    TORCH_CHECK_VALUE(flags.size(0) == A, what, ": flags ", shape_str(flags), " is not [A] for x ",
                      shape_str(x));
    fl = flags.data_ptr<uint8_t>();
  }
  return K6Args<S>{x.data_ptr<S>(), omega.data_ptr<S>(), phase.data_ptr<S>(), scale.data_ptr<S>(),
                   w.data_ptr<S>(), fl, R, (int)L, (int)A, (int)nb, (int)ns};
}

// -> out [R, ns, L, A]
at::Tensor k6_rff(const at::Tensor& x, const at::Tensor& omega, const at::Tensor& phase,
                  const at::Tensor& scale, const at::Tensor& w, const at::Tensor& flags) {
  const char* what = "k6_rff";
  check_scalar(x, what);
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = at::empty({w.size(0), w.size(1), w.size(2), x.size(1)}, x.options());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  if (x.scalar_type() == at::kDouble)
    C10_CUDA_CHECK(k6_rff_launch<double>(k6_args<double>(x, omega, phase, scale, w, flags, what),
                                         out.data_ptr<double>(), st));
  else
    C10_CUDA_CHECK(k6_rff_launch<float>(k6_args<float>(x, omega, phase, scale, w, flags, what),
                                        out.data_ptr<float>(), st));
  return out;
}

// g [R, ns, L, A], the gradient of out -> (d_omega [P, nb], d_scale [P], d_x
// [P, n_dx]: the gradient of the first n_dx points)
std::vector<at::Tensor> k6_rff_bwd(const at::Tensor& g, const at::Tensor& x,
                                   const at::Tensor& omega, const at::Tensor& phase,
                                   const at::Tensor& scale, const at::Tensor& w,
                                   const at::Tensor& flags, int64_t n_dx) {
  const char* what = "k6_rff_bwd";
  check_scalar(x, what);
  check(g, x.scalar_type(), 4, what, "g");
  same_device(x, g, what);
  TORCH_CHECK_VALUE(g.size(0) == w.size(0) && g.size(1) == w.size(1) && g.size(2) == w.size(2) &&
                        g.size(3) == x.size(1),
                    what, ": g ", shape_str(g), " is not [R, ns, L, A] for w ", shape_str(w),
                    " and x ", shape_str(x));
  TORCH_CHECK_VALUE(n_dx >= 0 && n_dx <= x.size(1), what, ": n_dx ", n_dx, " outside [0, A]");
  const c10::cuda::CUDAGuard guard(x.device());
  auto d_omega = at::empty_like(omega);
  auto d_scale = at::empty_like(scale);
  auto d_x = at::empty({x.size(0), n_dx}, x.options());
  const cudaStream_t st = at::cuda::getCurrentCUDAStream();
  if (x.scalar_type() == at::kDouble)
    C10_CUDA_CHECK(k6_rff_bwd_launch<double>(
        k6_args<double>(x, omega, phase, scale, w, flags, what), g.data_ptr<double>(),
        d_omega.data_ptr<double>(), d_scale.data_ptr<double>(),
        n_dx ? d_x.data_ptr<double>() : nullptr, (int)n_dx, st));
  else
    C10_CUDA_CHECK(k6_rff_bwd_launch<float>(
        k6_args<float>(x, omega, phase, scale, w, flags, what), g.data_ptr<float>(),
        d_omega.data_ptr<float>(), d_scale.data_ptr<float>(),
        n_dx ? d_x.data_ptr<float>() : nullptr, (int)n_dx, st));
  return {d_omega, d_scale, d_x};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("k1_loglik", &k1_loglik,
        "K1: fused FK, SDF lookup (packed, nearest or trilinear) and hinge; (lik, dlik/dq, "
        "squared hinges [P, T])");
  m.def("k1_dsigma", &k1_dsigma, "K1's d/dsigma: row sums of g * h^2 scaled by 1/2 / sigma^2");
  m.def("k2_chol", &k2_chol, "K2: batched float32 or float64 lower Cholesky");
  m.def("k2_trsm", &k2_trsm, "K2: batched triangular solve, L X = B or L^T X = B");
  m.def("k2_factor_solve", &k2_factor_solve,
        "K2: Cholesky and the forward substitution of B in one launch; (L, L^-1 B)");
  m.def("k2_factor_solve_bwd", &k2_factor_solve_bwd,
        "K2: backward of k2_factor_solve in one launch; (dK, dB)");
  m.def("k3_min_clearance", &k3_min_clearance,
        "K3: fused FK and trilinear SDF lookup; minimum clearance over spheres per config "
        "(float32 or float64)");
  m.def("k3_probe_clearance", &k3_probe_clearance,
        "K3 with the metric's tapered-floor compare and per-segment count; (clear, seg_count)");
  m.def("k4_gather", &k4_gather, "K4: out[i] = table[idx[i]] for 4-byte or 8-byte entries");
  m.def("k5_mesh_sdf", &k5_mesh_sdf,
        "K5: a triangle soup's signed-distance grid (exact distance, per-piece ray parity)");
  m.def("k6_rff", &k6_rff, "K6: the random-Fourier-feature prior's paths at a set of points");
  m.def("k6_rff_bwd", &k6_rff_bwd, "K6's backward: d/domega, d/dscale and d/dx of the first points");
}
