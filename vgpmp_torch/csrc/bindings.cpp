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

// grid: base offset (3), origin (3), delta; shape: nx, ny, nz. h2: also
// return the squared hinges [P, T] (needs grad)
std::vector<at::Tensor> k1_loglik(const at::Tensor& q, const at::Tensor& sigma,
                                  const at::Tensor& robot, const at::Tensor& spheres,
                                  const at::Tensor& words, bool craig, bool grad, bool h2,
                                  std::vector<double> grid, std::vector<int64_t> shape,
                                  double eps) {
  const char* what = "k1_loglik";
  check(q, at::kFloat, 2, what, "q");
  check(sigma, at::kFloat, 2, what, "sigma");
  check(robot, at::kFloat, 1, what, "robot");
  check(spheres, at::kFloat, 2, what, "spheres");
  check(words, at::kInt, 2, what, "words");
  for (const auto* t : {&sigma, &robot, &spheres, &words}) same_device(q, *t, what);
  const int64_t T = q.size(0), dof = q.size(1), R = sigma.size(0), P = sigma.size(1);
  TORCH_CHECK_VALUE(dof == 6 || dof == 7, what, ": built for 6 or 7 joints, got ", dof);
  TORCH_CHECK_VALUE(robot.numel() == 6 * dof + 12, what, ": robot constants do not match ", dof,
                    " joints");
  TORCH_CHECK_VALUE(spheres.size(0) == P && spheres.size(1) == 5, what, ": spheres ",
                    shape_str(spheres), " do not match sigma ", shape_str(sigma));
  TORCH_CHECK_VALUE(R > 0 && T % R == 0, what, ": sigma ", shape_str(sigma), " does not match q ",
                    shape_str(q));
  TORCH_CHECK_VALUE(words.size(1) == 2, what, ": words must be [ncells, 2]");
  TORCH_CHECK_VALUE(grad || !h2, what, ": h2 is written only beside the gradient");
  TORCH_CHECK_VALUE(grid.size() == 7 && shape.size() == 3, what, ": grid needs 7 numbers and 3 sizes");
  TORCH_CHECK_VALUE(words.size(0) == shape[0] * shape[1] * shape[2], what,
                    ": words do not match the grid shape");
  const K1Grid g{(float)grid[0], (float)grid[1], (float)grid[2], (float)grid[3], (float)grid[4],
                 (float)grid[5], (float)grid[6], (int)shape[0], (int)shape[1], (int)shape[2]};
  const c10::cuda::CUDAGuard guard(q.device());
  auto lik = at::empty({T}, q.options());
  at::Tensor dlik, sq;
  if (grad) dlik = at::empty({T, dof}, q.options());
  if (h2) sq = at::empty({P, T}, q.options());
  C10_CUDA_CHECK(k1_loglik_launch(q.data_ptr<float>(), sigma.data_ptr<float>(),
                                  robot.data_ptr<float>(), spheres.data_ptr<float>(),
                                  words.data_ptr(), lik.data_ptr<float>(),
                                  grad ? dlik.data_ptr<float>() : nullptr,
                                  h2 ? sq.data_ptr<float>() : nullptr, T, T / R, (int)P,
                                  (int)dof, craig, grad, g, (float)eps,
                                  at::cuda::getCurrentCUDAStream()));
  return {lik, dlik, sq};
}

// g [T], h2 [P, T], sigma [R, P] with T a multiple of R -> dL/dsigma [R, P]
at::Tensor k1_dsigma(const at::Tensor& g, const at::Tensor& h2, const at::Tensor& sigma) {
  const char* what = "k1_dsigma";
  check(g, at::kFloat, 1, what, "g");
  check(h2, at::kFloat, 2, what, "h2");
  check(sigma, at::kFloat, 2, what, "sigma");
  same_device(g, h2, what);
  same_device(g, sigma, what);
  const int64_t T = g.size(0), R = sigma.size(0), P = sigma.size(1);
  TORCH_CHECK_VALUE(h2.size(0) == P && h2.size(1) == T, what, ": h2 ", shape_str(h2),
                    " is not [P, T] for g ", shape_str(g), " and sigma ", shape_str(sigma));
  TORCH_CHECK_VALUE(R > 0 && T % R == 0 && R < (int64_t(1) << 31), what, ": sigma ",
                    shape_str(sigma), " does not match g ", shape_str(g));
  const c10::cuda::CUDAGuard guard(g.device());
  auto out = at::empty({R, P}, sigma.options());
  C10_CUDA_CHECK(k1_dsigma_launch(g.data_ptr<float>(), h2.data_ptr<float>(),
                                  sigma.data_ptr<float>(), out.data_ptr<float>(), T, T / R,
                                  (int)P, at::cuda::getCurrentCUDAStream()));
  return out;
}

int64_t square_n(const at::Tensor& L, const char* what) {
  const int64_t n = L.size(1);
  TORCH_CHECK_VALUE(L.size(2) == n && n >= 1 && n <= 32, what, ": needs square n <= 32, got ",
                    shape_str(L));
  return n;
}

at::Tensor k2_chol(const at::Tensor& K) {
  check(K, at::kDouble, 3, "k2_chol", "K");
  const int64_t n = square_n(K, "k2_chol");
  const c10::cuda::CUDAGuard guard(K.device());
  auto L = at::empty_like(K);
  C10_CUDA_CHECK(k2_chol_launch(K.data_ptr<double>(), L.data_ptr<double>(), K.size(0), (int)n,
                                at::cuda::getCurrentCUDAStream()));
  return L;
}

at::Tensor k2_trsm(const at::Tensor& L, const at::Tensor& B, bool upper_t) {
  check(L, at::kDouble, 3, "k2_trsm", "L");
  check(B, at::kDouble, 3, "k2_trsm", "B");
  same_device(L, B, "k2_trsm");
  const int64_t n = square_n(L, "k2_trsm");
  TORCH_CHECK_VALUE(B.size(0) == L.size(0) && B.size(1) == n && B.size(2) >= 1,
                    "k2_trsm: B ", shape_str(B), " does not match L ", shape_str(L));
  const c10::cuda::CUDAGuard guard(L.device());
  auto X = at::empty_like(B);
  C10_CUDA_CHECK(k2_trsm_launch(L.data_ptr<double>(), B.data_ptr<double>(), X.data_ptr<double>(),
                                L.size(0), (int)n, (int)B.size(2), upper_t,
                                at::cuda::getCurrentCUDAStream()));
  return X;
}

// K [T, n, n], B [T, n, k] -> (L = chol(K), X = L^-1 B), one launch
std::vector<at::Tensor> k2_factor_solve(const at::Tensor& K, const at::Tensor& B) {
  const char* what = "k2_factor_solve";
  check(K, at::kDouble, 3, what, "K");
  check(B, at::kDouble, 3, what, "B");
  same_device(K, B, what);
  const int64_t n = square_n(K, what);
  TORCH_CHECK_VALUE(B.size(0) == K.size(0) && B.size(1) == n && B.size(2) >= 1, what, ": B ",
                    shape_str(B), " does not match K ", shape_str(K));
  const c10::cuda::CUDAGuard guard(K.device());
  auto L = at::empty_like(K);
  auto X = at::empty_like(B);
  C10_CUDA_CHECK(k2_factor_solve_launch(K.data_ptr<double>(), B.data_ptr<double>(),
                                        L.data_ptr<double>(), X.data_ptr<double>(), K.size(0),
                                        (int)n, (int)B.size(2), at::cuda::getCurrentCUDAStream()));
  return {L, X};
}

// the pair's backward: (L, X, dL, dX) -> (dK folded onto the lower triangle, dB)
std::vector<at::Tensor> k2_factor_solve_bwd(const at::Tensor& L, const at::Tensor& X,
                                            const at::Tensor& gL, const at::Tensor& gX) {
  const char* what = "k2_factor_solve_bwd";
  check(L, at::kDouble, 3, what, "L");
  check(X, at::kDouble, 3, what, "X");
  check(gL, at::kDouble, 3, what, "gL");
  check(gX, at::kDouble, 3, what, "gX");
  for (const auto* t : {&X, &gL, &gX}) same_device(L, *t, what);
  const int64_t n = square_n(L, what);
  TORCH_CHECK_VALUE(X.size(0) == L.size(0) && X.size(1) == n && X.size(2) >= 1, what, ": X ",
                    shape_str(X), " does not match L ", shape_str(L));
  TORCH_CHECK_VALUE(gL.sizes() == L.sizes() && gX.sizes() == X.sizes(), what, ": gradients ",
                    shape_str(gL), " and ", shape_str(gX), " do not match L ", shape_str(L),
                    " and X ", shape_str(X));
  const c10::cuda::CUDAGuard guard(L.device());
  auto gK = at::empty_like(L);
  auto gB = at::empty_like(X);
  C10_CUDA_CHECK(k2_factor_solve_bwd_launch(
      L.data_ptr<double>(), X.data_ptr<double>(), gL.data_ptr<double>(), gX.data_ptr<double>(),
      gK.data_ptr<double>(), gB.data_ptr<double>(), L.size(0), (int)n, (int)X.size(2),
      at::cuda::getCurrentCUDAStream()));
  return {gK, gB};
}

// K3's common checks of the configs q [n, dof], the robot and sphere tables
// and the float32 grid; grid: base offset (3), origin (3), delta, and sdf
// carries the shape
K1Grid k3_checks(const at::Tensor& q, const at::Tensor& robot, const at::Tensor& spheres,
                 const at::Tensor& sdf, const std::vector<double>& grid, const char* what) {
  check(q, at::kFloat, 2, what, "q");
  check(robot, at::kFloat, 1, what, "robot");
  check(spheres, at::kFloat, 2, what, "spheres");
  check(sdf, at::kFloat, 3, what, "sdf");
  for (const auto* t : {&robot, &spheres, &sdf}) same_device(q, *t, what);
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
  return K1Grid{(float)grid[0], (float)grid[1], (float)grid[2], (float)grid[3], (float)grid[4],
                (float)grid[5], (float)grid[6], (int)sdf.size(0), (int)sdf.size(1),
                (int)sdf.size(2)};
}

at::Tensor k3_min_clearance(const at::Tensor& q, const at::Tensor& robot,
                            const at::Tensor& spheres, const at::Tensor& sdf, bool craig,
                            std::vector<double> grid) {
  const K1Grid g = k3_checks(q, robot, spheres, sdf, grid, "k3_min_clearance");
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = at::empty({q.size(0)}, q.options());
  C10_CUDA_CHECK(k3_min_clearance_launch(q.data_ptr<float>(), robot.data_ptr<float>(),
                                         spheres.data_ptr<float>(), sdf.data_ptr<float>(),
                                         out.data_ptr<float>(), q.size(0), (int)spheres.size(0),
                                         (int)q.size(1), craig, g,
                                         at::cuda::getCurrentCUDAStream()));
  return out;
}

// qs [B*G, dof] probes; q_s, q_g [B, dof]; depth_s, depth_g [B]; visited [B]
// bool; seg_idx [B, G] int64 -> (clear [B*G], seg_count [B, T] int32)
std::vector<at::Tensor> k3_probe_clearance(const at::Tensor& qs, const at::Tensor& robot,
                                           const at::Tensor& spheres, const at::Tensor& sdf,
                                           bool craig, std::vector<double> grid,
                                           const at::Tensor& q_s, const at::Tensor& q_g,
                                           const at::Tensor& depth_s, const at::Tensor& depth_g,
                                           const at::Tensor& visited, const at::Tensor& seg_idx,
                                           int64_t T, double radius, double slack) {
  const char* what = "k3_probe_clearance";
  const K1Grid g = k3_checks(qs, robot, spheres, sdf, grid, what);
  check(q_s, at::kFloat, 2, what, "q_s");
  check(q_g, at::kFloat, 2, what, "q_g");
  check(depth_s, at::kFloat, 1, what, "depth_s");
  check(depth_g, at::kFloat, 1, what, "depth_g");
  check(visited, at::kBool, 1, what, "visited");
  check(seg_idx, at::kLong, 2, what, "seg_idx");
  for (const auto* t : {&q_s, &q_g, &depth_s, &depth_g, &visited, &seg_idx})
    same_device(qs, *t, what);
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
  // the division by the radius as PyTorch's CUDA division by a scalar takes
  // it: a multiply by the float32 reciprocal of the float32 radius
  const K3Probe probe{q_s.data_ptr<float>(), q_g.data_ptr<float>(), depth_s.data_ptr<float>(),
                      depth_g.data_ptr<float>(), visited.data_ptr<bool>(),
                      seg_idx.data_ptr<int64_t>(), count.data_ptr<int32_t>(), G, T,
                      1.0f / (float)radius, (float)slack};
  C10_CUDA_CHECK(k3_probe_clearance_launch(qs.data_ptr<float>(), robot.data_ptr<float>(),
                                           spheres.data_ptr<float>(), sdf.data_ptr<float>(),
                                           clear.data_ptr<float>(), B * G, (int)spheres.size(0),
                                           (int)dof, craig, g, probe,
                                           at::cuda::getCurrentCUDAStream()));
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("k1_loglik", &k1_loglik,
        "K1: fused FK, packed-SDF gather and hinge; (lik, dlik/dq, squared hinges [P, T])");
  m.def("k1_dsigma", &k1_dsigma, "K1's d/dsigma: row sums of g * h^2 scaled by 1/2 / sigma^2");
  m.def("k2_chol", &k2_chol, "K2: batched float64 lower Cholesky");
  m.def("k2_trsm", &k2_trsm, "K2: batched float64 triangular solve, L X = B or L^T X = B");
  m.def("k2_factor_solve", &k2_factor_solve,
        "K2: float64 Cholesky and the forward substitution of B in one launch; (L, L^-1 B)");
  m.def("k2_factor_solve_bwd", &k2_factor_solve_bwd,
        "K2: backward of k2_factor_solve in one launch; (dK, dB)");
  m.def("k3_min_clearance", &k3_min_clearance,
        "K3: fused FK and trilinear SDF lookup; minimum clearance over spheres per config");
  m.def("k3_probe_clearance", &k3_probe_clearance,
        "K3 with the metric's tapered-floor compare and per-segment count; (clear, seg_count)");
  m.def("k4_gather", &k4_gather, "K4: out[i] = table[idx[i]] for 4-byte or 8-byte entries");
}
