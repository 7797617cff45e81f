// PyTorch binding of the port's CUDA kernels: checks each tensor's device,
// dtype, shape and contiguity, launches on the current stream and raises on a
// launch error. The only source here that includes PyTorch's headers.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

void check(const at::Tensor& x, at::ScalarType dtype, int64_t ndim, const char* what,
           const char* name) {
  TORCH_CHECK_VALUE(x.is_cuda(), what, ": ", name, " must be a CUDA tensor");
  TORCH_CHECK_TYPE(x.scalar_type() == dtype, what, ": ", name, " must be ", dtype, ", got ",
                   x.scalar_type());
  TORCH_CHECK_VALUE(x.is_contiguous(), what, ": ", name, " must be contiguous");
  TORCH_CHECK_VALUE(x.dim() == ndim, what, ": ", name, " must have ", ndim, " dims, got ",
                    x.sizes());
}

void same_device(const at::Tensor& a, const at::Tensor& b, const char* what) {
  TORCH_CHECK_VALUE(a.device() == b.device(), what, ": tensors on ", a.device(), " and ",
                    b.device());
}

// grid: base offset (3), origin (3), delta; shape: nx, ny, nz
std::vector<at::Tensor> k1_loglik(const at::Tensor& q, const at::Tensor& sigma,
                                  const at::Tensor& robot, const at::Tensor& spheres,
                                  const at::Tensor& words, bool craig, bool grad,
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
                    spheres.sizes(), " do not match sigma ", sigma.sizes());
  TORCH_CHECK_VALUE(R > 0 && T % R == 0, what, ": sigma ", sigma.sizes(), " does not match q ",
                    q.sizes());
  TORCH_CHECK_VALUE(words.size(1) == 2, what, ": words must be [ncells, 2]");
  TORCH_CHECK_VALUE(grid.size() == 7 && shape.size() == 3, what, ": grid needs 7 numbers and 3 sizes");
  TORCH_CHECK_VALUE(words.size(0) == shape[0] * shape[1] * shape[2], what,
                    ": words do not match the grid shape");
  const K1Grid g{(float)grid[0], (float)grid[1], (float)grid[2], (float)grid[3], (float)grid[4],
                 (float)grid[5], (float)grid[6], (int)shape[0], (int)shape[1], (int)shape[2]};
  const c10::cuda::CUDAGuard guard(q.device());
  auto lik = at::empty({T}, q.options());
  at::Tensor dlik;
  if (grad) dlik = at::empty({T, dof}, q.options());
  C10_CUDA_CHECK(k1_loglik_launch(q.data_ptr<float>(), sigma.data_ptr<float>(),
                                  robot.data_ptr<float>(), spheres.data_ptr<float>(),
                                  words.data_ptr(), lik.data_ptr<float>(),
                                  grad ? dlik.data_ptr<float>() : nullptr, T, T / R, (int)P,
                                  (int)dof, craig, grad, g, (float)eps,
                                  at::cuda::getCurrentCUDAStream()));
  return {lik, dlik};
}

int64_t square_n(const at::Tensor& L, const char* what) {
  const int64_t n = L.size(1);
  TORCH_CHECK_VALUE(L.size(2) == n && n >= 1 && n <= 32, what, ": needs square n <= 32, got ",
                    L.sizes());
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
                    "k2_trsm: B ", B.sizes(), " does not match L ", L.sizes());
  const c10::cuda::CUDAGuard guard(L.device());
  auto X = at::empty_like(B);
  C10_CUDA_CHECK(k2_trsm_launch(L.data_ptr<double>(), B.data_ptr<double>(), X.data_ptr<double>(),
                                L.size(0), (int)n, (int)B.size(2), upper_t,
                                at::cuda::getCurrentCUDAStream()));
  return X;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("k1_loglik", &k1_loglik, "K1: fused FK, packed-SDF gather and hinge; (lik, dlik/dq)");
  m.def("k2_chol", &k2_chol, "K2: batched float64 lower Cholesky");
  m.def("k2_trsm", &k2_trsm, "K2: batched float64 triangular solve, L X = B or L^T X = B");
}
