"""Port parity: transforms, kernels and the small linear algebra (plain and K2).

The same numpy inputs go through ``vgpmp_tpu`` (float64, x64 enabled by the
test conftest) and ``vgpmp_torch`` on the CPU. Tolerances: 1e-12 relative
for elementwise maps and the unrolled factorisations (same algorithm, same
order of operations in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgpmp_tpu.ops import kernels as jk
from vgpmp_tpu.ops import linalg as jl
from vgpmp_tpu.ops import transforms as jt
from vgpmp_torch.ops import kernels as tk
from vgpmp_torch.ops import linalg as tl
from vgpmp_torch.ops import transforms as tt

RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.array(x))


def _spd(rng, T, n):
    G = rng.normal(size=(T, n, n))
    return G @ np.swapaxes(G, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("name", ["softplus", "softplus_inverse", "positive", "positive_inverse",
                                  "sigmoid_box", "sigmoid_box_inverse", "lower_triangular"])
def test_transforms_match_jax(name):
    rng = np.random.default_rng(0)
    args = {
        "softplus": (rng.normal(size=50) * 10,),
        "softplus_inverse": (rng.uniform(0.01, 30, size=50),),
        "positive": (rng.normal(size=50), 0.1),
        "positive_inverse": (rng.uniform(0.2, 5, size=50), 0.1),
        "sigmoid_box": (rng.normal(size=50) * 3, 0.09, 0.91),
        "sigmoid_box_inverse": (rng.uniform(0.1, 0.9, size=50), 0.09, 0.91),
        "lower_triangular": (rng.normal(size=(3, 5, 5)),),
    }[name]
    want = np.asarray(getattr(jt, name)(jnp.asarray(args[0]), *args[1:]))
    got = getattr(tt, name)(_t(args[0]), *args[1:]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


def test_transform_bounds_match_jax_model():
    from vgpmp_tpu.models import vgpmp as jm

    assert (tt.VARIANCE_LOWER, tt.SIGMA_OBS_LOWER, tt.ALPHA_LOWER, tt.Z_LOW, tt.Z_HIGH) == (
        jm.VARIANCE_LOWER, jm.SIGMA_OBS_LOWER, jm.ALPHA_LOWER, jm.Z_LOW, jm.Z_HIGH)


@pytest.mark.parametrize("kernel", ["matern52", "squared_exponential"])
def test_kernels_match_jax(kernel):
    rng = np.random.default_rng(1)
    x1, x2 = rng.uniform(0, 1, (2, 4, 7)), rng.uniform(0, 1, (2, 4, 9))
    l, s2 = rng.uniform(0.3, 3, (2, 4)), rng.uniform(0.1, 2, (2, 4))
    jfn = getattr(jk, kernel)
    want = np.stack([np.asarray(jfn(jnp.asarray(x1[b]), jnp.asarray(x2[b]), jnp.asarray(l[b]),
                                    jnp.asarray(s2[b]))) for b in range(2)])
    got = getattr(tk, kernel)(_t(x1), _t(x2), _t(l), _t(s2)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


# n: 2 and every problemset's Mc (num_inducing + 2): the kernel's unroll buckets
@pytest.mark.parametrize("n", [2, 9, 12, 14, 16, 17, 20, 26])
def test_plain_linalg_matches_jax(n):
    rng = np.random.default_rng(n)
    K = _spd(rng, 5, n)
    Bm = rng.normal(size=(5, n, 3))
    Lj = np.asarray(jl.cholesky_unrolled(jnp.asarray(K)))
    Lt = tl.cholesky_unrolled(_t(K)).numpy()
    np.testing.assert_allclose(Lt, Lj, rtol=RTOL, atol=1e-13)
    for jf, tf in [(jl.solve_lower_unrolled, tl.solve_lower_unrolled),
                   (jl.solve_upper_T_unrolled, tl.solve_upper_T_unrolled),
                   (jl.cho_solve_unrolled, tl.cho_solve_unrolled)]:
        np.testing.assert_allclose(tf(_t(Lj), _t(Bm)).numpy(),
                                   np.asarray(jf(jnp.asarray(Lj), jnp.asarray(Bm))),
                                   rtol=1e-10, atol=1e-12)


def test_plain_linalg_nan_in_nan_out():
    """A non-SPD matrix gives NaN (never a clamp) in the same entries as JAX."""
    rng = np.random.default_rng(3)
    K = _spd(rng, 3, 6)
    K[1, 4, 4] = -50.0  # negative pivot at column 4 of matrix 1
    Lj = np.asarray(jl.cholesky_unrolled(jnp.asarray(K)))
    Lt = tl.cholesky_unrolled(_t(K)).numpy()
    assert np.isnan(Lt[1]).any() and np.isfinite(Lt[[0, 2]]).all()
    np.testing.assert_array_equal(np.isnan(Lt), np.isnan(Lj))
    Bm = rng.normal(size=(3, 6, 2))
    Xj = np.asarray(jl.solve_lower_unrolled(jnp.asarray(Lj), jnp.asarray(Bm)))
    Xt = tl.solve_lower_unrolled(_t(Lj), _t(Bm)).numpy()
    np.testing.assert_array_equal(np.isnan(Xt), np.isnan(Xj))
    # the dispatching entry points keep it too
    assert np.isnan(tl.chol(_t(K)).numpy()[1]).any()


def test_plain_linalg_gradient_matches_jax():
    """Autograd through the plain factorisation and solves equals jax.grad."""
    import jax

    rng = np.random.default_rng(4)
    K = _spd(rng, 2, 5)
    Bm = rng.normal(size=(2, 5, 3))
    W = rng.normal(size=(2, 5, 3))

    def jf(K, B):
        L = jl.cholesky_unrolled(K)
        return jnp.sum(W * jl.solve_upper_T_unrolled(L, jl.solve_lower_unrolled(L, B)))

    gK, gB = jax.grad(jf, argnums=(0, 1))(jnp.asarray(K), jnp.asarray(Bm))
    Kt, Bt = _t(K).requires_grad_(), _t(Bm).requires_grad_()
    L = tl.cholesky_unrolled(Kt)
    (_t(W) * tl.solve_upper_T_unrolled(L, tl.solve_lower_unrolled(L, Bt))).sum().backward()
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(gK), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gB), rtol=1e-9, atol=1e-12)


def test_k2_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; the CPU path is the plain one."""
    with pytest.raises(ValueError):
        tl.k2_chol(torch.eye(3, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        tl.k2_trsm(torch.eye(3, dtype=torch.float64)[None], torch.ones(1, 3, 2, dtype=torch.float64),
                   upper_t=False)
