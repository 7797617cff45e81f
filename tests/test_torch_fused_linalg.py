"""The fused factorise-and-solve pair of ``vgpmp_torch.ops.linalg`` on the CPU.

Float64, inputs from a numpy seed. The plain forward is the unrolled
factorisation followed by the unrolled substitution, so it is held bit for bit;
the plain backward is a closed formula, held to 1e-10 against autograd through
the unrolled versions (same quantities, summed in another order) and against
``jax.grad`` through the JAX package's unrolled versions. The call sites that
went over to the pair (``draw_and_eval_paths``) are held bit for bit against
the separate calls they replaced, and the KL from the whitened mean
(``prior_kl_whitened``) against ``prior_kl`` of both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgpmp_tpu.gp import conditioned as jconditioned
from vgpmp_tpu.gp import kl as jkl
from vgpmp_tpu.ops import kernels as jk
from vgpmp_tpu.ops import linalg as jl
from vgpmp_torch.gp import conditioned, pathwise
from vgpmp_torch.gp import kl as tkl
from vgpmp_torch.ops import kernels as tk
from vgpmp_torch.ops import linalg as tl


def _spd(rng, T, n):
    G = rng.normal(size=(T, n, n))
    return G @ np.swapaxes(G, -1, -2) + n * np.eye(n)


def _case(k, n=12, T=5):
    rng = np.random.default_rng(100 + k)
    return (torch.as_tensor(_spd(rng, T, n)), torch.as_tensor(rng.normal(size=(T, n, k))),
            torch.as_tensor(rng.normal(size=(T, n, n))), torch.as_tensor(rng.normal(size=(T, n, k))))


@pytest.mark.parametrize("k", [1, 20, 70])
def test_factor_solve_plain_is_chol_then_solve(k):
    K, B, _, _ = _case(k)
    L, X = tl.factor_solve_plain(K, B)
    Lr = tl.cholesky_unrolled(K)
    assert torch.equal(L, Lr)
    assert torch.equal(X, tl.solve_lower_unrolled(Lr, B))
    # the dispatching entry point takes the same route on the CPU, with leading axes
    L2, X2 = tl.factor_solve(K.reshape(5, 1, 12, 12), B.reshape(5, 1, 12, k))
    assert torch.equal(L2.reshape(L.shape), L) and torch.equal(X2.reshape(X.shape), X)


@pytest.mark.parametrize("k", [1, 20, 70])
def test_factor_solve_columns_are_independent(k):
    """Solving two right-hand sides side by side gives each one's own bits."""
    K, B, _, _ = _case(k)
    extra = torch.as_tensor(np.random.default_rng(k).normal(size=(5, 12, 50)))
    _, X = tl.factor_solve_plain(K, torch.cat([B, extra], dim=-1))
    assert torch.equal(X[..., :k], tl.factor_solve_plain(K, B)[1])
    assert torch.equal(X[..., k:], tl.factor_solve_plain(K, extra)[1])


@pytest.mark.parametrize("k", [1, 20, 70])
def test_factor_solve_bwd_plain_matches_autograd(k):
    K, B, WL, WX = _case(k)
    Kt, Bt = K.clone().requires_grad_(), B.clone().requires_grad_()
    L, X = tl.factor_solve_plain(Kt, Bt)
    gK, gB = torch.autograd.grad((WL * L).sum() + (WX * X).sum(), [Kt, Bt])
    with torch.no_grad():
        hK, hB = tl.factor_solve_bwd_plain(L, X, WL, WX)
    torch.testing.assert_close(hK, gK, rtol=1e-10, atol=1e-10 * gK.abs().max().item())
    torch.testing.assert_close(hB, gB, rtol=1e-10, atol=1e-10 * gB.abs().max().item())
    assert torch.equal(hK, torch.tril(hK))  # folded onto the lower triangle


@pytest.mark.parametrize("k", [1, 20])
def test_factor_solve_bwd_plain_matches_jax_grad(k):
    K, B, WL, WX = _case(k)

    def jf(K, B):
        L = jl.cholesky_unrolled(K)
        return jnp.sum(WL.numpy() * L) + jnp.sum(WX.numpy() * jl.solve_lower_unrolled(L, B))

    gK, gB = jax.grad(jf, argnums=(0, 1))(jnp.asarray(K.numpy()), jnp.asarray(B.numpy()))
    hK, hB = tl.factor_solve_bwd_plain(*tl.factor_solve_plain(K, B), WL, WX)
    np.testing.assert_allclose(hK.numpy(), np.asarray(gK), rtol=1e-9, atol=1e-10 * np.abs(gK).max())
    np.testing.assert_allclose(hB.numpy(), np.asarray(gB), rtol=1e-9, atol=1e-10 * np.abs(gB).max())


def test_factor_solve_nan_in_nan_out():
    K, B, WL, WX = _case(20)
    K[3] = -K[3]  # not SPD: NaN through sqrt, never a clamp
    L, X = tl.factor_solve(K, B)
    ok = torch.tensor([True, True, True, False, True])
    assert torch.isnan(L[3]).any() and torch.isnan(X[3]).any()
    assert torch.isfinite(L[ok]).all() and torch.isfinite(X[ok]).all()
    gK, gB = tl.factor_solve_bwd_plain(L, X, WL, WX)
    assert torch.isnan(gK[3]).any() and torch.isnan(gB[3]).any()
    assert torch.isfinite(gK[ok]).all() and torch.isfinite(gB[ok]).all()


def test_fused_wrappers_refuse_cpu_tensors():
    K, B, WL, WX = _case(1)
    with pytest.raises(ValueError):
        tl.k2_factor_solve(K, B)
    with pytest.raises(ValueError):
        tl.k2_factor_solve_bwd(K, B, WL, WX)


@pytest.mark.parametrize("antithetic", [False, True])
def test_draw_and_eval_paths_equals_separate_calls(antithetic):
    """The fused call site gives the bits of ``cholesky_kuu`` + ``draw_paths`` +
    ``eval_paths``, values and gradients, with the same generator seed."""
    rng = np.random.default_rng(8)
    Bn, L, M, S, N, nb = 3, 4, 6, 5, 9, 32
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    ny = torch.tensor([0.0, 1.0])
    Z0 = f32(rng.uniform(0.1, 0.9, size=(Bn, M, L)))
    ls0, var0 = f32(rng.uniform(0.3, 1.5, (Bn, L))), f32(rng.uniform(0.5, 2.0, (Bn, L)))
    q_mu0 = f32(rng.normal(size=(Bn, M + 2, L)))
    q_sqrt0 = f32(np.tril(rng.normal(size=(Bn, L, M, M))) * 0.3 + np.eye(M))
    X = torch.linspace(0, 1, N)
    kern = tk.KERNELS["matern52"]
    out = []
    for fused in (False, True):
        leaves = [t.clone().requires_grad_() for t in (Z0, ls0, var0, q_mu0, q_sqrt0)]
        Z, ls, var, q_mu, q_sqrt = leaves
        gen = torch.Generator().manual_seed(4)
        kuf = conditioned.kuf(kern, ny, Z, X, ls, var, solve_dtype=torch.float64)
        kw = dict(num_samples=S, num_bases=nb, jitter=1e-9, antithetic=antithetic, generator=gen)
        if fused:
            kuu = conditioned.kuu(kern, ny, Z, ls, var, jitter=1e-9, solve_dtype=torch.float64)
            chol, state, f, _ = pathwise.draw_and_eval_paths(ny, Z, ls, var, kuu, kuf, X, q_mu, q_sqrt, **kw)
        else:
            _, chol = conditioned.cholesky_kuu(kern, ny, Z, ls, var, jitter=1e-9,
                                               solve_dtype=torch.float64)
            state = pathwise.draw_paths(ny, Z, ls, var, chol, q_mu, q_sqrt, **kw)
            f = pathwise.eval_paths(state, kuf, X)
        grads = torch.autograd.grad(f.square().sum() + chol.sum(), leaves)
        out.append([chol.detach(), state.a.detach(), f.detach(), *grads])
    assert out[0][2].shape == (Bn, S, N, L)
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("jitter,M", [(1e-6, 4), (1e-9, 10)])
def test_prior_kl_whitened_matches_prior_kl(jitter, M):
    """The KL from rows ``C:`` of ``L⁻¹ q_mu_full`` (one more column of the fused
    solve) against ``prior_kl`` of the JAX package and of the port, value and
    gradients, on Grams of condition 6e4 and 2e7. The identity is exact; the
    two routes round differently, by less than either differs from JAX: the
    model tests' tolerances (1e-9 on values, 1e-7 on gradients) hold."""
    rng = np.random.default_rng(0)
    Bn, L, C = 3, 7, 2
    ny = np.array([0.0, 1.0])
    Z = np.tile(np.linspace(0.1, 0.9, M)[None, :, None], (Bn, 1, L)) + 0.01 * rng.normal(size=(Bn, M, L))
    ls, var = rng.uniform(0.3, 1.5, (Bn, L)), rng.uniform(0.5, 2.0, (Bn, L))
    q_mu = rng.normal(size=(Bn, M, L))
    q_sqrt = np.tril(rng.normal(size=(Bn, L, M, M))) * 0.3 + np.eye(M)
    q = rng.normal(size=(Bn, C, L))

    def one(Z, ls, var, q_mu, q_sqrt, q):  # the JAX functions take one problem
        K, ch = jconditioned.cholesky_kuu(jk.matern52, jnp.asarray(ny), Z, ls, var, jitter=jitter)
        return jkl.prior_kl(K, ch, q_mu, q_sqrt, q)

    def jv(Z, ls, var, q_mu):
        return jax.vmap(one)(Z, ls, var, q_mu, jnp.asarray(q_sqrt), jnp.asarray(q))

    args = tuple(jnp.asarray(a) for a in (Z, ls, var, q_mu))
    want = np.asarray(jv(*args))
    gwant = [np.asarray(g) for g in jax.grad(lambda *a: jnp.sum(jv(*a)), argnums=(0, 1, 2, 3))(*args)]

    got = {}
    for route in ("prior_kl", "prior_kl_whitened"):
        leaves = [torch.as_tensor(a).clone().requires_grad_() for a in (Z, ls, var, q_mu)]
        Zt, lst, vart, q_mut = leaves
        K = conditioned.kuu(tk.matern52, torch.as_tensor(ny), Zt, lst, vart, jitter=jitter)
        q_mu_full = torch.cat([torch.as_tensor(q), q_mut], dim=-2)
        if route == "prior_kl":
            v = tkl.prior_kl(K, tl.chol(K), q_mut, torch.as_tensor(q_sqrt), torch.as_tensor(q))
        else:
            _, m_w = tl.factor_solve(K, q_mu_full.transpose(-1, -2)[..., None])
            v = tkl.prior_kl_whitened(m_w, torch.as_tensor(q_sqrt))
        got[route] = (v.detach().numpy(), [g.numpy() for g in torch.autograd.grad(v.sum(), leaves)])
    for route, (v, grads) in got.items():
        np.testing.assert_allclose(v, want, rtol=1e-9, err_msg=route)
        for g, w in zip(grads, gwant):
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9 * np.abs(w).max(), err_msg=route)
    np.testing.assert_allclose(got["prior_kl_whitened"][0], got["prior_kl"][0], rtol=1e-9)


def test_elbo_with_jitter_escalation_equals_fused_route():
    """With ``jitter_escalations=1`` the model factors and solves in separate
    calls; no Gram here needs a retry, so the ELBO and the KL are the bits of
    the fused route (columns are solved independently, and both routes take
    the KL from the whitened mean). The gradients reach the factor through
    three backward calls instead of one, summed in another order: 1e-11 of
    each leaf's largest."""
    import dataclasses

    from _torch_support import planner_models
    from vgpmp_torch.models import vgpmp as tm

    jspec, _, tmodel = planner_models(num_samples=3, num_bases=32, num_inducing=4)
    rng = np.random.default_rng(2)
    lo, hi = jspec.limits_low, jspec.limits_high
    mid, span = 0.5 * (lo + hi), 0.3 * (hi - lo)
    starts = torch.as_tensor(mid + span * rng.uniform(-1, 1, (2, jspec.dof)))
    goals = torch.as_tensor(mid + span * rng.uniform(-1, 1, (2, jspec.dof)))
    X = torch.linspace(0, 1, 8, dtype=torch.float64)
    out = []
    for esc in (0, 1):
        model = dataclasses.replace(tmodel, jitter_escalations=esc)
        params = tm.init_params_batch(model, starts, goals, [0, 2], 0.5 * (starts + goals) + 0.1,
                                      [1.5] * 7, 0.2, 0.005, 100.0)
        leaves = params.leaves()
        for v in leaves.values():
            v.requires_grad_(True)
        val, aux = tm.elbo_with_aux(params, model, starts, goals, X,
                                    generator=torch.Generator().manual_seed(6))
        grads = torch.autograd.grad(val.sum(), list(leaves.values()))
        assert int(aux["jitter_escalations"].sum()) == 0
        out.append([val.detach(), aux["kl"].detach(), *grads])
    assert torch.isfinite(out[0][0]).all() and out[0][1].abs().min() > 0
    for i, (a, b) in enumerate(zip(*out)):
        if i < 2:
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max() <= 1e-11 * a.abs().max()
