"""Port parity: the planner model (ELBO, its gradient, extraction, init).

A small franka planner (S=3, N=8, M=4, 64 bases, float64) over a random
packed scene is built in both packages; the port is fed the draws JAX makes
from the same keys. The ELBO is a sum of float64 terms computed in the same
order up to einsum/sum reductions: 1e-9 relative on values, and 1e-7
relative (plus 1e-9 of each leaf's largest gradient) on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise, planner_models
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.models import vgpmp as tm

B, S, N, M, NB = 2, 3, 8, 4, 64


@pytest.fixture(scope="module")
def setup():
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M)
    rng = np.random.default_rng(0)
    lo, hi = jspec.limits_low, jspec.limits_high
    mid, span = 0.5 * (lo + hi), 0.3 * (hi - lo)
    starts = mid + span * rng.uniform(-1, 1, (B, jspec.dof))
    goals = mid + span * rng.uniform(-1, 1, (B, jspec.dof))
    rows = [jm.init_params(jmodel, starts[b], goals[b], [1.5] * 7, 0.2, 0.005, 100.0)
            for b in range(B)]
    p = {k: np.stack([np.asarray(getattr(r, k)) for r in rows]) for k in tm.PlannerParams.names()}
    # move every leaf off its initial value so each gradient is exercised
    p["q_mu"] = p["q_mu"] + 0.3 * rng.normal(size=p["q_mu"].shape)
    p["q_sqrt"] = p["q_sqrt"] + 0.1 * np.tril(rng.normal(size=p["q_sqrt"].shape))
    for k in ("lengthscales_u", "variance_u", "z_u", "sigma_obs_u", "alpha_u"):
        p[k] = p[k] + 0.1 * rng.normal(size=p[k].shape)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    return jspec, jmodel, tmodel, starts, goals, p, keys


def _jparams(p, b=None):
    return jm.PlannerParams(**{k: jnp.asarray(v if b is None else v[b]) for k, v in p.items()})


def test_elbo_value_and_every_gradient_match_jax(setup):
    jspec, jmodel, tmodel, starts, goals, p, keys = setup
    X = np.linspace(0, 1, N)
    fn = jax.jit(jax.vmap(jax.value_and_grad(
        lambda pp, s, g, k: jm.elbo(pp, jmodel, s, g, jnp.asarray(X), k))))
    val, grads = fn(_jparams(p), jnp.asarray(starts), jnp.asarray(goals), keys)
    tp = params_from_numpy(p)
    for v in tp.leaves().values():
        v.requires_grad_(True)
    noise = jax_path_noise(keys, jspec.dof, M + 2, S, NB)
    got = tm.elbo(tp, tmodel, torch.as_tensor(starts), torch.as_tensor(goals),
                  torch.as_tensor(X), noise=noise)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(val), rtol=1e-9)
    for k, v in tp.leaves().items():
        want = np.asarray(getattr(grads, k))
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-7,
                                   atol=1e-9 * np.abs(want).max(), err_msg=k)


def test_elbo_with_aux_matches_jax(setup):
    jspec, jmodel, tmodel, starts, goals, p, keys = setup
    X = np.linspace(0, 1, N)
    fn = jax.jit(jax.vmap(lambda pp, s, g, k: jm.elbo_with_aux(pp, jmodel, s, g, jnp.asarray(X),
                                                                k, sigma_scale=2.0)))
    val, aux = fn(_jparams(p), jnp.asarray(starts), jnp.asarray(goals), keys)
    got, taux = tm.elbo_with_aux(params_from_numpy(p), tmodel, torch.as_tensor(starts),
                                 torch.as_tensor(goals), torch.as_tensor(X),
                                 noise=jax_path_noise(keys, jspec.dof, M + 2, S, NB), sigma_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(val), rtol=1e-9)
    for k in ("kl", "expected_log_lik", "min_clearance", "mean_hinge_cost", "jitter_escalations"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_sample_from_posterior_matches_jax(setup):
    jspec, jmodel, tmodel, starts, goals, p, keys = setup
    Xnew, K = np.linspace(0, 1, 10), 20
    fn = jax.jit(jax.vmap(lambda pp, s, g, k: jm.sample_from_posterior(pp, jmodel, s, g,
                                                                jnp.asarray(Xnew), k, K)))
    want = fn(_jparams(p), jnp.asarray(starts), jnp.asarray(goals), keys)
    got = tm.sample_from_posterior(params_from_numpy(p), tmodel, torch.as_tensor(starts),
                                   torch.as_tensor(goals), torch.as_tensor(Xnew), K,
                                   noise=jax_path_noise(keys, jspec.dof, M + 2, K, NB))
    for name, w, g in zip(("mean", "best", "samples", "scores"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-10, err_msg=name)


def test_init_params_batch_matches_jax(setup):
    jspec, jmodel, tmodel, starts, goals, _, _ = setup
    modes, wps = np.arange(B) % 3, 0.5 * (starts + goals) + 0.1
    args = ([1.5] * 7, 0.2, 0.005, 100.0)
    want = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals),
                                jnp.asarray(modes), jnp.asarray(wps), *map(jnp.asarray, args))
    got = params_to_numpy(tm.init_params_batch(tmodel, starts, goals, modes, wps, *args))
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(getattr(want, k)), rtol=1e-12, atol=1e-14, err_msg=k)
    for mode in ("linear", "zeros", "waypoint"):
        one = params_to_numpy(tm.init_params(tmodel, starts[0], goals[0], *args, interpolation=mode))
        ref = jm.init_params(jmodel, starts[0], goals[0], *args, interpolation=mode)
        for k, v in one.items():
            np.testing.assert_allclose(v[0], np.asarray(getattr(ref, k)), rtol=1e-12, atol=1e-14)
