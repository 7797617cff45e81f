"""Port parity: training with σ_obs and alpha trainable.

The log-priors (Normal(init, 1e-4) on the constrained σ_obs, Normal(init, 5)
on alpha) join the ELBO, and σ_obs's gradient joins the masked step. A 3-step
solve of the small franka planner runs in both packages on the same params and
JAX's own draws; optax's float32 schedule bounds the agreement at 1e-6
relative (as in ``test_torch_solver.py``), plus 1e-8 of the largest entry
for entries near zero. K1's plain d/dσ (autograd through
``log_prob_plain``, and ``dsigma_plain`` from the squared hinges) is held to
``jax.grad`` of ``CollisionModel.log_prob`` in float64 (same cells gathered,
so 1e-10 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise, planner_models
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.likelihoods import collision as tcol
from vgpmp_torch.models import vgpmp as tm

B, S, M, NB, STEPS, K = 3, 3, 4, 64, 3, 4
TRAINABLE = dict(js.default_trainable(), sigma_obs_u=True, alpha_u=True)


def _problem(jspec):
    rng = np.random.default_rng(1)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    return starts, goals


def _solve_both(trainable, edit=None, sigma_anneal=2.0):
    """The same 3-step solve in both packages; ``edit(params_np)`` may change
    the initial unconstrained leaves first."""
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.02, lr_peak=0.15, warmup_steps=10,
                          sigma_anneal=sigma_anneal, time_spacing_X=8, time_spacing_Xnew=10,
                          num_posterior_samples=K)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    starts, goals = _problem(jspec)
    # σ_obs large enough that a few spheres are in contact at 0.05 epsilon
    args = ([1.5] * 7, 0.2, 0.005, 100.0)
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals),
                               jnp.asarray([0, 1, 2]), jnp.asarray(0.5 * (starts + goals)),
                               *map(jnp.asarray, args))
    p0 = {k: np.array(getattr(jp0, k)) for k in tm.PlannerParams.names()}
    if edit is not None:
        edit(p0)
    jp0 = jm.PlannerParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jparams, jres = js.make_batch_solver(jmodel, jcfg, trainable)(jp0, jnp.asarray(starts),
                                                                  jnp.asarray(goals), keys)
    step_keys = [jax.random.split(k, STEPS + 1) for k in keys]
    noise = ts.SolveNoise(
        steps=[jax_path_noise([sk[i] for sk in step_keys], 7, M + 2, S, NB) for i in range(STEPS)],
        posterior=jax_path_noise([sk[-1] for sk in step_keys], 7, M + 2, K, NB))
    tparams, tres = ts.make_batch_solver(tmodel, tcfg, trainable)(params_from_numpy(p0), starts, goals,
                                                                  noise=noise)
    return p0, jparams, jres, tparams, tres


@pytest.fixture(scope="module")
def solved():
    return _solve_both(TRAINABLE)


@pytest.mark.parametrize("leaf", tm.PlannerParams.names())
def test_trainable_sigma_alpha_params_match_jax(solved, leaf):
    p0, jparams, _, tparams, _ = solved
    got, want = params_to_numpy(tparams)[leaf], np.asarray(getattr(jparams, leaf))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * max(np.abs(got).max(), 1.0),
                               err_msg=leaf)
    if leaf in ("sigma_obs_u", "alpha_u"):  # trained, not frozen
        assert not np.array_equal(got, p0[leaf])


@pytest.mark.parametrize("field", ["elbo_history", "best", "best_score"])
def test_trainable_sigma_alpha_result_matches_jax(solved, field):
    _, _, jres, _, tres = solved
    want, got = np.asarray(getattr(jres, field)), getattr(tres, field).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-6,
                               atol=1e-8 * max(np.abs(want).max(), 1.0), err_msg=field)
    if field == "elbo_history":
        assert np.isfinite(got).all()


def test_log_prior_enters_the_elbo_history(solved):
    """The first ELBO of a prior solve is the frozen solve's first ELBO plus
    the log-prior at the anchors: P Normal(0; 0, 1e-4) terms and one
    Normal(0; 0, 5) term per row (the first step's draws are the same)."""
    *_, tparams, tres = solved
    *_, plain = _solve_both(None)
    P = tparams.sigma_obs_u.shape[1]
    lp = P * (-np.log(1e-4) - 0.5 * np.log(2 * np.pi)) + (-np.log(5.0) - 0.5 * np.log(2 * np.pi))
    np.testing.assert_allclose(tres.elbo_history[:, 0].numpy(), plain.elbo_history[:, 0].numpy() + lp,
                               rtol=1e-12)


def test_nan_sigma_gradient_skips_the_row_in_both():
    """Row 1's σ_obs starts at +inf on one sphere: its log-prior, and so its
    σ gradient, is NaN while every other gradient of the row stays finite.
    With σ trainable the row's step is skipped in both packages (JAX's
    NaN · mask, the port's per-row guard); the other rows advance alike."""
    def edit(p):
        p["sigma_obs_u"][1, 5] = np.inf

    p0, jparams, jres, tparams, tres = _solve_both(TRAINABLE, edit)
    got = params_to_numpy(tparams)
    for k in tm.PlannerParams.names():
        want = np.asarray(getattr(jparams, k))
        np.testing.assert_array_equal(got[k][1], p0[k][1], err_msg=k)
        np.testing.assert_array_equal(want[1], p0[k][1], err_msg=k)
        np.testing.assert_allclose(got[k][[0, 2]], want[[0, 2]], rtol=1e-6,
                                   atol=1e-8 * max(np.abs(want[[0, 2]]).max(), 1.0), err_msg=k)
    assert np.isnan(tres.elbo_history[1].numpy()).all() and np.isnan(np.asarray(jres.elbo_history)[1]).all()
    assert np.isfinite(tres.elbo_history[[0, 2]].numpy()).all()


@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_plain_dsigma_matches_jax_grad(robot):
    """∂/∂σ of the summed log-density per row, on configs in and out of
    contact, with one row of σ and configs where no sphere touches (dσ = 0
    exactly)."""
    from test_torch_collision import _configs, _models

    jspec, jmodel, tmodel = _models(robot)
    rng = np.random.default_rng(2)
    R, N, P = 4, 30, jspec.num_spheres
    q = _configs(jspec, rng, R * N).reshape(R, N, jspec.dof)
    # row 3: configs where every sphere is clear of the margin
    pool = _configs(jspec, rng, 4000)
    clear = (tmodel.hinge_cost(torch.as_tensor(pool)) == 0).all(dim=-1).numpy()
    q[3] = pool[clear][:N]
    sigma = rng.uniform(0.003, 0.007, size=(R, P))
    w = rng.normal(size=(R, N))

    def jf(s):
        return jnp.sum(jnp.asarray(w) * jax.vmap(jmodel.log_prob)(jnp.asarray(q), s))

    want = np.asarray(jax.grad(jf)(jnp.asarray(sigma)))
    st = torch.as_tensor(sigma).requires_grad_()
    lik = tmodel.log_prob(torch.as_tensor(q), st)
    (got,) = torch.autograd.grad((torch.as_tensor(w) * lik).sum(), st)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    # the kernel's plain version from the squared hinges [P, T]
    h = tmodel.hinge_cost(torch.as_tensor(q)).reshape(R * N, P)
    plain = tcol.dsigma_plain(torch.as_tensor(w).reshape(-1), (h * h).T.contiguous(), torch.as_tensor(sigma))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    assert np.abs(want).max() > 0
    assert not (h.reshape(R, N, P)[3] > 0).any() and (h.reshape(R, N, P)[:3] > 0).any()
    assert (plain[3] == 0).all() and (got[3] == 0).all()
