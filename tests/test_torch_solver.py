"""Port parity: the batched training engine.

A 5-step, B=3 solve of the small franka planner runs in both packages with the
port fed JAX's per-step and posterior draws; optimiser state and schedule are
compared step for step with optax. optax evaluates the lr schedule in
float32 even under x64 (the port in float64), so learning rates agree to two
float32 ulps (2.5e-7 relative). Given the same schedule values, one guarded
Adam step agrees to 1e-12 (XLA may fuse a multiply-add). After 5 steps
through the model with optax's own schedule, parameters and trajectories
agree to 1e-6 relative (plus 1e-8 of the leaf's scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_support import jax_path_noise, planner_models
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.models import vgpmp as tm

B, S, M, NB, STEPS, K = 3, 3, 4, 64, 5, 6


def test_lr_schedule_matches_optax():
    for cfg in (ts.TrainConfig(num_steps=200, learning_rate=0.02, lr_peak=0.15, warmup_steps=10),
                ts.TrainConfig(num_steps=5, learning_rate=0.02, lr_peak=0.15, warmup_steps=10),
                ts.TrainConfig(num_steps=30, learning_rate=0.05)):
        steps = np.arange(cfg.num_steps + 3)
        got = ts.lr_schedule(cfg, torch.as_tensor(steps)).numpy()
        if cfg.lr_peak > 0:
            warmup = min(cfg.warmup_steps, max(cfg.num_steps - 1, 1))
            sched = optax.warmup_cosine_decay_schedule(0.0, cfg.lr_peak, warmup, cfg.num_steps,
                                                       cfg.learning_rate)
            want = np.array([float(sched(jnp.asarray(i, jnp.int32))) for i in steps])
        else:
            want = np.full(len(steps), cfg.learning_rate)
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-12)


def test_guarded_adam_matches_optax_per_row():
    """A row whose update is non-finite keeps its parameters, moments and step
    count (as ``_guarded_step`` under vmap); the other rows advance."""
    cfg = ts.TrainConfig(num_steps=10, learning_rate=0.02, lr_peak=0.15, warmup_steps=3)
    rng = np.random.default_rng(0)
    shapes = {"q_mu": (B, M, 7), "q_sqrt": (B, 7, M, M), "lengthscales_u": (B, 7),
              "variance_u": (B, 7), "z_u": (B, M, 7), "sigma_obs_u": (B, 37), "alpha_u": (B,)}
    p0 = {k: rng.normal(size=s) for k, s in shapes.items()}
    # optax steps with the port's (float64) schedule values, looked up by its
    # own per-row count, so the comparison isolates Adam and the guard
    table = jnp.asarray(ts.lr_schedule(cfg, torch.arange(cfg.num_steps + 1)).numpy())
    opt = optax.adam(lambda count: table[count], b1=0.8, b2=0.95)

    def jstep(p, s, g):
        u, s_new = opt.update(g, s, p)
        return js._guarded_step(p, s, u, s_new)

    jstep = jax.jit(jax.vmap(jstep))
    jp = jm.PlannerParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    jstate = jax.vmap(opt.init)(jp)
    tp = params_from_numpy(p0)
    adam = ts.BatchedAdam(cfg, tp)
    for i in range(4):
        g = {k: rng.normal(size=s) for k, s in shapes.items()}
        if i in (1, 2):
            g["q_sqrt"][1, 3, 1, 0] = np.inf if i == 1 else np.nan  # row 1 diverges twice
        before = params_to_numpy(tp)
        jp, jstate = jstep(jp, jstate, jm.PlannerParams(**{k: jnp.asarray(v) for k, v in g.items()}))
        tp = adam.step(tp, params_from_numpy(g))
        got = params_to_numpy(tp)
        for k in shapes:
            np.testing.assert_allclose(got[k], np.asarray(getattr(jp, k)), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(getattr(adam.mu, k).numpy(),
                                       np.asarray(getattr(jstate[0].mu, k)), rtol=1e-12,
                                       atol=1e-15)
            np.testing.assert_allclose(getattr(adam.nu, k).numpy(),
                                       np.asarray(getattr(jstate[0].nu, k)), rtol=1e-12,
                                       atol=1e-15)
            if i in (1, 2):
                np.testing.assert_array_equal(got[k][1], before[k][1])
                assert not np.array_equal(got[k][[0, 2]], before[k][[0, 2]])
        np.testing.assert_array_equal(adam.count.numpy(), np.asarray(jstate[0].count))
        np.testing.assert_array_equal(adam.count.numpy(), np.asarray(jstate[1].count))
    np.testing.assert_array_equal(adam.count.numpy(), [4, 2, 4])


@pytest.fixture(scope="module")
def solved():
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.02, lr_peak=0.15, warmup_steps=10,
                          sigma_anneal=2.0, time_spacing_X=8, time_spacing_Xnew=10,
                          num_posterior_samples=K)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    rng = np.random.default_rng(1)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    args = ([1.5] * 7, 0.2, 0.005, 100.0)
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals),
                               jnp.asarray([0, 1, 2]), jnp.asarray(0.5 * (starts + goals)),
                               *map(jnp.asarray, args))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jparams, jres = js.make_batch_solver(jmodel, jcfg)(jp0, jnp.asarray(starts),
                                                       jnp.asarray(goals), keys)
    step_keys = [jax.random.split(k, STEPS + 1) for k in keys]
    noise = ts.SolveNoise(
        steps=[jax_path_noise([sk[i] for sk in step_keys], 7, M + 2, S, NB) for i in range(STEPS)],
        posterior=jax_path_noise([sk[-1] for sk in step_keys], 7, M + 2, K, NB))
    tp0 = params_from_numpy({k: np.asarray(getattr(jp0, k)) for k in tm.PlannerParams.names()})
    tparams, tres = ts.make_batch_solver(tmodel, tcfg)(tp0, starts, goals, noise=noise)
    return jparams, jres, tparams, tres, (tmodel, tcfg, tp0, starts, goals, noise)


def test_batch_solver_params_match_jax(solved):
    jparams, _, tparams, _, _ = solved
    for k, v in params_to_numpy(tparams).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jparams, k)), rtol=1e-6,
                                   atol=1e-8 * max(np.abs(v).max(), 1.0), err_msg=k)


@pytest.mark.parametrize("field", ["elbo_history", "best", "mean", "best_score", "failed",
                                   "ee_uncertainty"])
def test_batch_solver_result_matches_jax(solved, field):
    _, jres, _, tres, _ = solved
    want, got = np.asarray(getattr(jres, field)), getattr(tres, field).numpy()
    if field == "elbo_history":
        want = want.reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8, err_msg=field)


def test_single_solver_is_a_batch_row(solved):
    """make_single_solver on one problem gives that row of the batch solve."""
    _, _, tparams, tres, (tmodel, tcfg, tp0, starts, goals, noise) = solved
    row = lambda pn: type(pn)(*(x[1:2] for x in pn))
    one = ts.SolveNoise([row(n) for n in noise.steps], row(noise.posterior))
    params, res = ts.make_single_solver(tmodel, tcfg)(tp0.map(lambda x: x[1:2]), starts[1], goals[1],
                                                      noise=one)
    for k, v in params.leaves().items():
        torch.testing.assert_close(v[0], getattr(tparams, k)[1], rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(res.best, tres.best[1], rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(res.elbo_history, tres.elbo_history[1], rtol=1e-9, atol=1e-12)
