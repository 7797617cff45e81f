"""Port parity: ``randomize_timesteps``, one sorted uniform training grid per
problem row, drawn once per solve.

JAX draws each row's grid from its own key under ``vmap`` (``key, sub =
split(key)``, then ``sort(uniform(sub, [N]))``) before the step keys; the test
hands the port those grids through ``SolveNoise.timesteps`` together with the
steps' draws. A 3-step solve then agrees with JAX to 1e-6 relative (optax's
float32 schedule, as in ``test_torch_solver.py``, plus 1e-8 of the
largest entry, for entries near zero). The port's own draw is held
to its contract: sorted per row, inside ``[X[0], X[-1]]``, different per row.
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
from vgpmp_torch.models import vgpmp as tm

B, S, M, NB, STEPS, K, N = 3, 3, 4, 64, 3, 4, 8


@pytest.fixture(scope="module")
def solved():
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.02, lr_peak=0.15, warmup_steps=10,
                          time_spacing_X=N, time_spacing_Xnew=10, num_posterior_samples=K,
                          randomize_timesteps=True)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    rng = np.random.default_rng(4)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals),
                               jnp.asarray([0, 1, 2]), jnp.asarray(0.5 * (starts + goals)),
                               *map(jnp.asarray, ([1.5] * 7, 0.2, 0.005, 100.0)))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jparams, jres = js.make_batch_solver(jmodel, jcfg)(jp0, jnp.asarray(starts), jnp.asarray(goals),
                                                       keys)
    grids, step_keys = [], []
    for k in keys:  # the JAX solver's own draws, row by row
        k, sub = jax.random.split(k)
        grids.append(np.asarray(jnp.sort(jax.random.uniform(sub, (N,), dtype=jnp.float64))))
        step_keys.append(jax.random.split(k, STEPS + 1))
    noise = ts.SolveNoise(
        steps=[jax_path_noise([sk[i] for sk in step_keys], 7, M + 2, S, NB) for i in range(STEPS)],
        posterior=jax_path_noise([sk[-1] for sk in step_keys], 7, M + 2, K, NB),
        timesteps=torch.as_tensor(np.stack(grids)))
    tp0 = params_from_numpy({k: np.asarray(getattr(jp0, k)) for k in tm.PlannerParams.names()})
    tparams, tres = ts.make_batch_solver(tmodel, tcfg)(tp0, starts, goals, noise=noise)
    return jparams, jres, tparams, tres, np.stack(grids), (tmodel, tcfg, tp0, starts, goals, noise)


def test_randomized_solve_params_match_jax(solved):
    jparams, _, tparams, _, _, _ = solved
    for k, v in params_to_numpy(tparams).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jparams, k)), rtol=1e-6,
                                   atol=1e-8 * max(np.abs(v).max(), 1.0), err_msg=k)


@pytest.mark.parametrize("field", ["elbo_history", "best", "mean"])
def test_randomized_solve_result_matches_jax(solved, field):
    _, jres, _, tres, _, _ = solved
    want, got = np.asarray(getattr(jres, field)), getattr(tres, field).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-6,
                               atol=1e-8 * max(np.abs(want).max(), 1.0), err_msg=field)


def test_each_row_trains_on_its_own_grid(solved):
    """The grids differ per row and from the fixed linspace, and the solve
    with them differs from the solve on the fixed grid."""
    _, _, _, tres, grids, (tmodel, tcfg, tp0, starts, goals, noise) = solved
    assert not np.allclose(grids[0], grids[1]) and not np.allclose(grids[0], np.linspace(0, 1, N))
    fixed = dataclasses.replace(tcfg, randomize_timesteps=False)
    _, res = ts.make_batch_solver(tmodel, fixed)(tp0, starts, goals, noise=noise._replace(timesteps=None))
    assert not torch.allclose(res.elbo_history[:, 0], tres.elbo_history[:, 0])
    with pytest.raises(ValueError, match="timesteps"):
        ts.make_batch_solver(tmodel, tcfg)(tp0, starts, goals, noise=noise._replace(timesteps=None))


def test_port_draw_is_sorted_per_row_and_inside_the_grid():
    X = torch.linspace(0.0, 1.0, 50, dtype=torch.float64)
    g = ts.random_timesteps(X, 64, torch.Generator().manual_seed(0))
    assert g.shape == (64, 50) and g.dtype == torch.float64
    assert bool((g[:, 1:] >= g[:, :-1]).all())
    assert float(g.min()) >= 0.0 and float(g.max()) <= 1.0
    assert not torch.equal(g[0], g[1])
    # endpoints are not pinned to the grid's ends
    assert float(g[:, 0].max()) > 0.0 and float(g[:, -1].min()) < 1.0
    again = ts.random_timesteps(X, 64, torch.Generator().manual_seed(0))
    assert torch.equal(g, again)
    # [a, b]: scaled, not clipped
    Xs = torch.linspace(0.2, 0.6, 10, dtype=torch.float64)
    gs = ts.random_timesteps(Xs, 8, torch.Generator().manual_seed(1))
    assert float(gs.min()) >= 0.2 and float(gs.max()) <= 0.6


def test_generator_draw_drives_a_solve(solved):
    """Without injected grids the solve draws its own, once, before the
    steps' draws: the same generator seed gives the same history."""
    _, _, _, _, _, (tmodel, tcfg, tp0, starts, goals, _) = solved
    cfg = dataclasses.replace(tcfg, num_steps=2)
    solve = ts.make_batch_solver(tmodel, cfg)
    a = solve(tp0, starts, goals, torch.Generator().manual_seed(5))[1].elbo_history
    b = solve(tp0, starts, goals, torch.Generator().manual_seed(5))[1].elbo_history
    assert torch.equal(a, b) and torch.isfinite(a).all()
