"""Port parity: receding-horizon replanning (``engine/replan.py``).

The loop is held to JAX's ``run_receding_horizon`` exactly through one shared
numpy stub of the solver (a deterministic function of ``q_mu``, the reached
configuration and the goal, which also moves ``q_mu`` so that the warm start
shows): the stitched path, ``reached_goal``, ``final_error`` and
``elbo_last`` must be equal, with JAX's disturbance draws injected. Then the
two behaviour tests of ``tests/test_replan.py`` run on the port with its real
solver (float64, franka/industrial at a tiny size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgpmp_tpu.engine import replan as jreplan
from vgpmp_tpu.engine import solver as js
from vgpmp_torch.engine import replan as treplan
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.session import PlanningSession

TINY = dict(num_steps=8, num_samples=3, num_bases=64, num_inducing=5,
            time_spacing_X=10, time_spacing_Xnew=30)
T_STUB, B, L = 30, 4, 7


def stub_plan(q_mu, start, goal):
    """``(best [..., T, L], elbo [...])`` from ``q_mu [..., M, L]`` and the
    reached start and the goal ``[..., L]``; the hash is rounded to 1e-6 so
    that the last bits of either package's inits cannot move it."""
    h = np.round(np.abs(q_mu).sum(axis=(-2, -1)) + 3.0 * np.abs(goal - start).sum(axis=-1), 6)
    u = (h * 7919.0) % 1.0
    w = np.linspace(0.0, 1.0, T_STUB)[:, None]
    best = (start[..., None, :] + (goal - start)[..., None, :] * w
            + 0.2 * (u - 0.5)[..., None, None] * np.sin(np.pi * w))
    return best, -100.0 * u


def _jax_single(params, start, goal, key):
    best, elbo = jax.pure_callback(
        lambda q, s, g: tuple(np.asarray(x, np.float64) for x in stub_plan(np.asarray(q), np.asarray(s),
                                                                            np.asarray(g))),
        (jax.ShapeDtypeStruct((T_STUB, L), jnp.float64), jax.ShapeDtypeStruct((), jnp.float64)),
        params.q_mu, start, goal, vmap_method="broadcast_all")
    res = js.SolveResult(best=best, mean=best, best_score=elbo, elbo_history=jnp.stack([elbo - 1.0, elbo]),
                         failed=jnp.zeros((), bool))
    return params.replace(q_mu=params.q_mu + 0.01), res


def _torch_batch(params, current, goals, generator=None, noise=None):
    best, elbo = stub_plan(params.q_mu.numpy(), current.numpy(), goals.numpy())
    best, elbo = torch.as_tensor(best), torch.as_tensor(elbo)
    res = ts.SolveResult(best=best, mean=best, best_score=elbo,
                         elbo_history=torch.stack([elbo - 1.0, elbo], dim=1),
                         failed=torch.zeros(len(elbo), dtype=torch.bool))
    return dataclasses.replace(params, q_mu=params.q_mu + 0.01), res


@pytest.fixture(scope="module")
def session():
    return PlanningSession("franka", "industrial", dtype=torch.float64, overrides=TINY, device="cpu")


@pytest.mark.parametrize("noise_scale,cycles,advance", [(0.0, 3, 8), (0.15, 4, 5)])
def test_receding_horizon_matches_jax_on_a_shared_stub(session, monkeypatch, noise_scale, cycles, advance):
    from vgpmp_tpu.session import PlanningSession as JaxSession

    jsess = JaxSession("franka", "industrial", dtype=jnp.float64, overrides=TINY)
    starts, goals = (x[:B] for x in session.queries())
    jparams = js.init_batch(jsess.model, starts, goals, jsess.planner_params)
    tparams = ts.init_batch(session.model, starts, goals, session.planner_params)
    monkeypatch.setattr(js, "make_single_solver", lambda model, cfg, trainable=None: _jax_single)
    monkeypatch.setattr(treplan, "make_replanner", lambda model, cfg, trainable=None: _torch_batch)
    full = js.TrainConfig(num_steps=8)
    quick = full.replace(num_steps=4)
    key = jax.random.PRNGKey(5)
    want = jreplan.run_receding_horizon(jsess.model, full, quick, jparams, jnp.asarray(starts),
                                        jnp.asarray(goals), key, cycles=cycles, advance=advance,
                                        noise_scale=noise_scale)
    # JAX's disturbance draws, in the order its loop makes them
    k, draws = key, []
    for c in range(cycles):
        k, _ = jax.random.split(k)
        if noise_scale > 0.0 and c < cycles - 1:
            k, nsub = jax.random.split(k)
            draws.append(np.asarray(jax.random.normal(nsub, (B, L), dtype=jnp.float64)))
    tcfg = ts.TrainConfig(num_steps=8)
    got = treplan.run_receding_horizon(
        session.model, tcfg, dataclasses.replace(tcfg, num_steps=4), tparams, starts, goals,
        cycles=cycles, advance=advance, noise_scale=noise_scale,
        disturbances=torch.as_tensor(np.stack(draws)) if draws else None)
    extra = cycles - 1 if noise_scale > 0 else 0
    assert got.executed.shape == (B, 1 + (cycles - 1) * advance + (T_STUB - 1) + extra, L)
    for f in treplan.ReplanResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_receding_horizon_reaches_goal(session):
    """``test_replan.py::test_receding_horizon_reaches_goal`` on the port."""
    starts, goals = (x[:2] for x in session.queries())
    params = ts.init_batch(session.model, starts, goals, session.planner_params)
    full = ts.TrainConfig(num_steps=8, learning_rate=0.05, time_spacing_X=10, time_spacing_Xnew=30,
                          num_posterior_samples=6)
    res = treplan.run_receding_horizon(session.model, full, dataclasses.replace(full, num_steps=4), params,
                                       starts, goals, torch.Generator().manual_seed(0), cycles=3, advance=8)
    assert res.executed.shape == (2, 1 + 2 * 8 + 29, 7) and res.elbo_last.shape == (2, 3)
    assert torch.isfinite(res.executed).all() and torch.isfinite(res.elbo_last).all()
    assert (res.final_error < 0.05).all(), res.final_error
    assert bool(res.reached_goal.all())
    np.testing.assert_allclose(res.executed[:, 0].numpy(), starts, atol=1e-9)


def test_receding_horizon_corrects_disturbances(session):
    """``test_replan.py::test_receding_horizon_corrects_disturbances`` on the
    port: closed loop absorbs 0.15 rad disturbances, open loop does not."""
    starts, goals = (x[:2] for x in session.queries())
    params = ts.init_batch(session.model, starts, goals, session.planner_params)
    full = ts.TrainConfig(num_steps=8, learning_rate=0.05, time_spacing_X=10, time_spacing_Xnew=30,
                          num_posterior_samples=6)
    noise = 0.15
    res = treplan.run_receding_horizon(session.model, full, dataclasses.replace(full, num_steps=6), params,
                                       starts, goals, torch.Generator().manual_seed(0), cycles=3, advance=8,
                                       noise_scale=noise)
    assert (res.final_error < 0.05).all(), res.final_error
    _, res0 = ts.make_batch_solver(session.model, full)(params, starts, goals, torch.Generator().manual_seed(1))
    end = res0.best[:, -1, :].numpy()
    rng = np.random.default_rng(0)
    for _ in range(2):
        end = end + noise * rng.standard_normal(end.shape)
    assert (np.abs(end - goals).max(-1) > 0.05).all()
