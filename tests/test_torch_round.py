"""Port parity: the scored round as a whole (``make_round_solver``: batch solve,
best posterior sample, then ``execute_and_validate`` per row).

A 5-step, B=3 round of the small franka planner runs in both packages in
float64, with the port fed JAX's per-step and posterior draws. optax evaluates
its learning-rate schedule in float32 (the port in float64), so after training
the trajectories agree to 1e-6; the report's floats inherit that tolerance and
its bools must be equal.
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
from vgpmp_torch.convert import params_from_numpy, report_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.engine.validator import ValidationReport, execute_and_validate
from vgpmp_torch.models import vgpmp as tm

B, S, M, NB, STEPS, K = 3, 3, 4, 64, 5, 6
BOOLS = ["success", "collision_free", "endpoints_ok", "limits_ok", "velocity_ok", "executed"]
FLOATS = ["min_clearance", "max_endpoint_err"]


@pytest.fixture(scope="module")
def rounds():
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.02, lr_peak=0.15, warmup_steps=10,
                          sigma_anneal=2.0, time_spacing_X=8, time_spacing_Xnew=10,
                          num_posterior_samples=K)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    assert tcfg.ee_uncertainty  # the round turns it off itself
    rng = np.random.default_rng(1)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals[2] = starts[2] + 0.1  # a short, clear motion: a row that is executed
    args = ([1.5] * 7, 0.2, 0.005, 100.0)
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals),
                               jnp.asarray([0, 1, 0]), jnp.asarray(0.5 * (starts + goals)),
                               *map(jnp.asarray, args))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jbest, jrep = js.make_round_solver(jmodel, jcfg)(jp0, jnp.asarray(starts), jnp.asarray(goals), keys)
    step_keys = [jax.random.split(k, STEPS + 1) for k in keys]
    noise = ts.SolveNoise(
        steps=[jax_path_noise([sk[i] for sk in step_keys], 7, M + 2, S, NB) for i in range(STEPS)],
        posterior=jax_path_noise([sk[-1] for sk in step_keys], 7, M + 2, K, NB))
    tp0 = params_from_numpy({k: np.asarray(getattr(jp0, k)) for k in tm.PlannerParams.names()})
    tbest, trep = ts.make_round_solver(tmodel, tcfg)(tp0, starts, goals, noise=noise)
    return np.asarray(jbest), jax.tree.map(np.asarray, jrep), tbest, trep, (tmodel, starts, goals)


def test_round_best_matches_jax(rounds):
    jbest, _, tbest, _, _ = rounds
    assert tuple(tbest.shape) == jbest.shape == (B, 10, 7)
    np.testing.assert_allclose(tbest.numpy(), jbest, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("field", BOOLS + FLOATS)
def test_round_report_matches_jax(rounds, field):
    _, jrep, _, trep, _ = rounds
    want, got = getattr(jrep, field), report_to_numpy(trep)[field]
    assert got.shape == want.shape == (B,)
    if field in BOOLS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_round_report_is_the_validator_on_best(rounds):
    """The round's report is ``execute_and_validate`` of its own best sample,
    and the batch holds both verdicts."""
    _, _, tbest, trep, (tmodel, starts, goals) = rounds
    assert isinstance(trep, ValidationReport)
    again = execute_and_validate(tmodel.collision, tbest, torch.as_tensor(starts),
                                 torch.as_tensor(goals), tmodel.limits_low, tmodel.limits_high)
    for a, b in zip(trep, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert trep.endpoints_ok.all() and trep.limits_ok.all()
    assert trep.executed.any() and not trep.executed.all()
