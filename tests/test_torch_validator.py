"""Port parity: the trajectory validator and the fused metric
(``vgpmp_torch/engine/validator.py`` against ``vgpmp_tpu/engine/validator.py``).

One batch holds a trajectory that passes, one that collides mid-route, one
that misses its goal by more than 0.05 rad, one that leaves the joint limits
and one that turns NaN half way. It goes through the JAX functions under
``jax.vmap`` and through the port's batched functions, both in float64 on the
small franka planner. Every bool field must be equal; ``min_clearance`` and
``max_endpoint_err`` agree to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_report_rows, metric_trajectories, planner_models
from vgpmp_tpu.engine import solver as jsolver
from vgpmp_tpu.engine import validator as jv
from vgpmp_torch.convert import report_from_numpy, report_to_numpy
from vgpmp_torch.engine import solver as tsolver
from vgpmp_torch.engine import validator as tv

ROWS = ["passes", "collides", "misses_goal", "leaves_limits", "nan"]
BOOLS = ["success", "collision_free", "endpoints_ok", "limits_ok", "velocity_ok", "executed"]
FLOATS = ["min_clearance", "max_endpoint_err"]


@pytest.fixture(scope="module")
def setup():
    jspec, jmodel, tmodel = planner_models()
    lo, hi = jspec.limits_low, jspec.limits_high
    tr = metric_trajectories(np.random.default_rng(0), lo, hi)
    out_of_box = tr["still"].copy()
    out_of_box[:, 6] = np.linspace(hi[6] - 0.5, hi[6] + 0.1, len(out_of_box))
    nan = tr["wiggly"].copy()
    nan[5:] = np.nan
    trajs = np.stack([tr["repeated"], tr["smooth"], tr["still"], out_of_box, nan])
    starts, goals = trajs[:, 0].copy(), trajs[:, -1].copy()
    goals[2, 3] += 0.08
    goals[4] = tr["wiggly"][-1]
    return jspec, jmodel, tmodel, trajs, starts, goals


def _compare(got: tv.ValidationReport, want):
    got = report_to_numpy(got)
    for name in BOOLS:
        if getattr(want, name) is None:
            assert got[name] is None, name
        else:
            np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)), err_msg=name)
    for name in FLOATS:
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-9, err_msg=name)


def test_execute_and_validate_matches_jax(setup):
    _, jmodel, tmodel, trajs, starts, goals = setup
    want = jax_report_rows(
        lambda t, s, g: jv.execute_and_validate(jmodel.collision, t, s, g, jmodel.limits_low,
                                                jmodel.limits_high), trajs, starts, goals)
    got = tv.execute_and_validate(tmodel.collision, torch.as_tensor(trajs), torch.as_tensor(starts),
                                  torch.as_tensor(goals), tmodel.limits_low, tmodel.limits_high)
    _compare(got, want)
    row = dict(zip(ROWS, range(5)))
    # the batch holds the cases it claims to
    assert got.success.tolist() == [True, False, False, False, False]
    assert got.executed.tolist() == [True, False, False, True, False]
    assert not got.collision_free[row["collides"]] and got.endpoints_ok[row["collides"]]
    assert got.collision_free[row["misses_goal"]] and not got.endpoints_ok[row["misses_goal"]]
    assert got.collision_free[row["leaves_limits"]] and not got.limits_ok[row["leaves_limits"]]
    assert got.limits_ok[[0, 1, 2]].all()
    assert not got.executed[row["nan"]] and not got.success[row["nan"]]
    assert torch.isnan(got.max_endpoint_err).tolist() == [False] * 4 + [True]


def test_execute_and_validate_nan_row_leaves_the_others_untouched(setup):
    _, _, tmodel, trajs, starts, goals = setup
    args = (tmodel.limits_low, tmodel.limits_high)
    full = tv.execute_and_validate(tmodel.collision, torch.as_tensor(trajs), torch.as_tensor(starts),
                                   torch.as_tensor(goals), *args)
    part = tv.execute_and_validate(tmodel.collision, torch.as_tensor(trajs[:4]),
                                   torch.as_tensor(starts[:4]), torch.as_tensor(goals[:4]), *args)
    for a, b in zip(full, part):
        torch.testing.assert_close(a[:4], b, rtol=0, atol=0)
    one = tv.execute_and_validate(tmodel.collision, torch.as_tensor(trajs[1]),
                                  torch.as_tensor(starts[1]), torch.as_tensor(goals[1]), *args)
    for a, b in zip(full, one):  # a single trajectory is that batch row, as scalars
        assert b.shape == ()
        torch.testing.assert_close(a[1], b, rtol=0, atol=0)


@pytest.mark.parametrize("branch", ["tapered", "global", "margin", "velocity_fast",
                                    "velocity_slow"])
def test_validate_trajectory_matches_jax(setup, branch):
    jspec, jmodel, tmodel, trajs, starts, goals = setup
    kw = {"tapered": {}, "global": dict(taper_radius=None), "margin": dict(clearance_margin=-0.05),
          "velocity_fast": dict(duration=0.05), "velocity_slow": dict(duration=20.0)}[branch]
    jkw, tkw = dict(kw), dict(kw)
    if branch.startswith("velocity"):
        jkw["velocity_limits"] = jnp.asarray(jspec.velocity_limits)
        tkw["velocity_limits"] = jspec.velocity_limits
    want = jax_report_rows(
        lambda t, s, g: jv.validate_trajectory(jmodel.collision, t, s, g, jmodel.limits_low,
                                               jmodel.limits_high, **jkw), trajs, starts, goals)
    got = tv.validate_trajectory(tmodel.collision, torch.as_tensor(trajs), torch.as_tensor(starts),
                                 torch.as_tensor(goals), tmodel.limits_low, tmodel.limits_high, **tkw)
    _compare(got, want)
    if branch == "velocity_fast":
        assert not got.velocity_ok[[0, 1, 3]].any() and not got.success.any()
    elif branch == "velocity_slow":
        assert got.velocity_ok[:4].all()
    else:
        assert got.velocity_ok.all()
        assert got.success.any() and not got.success.all()


@pytest.mark.parametrize("taper_radius", [0.5, None])
def test_execution_success_matches_jax(setup, taper_radius):
    _, jmodel, tmodel, trajs, starts, goals = setup
    want = jax_report_rows(
        lambda t, s, g: jv.execution_success(jmodel.collision, t, s, g, taper_radius=taper_radius),
        trajs, starts, goals)
    got = tv.execution_success(tmodel.collision, torch.as_tensor(trajs), torch.as_tensor(starts),
                               torch.as_tensor(goals), taper_radius=taper_radius)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_densify_matches_jax(setup):
    trajs = setup[3][:4]
    want = jax_report_rows(lambda t: jv.densify(t, 8), trajs)
    got = tv.densify(torch.as_tensor(trajs), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    torch.testing.assert_close(tv.densify(torch.as_tensor(trajs[0]), 8), got[0], rtol=0, atol=0)


def test_ensemble_score_is_bit_equal_float32():
    rng = np.random.default_rng(2)
    executed, success = rng.random(64) < 0.5, rng.random(64) < 0.5
    clearance = rng.normal(scale=0.1, size=64)
    clearance[:4] = [np.nan, 20.0, -20.0, 0.0]
    want = np.asarray(jsolver.ensemble_score(jnp.asarray(executed), jnp.asarray(success),
                                             jnp.asarray(clearance)))
    got = tsolver.ensemble_score(torch.as_tensor(executed), torch.as_tensor(success),
                                 torch.as_tensor(clearance))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == -np.inf and torch.isfinite(got[1:]).all()


def test_report_round_trip(setup):
    _, jmodel, _, trajs, starts, goals = setup
    want = jax_report_rows(
        lambda t, s, g: jv.execute_and_validate(jmodel.collision, t, s, g, jmodel.limits_low,
                                                jmodel.limits_high), trajs, starts, goals)
    rep = report_from_numpy(want)
    assert isinstance(rep, tv.ValidationReport) and rep.executed.dtype == torch.bool
    back = report_to_numpy(rep)
    for name in tv.ValidationReport._fields:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(want, name)))
    half = report_from_numpy({**back, "executed": None})
    assert half.executed is None and report_to_numpy(half)["executed"] is None
