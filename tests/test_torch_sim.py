"""Port parity: the closed-form PD path and the kinematic executor
(``vgpmp_torch/sim.py`` against ``vgpmp_tpu/sim.py``).

The same numpy trajectories go through the JAX functions under ``jax.vmap``
and through the port's batched functions, both in float64 on the small franka
planner. Indices and bools must be equal; floats agree to 1e-12 (the two
compilers may fuse a multiply-add differently).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_support import jax_report_rows, metric_trajectories, planner_models
from vgpmp_tpu import sim as jsim
from vgpmp_torch import sim as tsim

PATH_OUTPUTS = ["qs", "visited", "seg_idx", "n_stops", "entries", "q_last", "certified"]
KINDS = ["smooth", "wiggly", "repeated", "still", "over_budget", "zigzag"]


@pytest.fixture(scope="module")
def setup():
    jspec, jmodel, tmodel = planner_models()
    trajs = metric_trajectories(np.random.default_rng(0), jspec.limits_low, jspec.limits_high)
    batch = np.stack([trajs[k] for k in KINDS])
    return jmodel, tmodel, batch


@pytest.fixture(scope="module")
def paths(setup):
    _, _, batch = setup
    want = jax_report_rows(lambda t: jsim.pd_path_configs(t), batch)
    got = tsim.pd_path_configs(torch.as_tensor(batch))
    return dict(zip(PATH_OUTPUTS, want)), dict(zip(PATH_OUTPUTS, got))


@pytest.mark.parametrize("name", PATH_OUTPUTS)
def test_pd_path_configs_match_jax(paths, name):
    want, got = paths[0][name], paths[1][name].numpy()
    assert got.shape == want.shape
    if want.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pd_path_cases_are_what_they_claim(paths):
    """The inputs do reach the branches they are there for."""
    _, got = paths
    kind = {k: i for i, k in enumerate(KINDS)}
    n_stops = got["n_stops"].numpy()
    assert (n_stops[kind["repeated"]] == 0).sum() >= 8       # ties in the cumulative count
    assert n_stops[kind["still"]].sum() == 0                 # total = 0
    assert not got["visited"][kind["still"]].any()
    assert (got["seg_idx"][kind["still"]] == 0).all()
    assert not got["certified"][[kind["over_budget"], kind["zigzag"]]].any()
    assert got["certified"][[kind[k] for k in ("smooth", "wiggly", "repeated", "still")]].all()
    # a probe never lands in a segment without motion
    row = kind["repeated"]
    assert (n_stops[row][got["seg_idx"][row].numpy()] > 0).all()


def test_pd_path_single_trajectory_is_a_batch_row(setup):
    _, _, batch = setup
    one = tsim.pd_path_configs(torch.as_tensor(batch[1]))
    many = tsim.pd_path_configs(torch.as_tensor(batch))
    for a, b in zip(one, many):
        assert a.shape == b.shape[1:]
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)


@pytest.mark.parametrize("floor", ["global", "penetration_floor", "taper"])
def test_kinematic_executor_matches_jax(setup, floor):
    jmodel, tmodel, batch = setup
    starts, goals = batch[:, 0] + 0.02, batch[:, -1] - 0.02
    pen = np.array([-0.02, -0.2, -0.01, -0.05, -0.3, -0.1])
    if floor == "global":
        jfn = lambda t, s, g, p: jsim.kinematic_execute_trajectory(jmodel.collision, t)
        kw = {}
    elif floor == "penetration_floor":
        jfn = lambda t, s, g, p: jsim.kinematic_execute_trajectory(
            jmodel.collision, t, penetration_floor=p)
        kw = dict(penetration_floor=torch.as_tensor(pen))
    else:
        jfn = lambda t, s, g, p: jsim.kinematic_execute_trajectory(
            jmodel.collision, t, taper=(s, g, 0.5))
        kw = dict(taper=(torch.as_tensor(starts), torch.as_tensor(goals), 0.5))
    w_ok, w_reached, w_q = jax_report_rows(jfn, batch, starts, goals, pen)
    ok, reached, q_final = tsim.kinematic_execute_trajectory(tmodel.collision,
                                                             torch.as_tensor(batch), **kw)
    np.testing.assert_array_equal(ok.numpy(), w_ok)
    np.testing.assert_array_equal(reached.numpy(), w_reached)
    np.testing.assert_allclose(q_final.numpy(), w_q, rtol=0, atol=1e-12)
    assert w_ok.any() and not w_ok.all()  # both verdicts occur in the batch


def test_kinematic_executor_nan_row_fails_alone(setup):
    """A diverged row is never executed; the other rows are untouched."""
    _, tmodel, batch = setup
    clean = tsim.kinematic_execute_trajectory(tmodel.collision, torch.as_tensor(batch))
    bad = batch.copy()
    bad[3, 4:] = np.nan  # a row that executes when it is finite
    assert bool(clean[0][3])
    ok, reached, q_final = tsim.kinematic_execute_trajectory(tmodel.collision, torch.as_tensor(bad))
    assert not bool(ok[3]) and not reached[3, 4:].any()
    keep = [0, 1, 2, 4, 5]
    for a, b in zip((ok, reached, q_final), clean):
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0)


def test_closed_form_executor_matches_stepped_twin(setup):
    """The closed-form executor agrees with the literal step-by-step PD loop
    under the same global floor: same verdict, and the final config to one
    controller step where the path is free."""
    _, tmodel, batch = setup
    col = tmodel.collision
    blocked, free = torch.as_tensor(batch[0][:8]), torch.as_tensor(batch[2][:8])
    for traj, want in ((blocked, False), (free, True)):
        ok_d, reached_d, q_d = tsim.kinematic_execute_trajectory(col, traj)
        ok_s, reached_s, q_s = tsim.kinematic_execute_trajectory_stepped(col, traj)
        assert bool(ok_d) == bool(ok_s) == want
        if want:
            torch.testing.assert_close(reached_d, reached_s)
            torch.testing.assert_close(q_d, q_s, rtol=0, atol=0.5 / 240.0 + 1e-9)
        else:  # blocked at the same waypoint
            assert int(reached_d.int().argmin()) == int(reached_s.int().argmin())
    both = tsim.kinematic_execute_trajectory_stepped(col, torch.stack([blocked, free]))
    assert both[0].tolist() == [False, True] and both[1].shape == (2, 8)


class _PocketCollision:
    """Stub without the eval methods: one-sphere clearance with two
    penetration pockets in the (q0, q1) plane (as the JAX package's
    tapered-floor test)."""

    def sphere_clearance(self, q):
        q0, q1 = q[..., 0], q[..., 1]

        def bump(c0):
            d = torch.maximum((q0 - c0).abs(), q1.abs())
            return torch.clamp(1.0 - d / 0.3, min=0.0)

        return (0.1 - 0.13 * bump(0.0) - 0.12 * bump(2.0))[..., None]


def test_stub_without_eval_method_and_tapered_floor():
    """``_eval_clearance_fn`` falls back to ``sphere_clearance``; the global
    floor lets a mid-route dive ride the start's depth, the tapered floor
    blocks it and still lets the arm leave its own pocket."""
    from vgpmp_torch.engine.validator import execution_success

    col = _PocketCollision()
    lin = lambda a, b, n: torch.as_tensor(np.linspace(a, b, n))
    start, goal, mid = np.zeros(4), np.array([4.0, 0, 0, 0]), np.array([2.0, 1.0, 0, 0])
    direct = lin(start, goal, 60)
    detour = torch.cat([lin(start, mid, 30), lin(mid, goal, 30)])
    s, g = torch.as_tensor(start), torch.as_tensor(goal)
    assert bool(execution_success(col, direct, s, g, taper_radius=None))
    assert not bool(execution_success(col, direct, s, g))
    got = execution_success(col, torch.stack([direct, detour]), torch.stack([s, s]),
                            torch.stack([g, g]))
    assert got.tolist() == [False, True]
