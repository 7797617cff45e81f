"""The metric's fused probe pass (``vgpmp_torch/sim.py:probe_clearance_plain``,
the plain version of K3's ``k3_probe_clearance``) and its call sites.

- The plain pass is bit-equal to the composition it replaces: the probes'
  worst clearance, ``tapered_floor``, the compare, and the per-segment count
  by ``scatter_add_``.
- ``execute_and_validate`` and the tapered ``kinematic_execute_trajectory``
  give the reports of that composition and of the JAX package on the parity
  inputs of ``tests/test_torch_{validator,sim}.py``.
- One ``execute_and_validate`` calls the clearance function twice (the probes,
  and the ``[3B]`` endpoints in one call), the tapered executor twice too.
"""

import numpy as np
import pytest
import torch

from _torch_support import jax_report_rows, metric_trajectories, planner_models
from vgpmp_tpu import sim as jsim
from vgpmp_tpu.engine import validator as jv
from vgpmp_torch import sim as tsim
from vgpmp_torch.engine import validator as tv

RADIUS, SLACK = 0.5, 5e-3


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
    return jmodel, tmodel, trajs, starts, goals


def _seeded_paths(lo, hi, B=5, T=12, seed=3):
    """``B`` numpy-seeded waypoint paths through the franka box, with a row
    without motion (1) and a row that turns NaN half way (3)."""
    rng = np.random.default_rng(seed)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    a = mid + 0.5 * half * rng.uniform(-1, 1, (B, len(lo)))
    b = mid + 0.5 * half * rng.uniform(-1, 1, (B, len(lo)))
    w = np.linspace(0, 1, T)[None, :, None]
    traj = a[:, None] * (1 - w) + b[:, None] * w + 0.03 * rng.normal(size=(B, T, len(lo)))
    traj[1] = traj[1, :1]
    traj[3, T // 2:] = np.nan
    return traj


def _composition(min_clear, qs, visited, seg_idx, T, q_s, q_g):
    """The metric's pass as it was composed before the fused entry."""
    clear = min_clear(qs)
    floor = tsim.tapered_floor(min_clear, qs, q_s, q_g, RADIUS, SLACK)
    violated = visited & (clear < floor)
    count = torch.zeros((seg_idx.shape[0], T), dtype=torch.int32)
    return clear, count.scatter_add_(1, seg_idx, violated.to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_probe_clearance_plain_is_bit_equal_to_the_composition(setup, dtype):
    _, tmodel, _, _, _ = setup
    col = tmodel.collision  # float64; the float32 case rounds its clearances
    traj = torch.as_tensor(_seeded_paths(tmodel.limits_low.numpy(), tmodel.limits_high.numpy()),
                           dtype=dtype)
    B, T, L = traj.shape
    qs, visited, seg_idx, *_ = tsim.pd_path_configs(traj)
    q_s = (traj[:, 0] + 0.01).nan_to_num(0.3)
    q_g = traj[:, -1].nan_to_num(-0.2) - 0.01
    min_clear = lambda q: col.min_clearance_eval(q.to(torch.float64)).to(dtype)
    want_clear, want_count = _composition(min_clear, qs, visited, seg_idx, T, q_s, q_g)
    depth_s = torch.clamp(-min_clear(q_s), min=0.0)
    depth_g = torch.clamp(-min_clear(q_g), min=0.0)
    clear, count = tsim.probe_clearance_plain(min_clear, qs, q_s, q_g, depth_s, depth_g,
                                              visited[:, 0], seg_idx, T, RADIUS, SLACK)
    assert torch.equal(clear.isnan(), want_clear.isnan())
    assert torch.equal(clear.nan_to_num(7.0), want_clear.nan_to_num(7.0))
    assert torch.equal(count, want_count) and count.dtype == torch.int32 and count.shape == (B, T)
    # the rows are what they claim: no motion, NaN, and counts both zero and not
    assert not visited[1].any() and count[1].sum() == 0
    assert clear[3].isnan().any() and count[3].sum() >= 0
    assert (count > 0).any() and (count == 0).any()
    if dtype == torch.float64:  # the model's own entry takes the plain version on the CPU
        got = col.probe_clearance(qs, q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T,
                                  RADIUS, SLACK)
        assert torch.equal(got[1], count) and torch.equal(got[0].nan_to_num(7.0), clear.nan_to_num(7.0))


def _old_execute_and_validate(collision, traj, start, goal, lo, hi):
    """``execute_and_validate`` as it was composed before the fused probe pass
    (four clearance calls), for the fields the pass feeds."""
    T = traj.shape[1]
    mc = tsim._eval_clearance_fn(collision)
    qs, visited, seg_idx, n_stops, _, _, certified = tsim.pd_path_configs(traj)
    clear, count = _composition(mc, qs, visited, seg_idx, T, start, goal)
    blocked_upto = torch.cumsum((count > 0).to(torch.int32), dim=1) > 0
    reached_all = (((n_stops <= 2000) & certified[:, None]) & ~blocked_upto).all(dim=1)
    inf = torch.full_like(clear, float("inf"))
    min_clear = torch.minimum(torch.where(visited, clear, inf).amin(dim=1), mc(traj[:, 0]))
    return {"collision_free": count.sum(dim=1) == 0, "reached_all": reached_all,
            "min_clearance": min_clear}


@pytest.mark.parametrize("entry", ["execute_and_validate", "kinematic_taper"])
def test_call_sites_match_the_composition_and_jax(setup, entry):
    jmodel, tmodel, trajs, starts, goals = setup
    t, s, g = (torch.as_tensor(x) for x in (trajs, starts, goals))
    if entry == "execute_and_validate":
        got = tv.execute_and_validate(tmodel.collision, t, s, g, tmodel.limits_low,
                                      tmodel.limits_high)
        old = _old_execute_and_validate(tmodel.collision, t, s, g, tmodel.limits_low,
                                        tmodel.limits_high)
        want = jax_report_rows(
            lambda a, b, c: jv.execute_and_validate(jmodel.collision, a, b, c, jmodel.limits_low,
                                                    jmodel.limits_high), trajs, starts, goals)
        assert torch.equal(got.collision_free, old["collision_free"])
        assert torch.equal(got.executed, old["reached_all"] & got.endpoints_ok)
        np.testing.assert_allclose(got.min_clearance.numpy(), old["min_clearance"].numpy(),
                                   rtol=0, atol=1e-12)
        for name in ("success", "collision_free", "executed"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        np.testing.assert_allclose(got.min_clearance.numpy(), np.asarray(want.min_clearance),
                                   rtol=0, atol=1e-9)
        assert got.collision_free.any() and not got.collision_free.all()
    else:
        ok, reached, q_final = tsim.kinematic_execute_trajectory(tmodel.collision, t,
                                                                 taper=(s, g, RADIUS))
        old = _old_execute_and_validate(tmodel.collision, t, s, g, tmodel.limits_low,
                                        tmodel.limits_high)
        assert torch.equal(ok, old["reached_all"])
        w_ok, w_reached, w_q = jax_report_rows(
            lambda a, b, c: jsim.kinematic_execute_trajectory(jmodel.collision, a, taper=(b, c, RADIUS)),
            trajs, starts, goals)
        np.testing.assert_array_equal(ok.numpy(), w_ok)
        np.testing.assert_array_equal(reached.numpy(), w_reached)
        np.testing.assert_allclose(q_final.numpy(), w_q, rtol=0, atol=1e-12)


class _CountingStub:
    """A duck-typed collision model with only ``sphere_clearance``: a clearance
    field in joint space that is negative near the origin of (q0, q1). Counts
    its calls and the configs of each."""

    def __init__(self):
        self.calls = []

    def sphere_clearance(self, q):
        self.calls.append(tuple(q.shape[:-1]))
        r = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
        return torch.stack([r - 0.3, r - 0.25], dim=-1)


def test_one_call_for_the_probes_and_one_for_the_endpoints():
    rng = np.random.default_rng(4)
    B, T, L = 3, 10, 4
    traj = torch.as_tensor(np.cumsum(rng.normal(scale=0.1, size=(B, T, L)), axis=1) - 0.4)
    start, goal = traj[:, 0], traj[:, -1]
    stub = _CountingStub()
    rep = tv.execute_and_validate(stub, traj, start, goal, torch.full((L,), -9.0),
                                  torch.full((L,), 9.0), samples_per_segment=4)
    assert stub.calls == [(3 * B,), (B, T * 4)]  # [3B] endpoints, then the probes
    assert rep.executed.shape == (B,) and torch.isfinite(rep.min_clearance).all()
    stub.calls.clear()
    tsim.kinematic_execute_trajectory(stub, traj, taper=(start, goal, RADIUS), samples_per_segment=4)
    assert stub.calls == [(2 * B,), (B, T * 4)]
    # the global floor is unchanged: the probes and the first config
    stub.calls.clear()
    tsim.kinematic_execute_trajectory(stub, traj, samples_per_segment=4)
    assert stub.calls == [(B, T * 4), (B,)]
