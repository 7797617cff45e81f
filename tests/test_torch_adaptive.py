"""Port parity: the adaptive restart engine (``solve_adaptive``, its via-point
restarts and the probes behind them).

The via-point draws are numpy's in both packages, so on the same float64
session (franka/industrial, packed scene) the picks must be bit-equal. The
engine itself is held to JAX's by one shared numpy stub round solver, a
deterministic function of the initial ``q_mu``, the starts and the goals:
slot packing, modes, ``info`` and the merged result must be equal. With the
real round solver the random streams differ (JAX keys per slot, one
generator per round here), so the port-only tests check bookkeeping,
monotonicity and determinism, as the JAX package's own tests do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.engine.validator import ValidationReport as JaxReport
from vgpmp_tpu.session import PlanningSession as JaxSession
from vgpmp_torch.convert import params_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.engine.validator import ValidationReport
from vgpmp_torch.session import PlanningSession

LEAVES = ("q_mu", "q_sqrt", "lengthscales_u", "variance_u", "z_u", "sigma_obs_u", "alpha_u")


@pytest.fixture(scope="module")
def sessions():
    """franka/industrial in float64 with the packed scene, in both packages."""
    jsess = JaxSession("franka", "industrial", dtype=jnp.float64)
    tsess = PlanningSession("franka", "industrial", dtype=torch.float64, device="cpu")
    return jsess, tsess


def _anchors(sess, n, nan_row=None):
    lo, hi = sess.spec.limits_low, sess.spec.limits_high
    anc = lo + (hi - lo) * np.random.default_rng(4).uniform(0.1, 0.9, (n, len(lo)))
    if nan_row is not None:
        anc[nan_row] = np.nan
    return anc


@pytest.mark.parametrize("mode,anchors", [("rand3", None), ("frand5", None), ("detour1007", "anchors"),
                                          ("detour1007", "nan_row"), ("detour1012", None)])
def test_restart_waypoints_bit_equal_to_jax(sessions, mode, anchors):
    jsess, tsess = sessions
    starts, goals = tsess.queries()
    anc = None if anchors is None else _anchors(tsess, len(starts), 5 if anchors == "nan_row" else None)
    want = js.restart_waypoints(jsess.model, starts, goals, mode, anchors=anc)
    got = ts.restart_waypoints(tsess.model, starts, goals, mode, anchors=anc)
    assert got.shape == want.shape == (36, 7) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    if anchors == "nan_row":
        assert np.isnan(got[5]).all() and np.isfinite(np.delete(got, 5, axis=0)).all()
    if mode.startswith("frand"):
        # the pick is a clear candidate wherever one exists: most rows clear the margin
        flat = torch.as_tensor(got)
        assert (ts.min_clearance_probe(tsess.model.collision, flat) >= 0.03).float().mean() > 0.5


def test_restart_waypoints_modes_and_errors(sessions):
    jsess, tsess = sessions
    starts, goals = tsess.queries()
    for pkg, sess in ((js, jsess), (ts, tsess)):
        assert pkg.restart_waypoints(sess.model, starts, goals, "linear") is None
        with pytest.raises(ValueError, match="integer suffix"):
            pkg.restart_waypoints(sess.model, starts, goals, "frandx")
    cand, ref = ts.restart_candidates(tsess.model, starts, goals, "frand5")
    assert cand.shape == (36, 64, 7) and ref.shape == (36, 7)
    np.testing.assert_array_equal(ts.pick_via_points(cand, np.zeros((36, 64)), ref), cand[:, 0])


def _trajectories(sess, n=6, T=12):
    starts, goals = (x[:n] for x in sess.queries())
    w = np.linspace(0, 1, T)[None, :, None]
    rng = np.random.default_rng(8)
    trajs = starts[:, None] + (goals - starts)[:, None] * w + 0.3 * np.sin(np.pi * w) * rng.normal(size=(n, 1, 7))
    trajs[2] = np.nan                 # a diverged incumbent
    trajs[4, T // 2:] = np.nan        # one that turned NaN half way
    return trajs


def test_worst_violation_configs_match_jax(sessions):
    jsess, tsess = sessions
    trajs = _trajectories(tsess)
    want = js._worst_violation_configs(jsess.model.collision, trajs)
    got = ts.worst_violation_configs(tsess.model.collision, trajs)
    assert got.shape == want.shape == (6, 7) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


class _NanClearance:
    """A collision stand-in whose clearance is NaN where the config is: the
    case the packed lookup never gives (it clamps a NaN index to a cell)."""

    def __init__(self, fk):
        self.fk = fk

    def sphere_clearance(self, q):
        return q.sum(dim=-1, keepdim=True) * torch.linspace(1.0, 2.0, 3, dtype=q.dtype)


def test_worst_violation_argmin_nan_rule_is_jax(sessions):
    """A NaN clearance counts as the minimum and the first NaN wins, as in
    ``jnp.argmin``."""
    _, tsess = sessions
    trajs = _trajectories(tsess)
    trajs[1, 3, 0] = trajs[1, 7, 2] = np.nan
    got = ts.worst_violation_configs(_NanClearance(tsess.model.collision.fk), trajs)
    clear = np.min(trajs.sum(-1, keepdims=True) * np.linspace(1.0, 2.0, 3), axis=-1)
    idx = np.asarray(jnp.argmin(jnp.asarray(clear), axis=1))
    assert idx[1] == 3 and idx[2] == 0 and idx[4] == 6
    np.testing.assert_array_equal(got, trajs[np.arange(6), idx])


def test_init_slots_matches_jax(sessions):
    jsess, tsess = sessions
    starts, goals = (x[:12] for x in tsess.queries())
    modes = ["linear", "zeros", "waypoint", "frand5", "rand3", "detour1007", "frand5", "rand0",
             "detour1007", "linear", "frand0", "waypoint"]
    anc = _anchors(tsess, 12)
    want = js.init_slots(jsess.model, starts, goals, jsess.planner_params, modes, anchors=anc)
    got = params_to_numpy(ts.init_slots(tsess.model, starts, goals, tsess.planner_params, modes,
                                        anchors=anc))
    for k in LEAVES:
        assert got[k].shape == np.asarray(getattr(want, k)).shape, k
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), rtol=0, atol=1e-12, err_msg=k)
    lin = params_to_numpy(ts.init_batch(tsess.model, starts, goals, tsess.planner_params))
    np.testing.assert_array_equal(lin["q_mu"][[0, 9]], got["q_mu"][[0, 9]])
    for pkg, sess in ((js, jsess), (ts, tsess)):
        with pytest.raises(ValueError, match="unknown q_mu init mode"):
            pkg.init_slots(sess.model, starts[:2], goals[:2], sess.planner_params, ["linear", "spline"])


# --- the engine against JAX's, driven by one shared numpy round solver -------

T_STUB = 6


def stub_round(q_mu, starts, goals):
    """A deterministic stand-in for a scored round: ``(best [C, T, L], report
    fields [C])`` from the initial ``q_mu [C, M, L]``, starts and goals. The
    hash is rounded to 1e-6 so that the last-bit differences of the two
    packages' inits cannot move it. About a third of the slots execute and one
    in fourteen diverges (NaN trajectory and clearance)."""
    h = np.round(np.abs(q_mu).sum(axis=(1, 2)) + 3.0 * np.abs(goals - starts).sum(axis=1), 6)
    u = (h * 7919.0) % 1.0
    w = np.linspace(0.0, 1.0, T_STUB)[None, :, None]
    best = starts[:, None] + (goals - starts)[:, None] * w + (u - 0.5)[:, None, None] * np.sin(np.pi * w)
    diverged = u > 0.93
    best[diverged] = np.nan
    executed = u < 0.35
    success = executed | ((u > 0.7) & (u < 0.8))
    clear = np.where(diverged, np.nan, u - 0.5)
    ones = np.ones_like(executed)
    rep = dict(success=success, collision_free=success, endpoints_ok=ones, limits_ok=ones,
               min_clearance=clear, max_endpoint_err=0.01 * u, velocity_ok=ones, executed=executed)
    return best, rep


def _run_engines(sessions, monkeypatch, round_sizes, dp_size, seed):
    jsess, tsess = sessions
    starts, goals = tsess.queries()
    inits = tuple(tsess.planner_params["q_mu_inits"])
    log = {"jax": [], "torch": []}

    def recorder(pkg, name):
        init = pkg.init_slots

        def wrapped(model, s, g, pp, modes, anchors=None):
            log[name].append({"starts": np.array(s), "modes": list(modes),
                              "anchors": None if anchors is None else np.array(anchors)})
            return init(model, s, g, pp, modes, anchors=anchors)

        monkeypatch.setattr(pkg, "init_slots", wrapped)

    recorder(js, "jax")
    recorder(ts, "torch")

    def jax_solve(params, s, g, keys):
        best, rep = stub_round(np.asarray(params.q_mu), np.asarray(s), np.asarray(g))
        return jnp.asarray(best), JaxReport(**rep)

    def torch_solve(params, s, g, generator):
        assert isinstance(generator, torch.Generator)
        best, rep = stub_round(params.q_mu.numpy(), np.asarray(s), np.asarray(g))
        return torch.as_tensor(best), ValidationReport(**{k: torch.as_tensor(v) for k, v in rep.items()})

    jax_solve.dp_size = torch_solve.dp_size = dp_size
    kw = dict(inits=inits, max_rounds=8, seed=seed, round_sizes=round_sizes)
    jout = js.solve_adaptive(jsess.model, jsess.train_config, starts, goals, jsess.planner_params,
                             solve=jax_solve, **kw)
    tout = ts.solve_adaptive(tsess.model, tsess.train_config, starts, goals, tsess.planner_params,
                             solve=torch_solve, **kw)
    return jout, tout, log


@pytest.mark.parametrize("round_sizes,dp_size,seed", [(None, 1, 0), ((36, 10, 5), 4, 3)])
def test_solve_adaptive_matches_jax_on_a_shared_stub(sessions, monkeypatch, round_sizes, dp_size, seed):
    (jbest, jrep, jinfo), (tbest, trep, tinfo), log = _run_engines(sessions, monkeypatch, round_sizes,
                                                                    dp_size, seed)
    assert tinfo == jinfo
    assert len(log["torch"]) == len(log["jax"]) == jinfo["rounds"] >= 4
    sizes = [len(r["starts"]) for r in log["torch"]]
    assert sizes == [len(r["starts"]) for r in log["jax"]]
    assert set(sizes[1:]) <= ({36, 16} if round_sizes is None else {36, 12, 8})
    modes = [m for r in log["torch"] for m in r["modes"]]
    assert any(m.startswith("detour") for m in modes) and "waypoint" in modes
    for rj, rt in zip(log["jax"], log["torch"]):
        np.testing.assert_array_equal(rt["starts"], rj["starts"])
        assert rt["modes"] == rj["modes"]
        assert (rt["anchors"] is None) == (rj["anchors"] is None)
        if rt["anchors"] is not None:
            np.testing.assert_array_equal(rt["anchors"], rj["anchors"])
    assert tbest.shape == jbest.shape == (36, T_STUB, 7)
    np.testing.assert_array_equal(tbest, jbest)
    for k in ValidationReport._fields:
        np.testing.assert_array_equal(getattr(trep, k), np.asarray(getattr(jrep, k)), err_msg=k)
    assert isinstance(trep.executed, np.ndarray) and trep.executed.shape == (36,)


# --- the port's engine with its real round solver, at a tiny size ------------

TINY = dict(num_steps=10, num_samples=3, num_bases=32, num_inducing=6,
            time_spacing_X=8, time_spacing_Xnew=12)


@pytest.fixture(scope="module")
def tiny():
    sess = PlanningSession("franka", "industrial", dtype=torch.float64, sdf_mode="nearest",
                           overrides=TINY, use_tuned=False, device="cpu")
    cfg = dataclasses.replace(sess.train_config, num_posterior_samples=4)
    starts, goals = sess.queries()
    return sess, cfg, starts[:8], goals[:8], ts.make_round_solver(sess.model, cfg)


def test_adaptive_shapes_and_bookkeeping(tiny):
    sess, cfg, starts, goals, solve = tiny
    best, reps, info = ts.solve_adaptive(sess.model, cfg, starts, goals, sess.planner_params,
                                         inits=("linear", "zeros"), max_rounds=3, seed=0, solve=solve)
    assert best.shape == (8, 12, 7) and isinstance(best, np.ndarray)
    for k in ValidationReport._fields:
        assert getattr(reps, k).shape == (8,), k
    assert 1 <= info["rounds"] <= 3
    # B = 8 is below the default tail bucket of 16, so every round runs 8 slots
    assert info["spent"] == info["rounds"] * 8
    assert info["k_eff"] == pytest.approx(info["spent"] / 8)
    assert len(info["restarts_per_problem"]) == 8
    assert np.isfinite(best[reps.executed]).all()
    if not reps.executed.all():
        assert info["rounds"] == 3


def test_adaptive_monotone_vs_single_round(tiny):
    sess, cfg, starts, goals, solve = tiny
    _, reps1, info1 = ts.solve_adaptive(sess.model, cfg, starts, goals, sess.planner_params,
                                        inits=("linear",), max_rounds=1, seed=0, solve=solve)
    assert info1["rounds"] == 1
    _, reps3, _ = ts.solve_adaptive(sess.model, cfg, starts, goals, sess.planner_params,
                                    inits=("linear", "zeros"), max_rounds=3, seed=0, solve=solve)
    assert (reps3.executed | ~reps1.executed).all(), "adaptive rounds lost an executed problem"
    s1 = ts.ensemble_score(reps1.executed, reps1.success, reps1.min_clearance).numpy()
    s3 = ts.ensemble_score(reps3.executed, reps3.success, reps3.min_clearance).numpy()
    assert (s3 >= s1).all()


def test_adaptive_deterministic(tiny):
    sess, cfg, starts, goals, solve = tiny
    out = [ts.solve_adaptive(sess.model, cfg, starts, goals, sess.planner_params,
                             inits=("linear", "frand2"), max_rounds=2, seed=7, solve=solve)
           for _ in range(2)]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for k in ValidationReport._fields:
        np.testing.assert_array_equal(getattr(out[0][1], k), getattr(out[1][1], k))
    assert out[0][2] == out[1][2]
