"""The plain reference against the port's plain (CPU) path at a tiny size, in
float64 where both can be: the FK, both grid lookups, the ELBO and its
gradient, Adam, the metric's verdicts and the engine's bookkeeping. The
tests import both; the benchmark's runs never hand the reference anything of
the program's."""

import ast
import json

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.reference import engine as ref_engine
from benchmark.reference import metric as ref_metric
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT, TINY


def session_and_problem(robot, dtype=torch.float64):
    from vgpmp_torch.session import PlanningSession

    pp = dict(json.loads((ROOT / f"benchmark/configs/{robot}-industrial.json").read_text())["planner_params"],
              **TINY)
    sess = PlanningSession(robot, "industrial", dtype=dtype, device="cpu", overrides=pp)
    return sess, ref.Problem.load(ROOT / "vgpmp_tpu/assets", robot, "industrial", pp, "cpu")


@pytest.fixture(scope="module", params=["franka", "wam"])
def pair(request):
    return session_and_problem(request.param)


def configs(pb, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return pb.lo + (pb.hi - pb.lo) * torch.rand((n, pb.L), generator=g, dtype=torch.float64)


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "benchmark/reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("vgpmp_torch", "vgpmp_tpu", "jax", "jaxlib", "flax"), (p, n)


def test_sphere_positions(pair):
    from vgpmp_torch.kinematics.dh import sphere_positions

    sess, pb = pair
    q = configs(pb, 50)
    np.testing.assert_allclose(ref.sphere_positions(pb, q), sphere_positions(sess.model.collision.fk, q),
                               atol=1e-12)


def test_lookups(pair):
    from vgpmp_torch.sdf.grid import packed_lookup_plain, trilinear_distance

    sess, pb = pair
    pos = ref.sphere_positions(pb, configs(pb, 200, 1))
    scene = sess.scene
    rel = pos - scene.base_offset
    v, g = packed_lookup_plain(scene.base_packed, rel)
    p = pos.clone().requires_grad_(True)
    d = ref.packed_distance(pb, p)
    (gd,) = torch.autograd.grad(d.sum(), p)
    same = torch.isclose(d.detach(), v)
    assert same.float().mean() > 0.999  # a centre on a cell face may fall in either cell
    np.testing.assert_array_equal(gd[same], g[same])
    np.testing.assert_allclose(ref.trilinear_distance(pb, pos), trilinear_distance(scene.base, rel), atol=1e-12)


def test_elbo_gradient_and_adam(pair):
    from vgpmp_torch.engine import solver
    from vgpmp_torch.gp.pathwise import PathNoise

    sess, pb = pair
    model, cfg = sess.model, sess.train_config
    starts, goals = (torch.as_tensor(x[:5]) for x in sess.queries())
    B, S, L, nb, Mc = 5, model.num_samples, pb.L, model.num_bases, model.num_inducing + 2
    gen = torch.Generator().manual_seed(3)
    steps = [check.draws(gen, B, S, L, nb, Mc, "cpu") for _ in range(3)]
    init_state, train_chunk, _ = solver.make_resumable_solver(model, cfg)
    p0 = solver.init_slots(model, starts.numpy(), goals.numpy(), sess.planner_params, ["linear"] * B)
    nz = lambda d: PathNoise(*(x.double() for x in d))
    st, hist, _ = train_chunk(init_state(p0), starts, goals, noise=solver.SolveNoise([nz(d) for d in steps], None),
                              n=3)
    p = ref.init_linear(pb, starts, goals)
    for k in ref.LEAVES:
        np.testing.assert_allclose(p[k], getattr(p0, k), atol=1e-12)
    train = dict(pb.pp, beta1=cfg.beta1, beta2=cfg.beta2, num_steps=cfg.num_steps, warmup_steps=cfg.warmup_steps,
                 lr_peak=cfg.lr_peak, learning_rate=cfg.learning_rate, adam_eps=1e-8)
    adam = ref.Adam(train, p)
    X = torch.linspace(0, 1, cfg.time_spacing_X, dtype=torch.float64)
    for j, d in enumerate(steps):
        v, g = ref.elbo_and_grad(pb, p, starts, goals, X, d, block=2)
        np.testing.assert_allclose(v, hist[:, j], rtol=1e-9)
        p = adam.step(p, g)
    for k in ref.LEAVES:
        np.testing.assert_allclose(p[k], getattr(st.params, k), rtol=1e-7, atol=1e-9)


def test_metric_verdicts(pair):
    from vgpmp_torch.engine.validator import execute_and_validate

    sess, pb = pair
    starts, goals = (torch.as_tensor(x) for x in sess.queries())
    T = sess.train_config.time_spacing_Xnew
    g = torch.Generator().manual_seed(5)
    frac = torch.linspace(0, 1, T, dtype=torch.float64)[None, :, None]
    traj = starts[:, None] + (goals - starts)[:, None] * frac
    traj = traj + 0.05 * torch.randn(traj.shape, generator=g, dtype=torch.float64) * torch.sin(np.pi * frac)
    rep = execute_and_validate(sess.model.collision, traj, starts, goals, sess.model.limits_low,
                               sess.model.limits_high)
    j = ref_metric.judge(pb, traj, starts, goals)
    decided = ~j["undecided"]
    assert decided.float().mean() > 0.9
    np.testing.assert_array_equal(rep.executed[decided], j["executed"][decided])
    np.testing.assert_array_equal(rep.success[decided], j["success"][decided])
    np.testing.assert_allclose(rep.min_clearance, j["min_clearance"], atol=1e-9)
    assert 0 < int(j["executed"].sum()) < len(traj) or True


def test_engine_replay_matches_solve_adaptive():
    from vgpmp_torch.engine import solver

    sess, _ = session_and_problem("franka", torch.float32)
    starts, goals = sess.queries()
    starts, goals = starts[:10], goals[:10]
    rounds = []
    inner = solver.make_round_solver(sess.model, sess.train_config)

    def solve(params, s, g, generator=None, noise=None):
        best, reps = inner(params, s, g, generator, noise)
        rounds.append({"starts": np.asarray(s), "goals": np.asarray(g), "best": best.numpy(),
                       **{f: getattr(reps, f).numpy() for f in ("executed", "success", "min_clearance")}})
        return best, reps

    inits = ("frand5", "frand0", "rand0")
    best, reps, info = solver.solve_adaptive(sess.model, sess.train_config, starts, goals, sess.planner_params,
                                             inits=inits, max_rounds=5, seed=7, solve=solve, round_sizes=(10, 4))
    answer = {"best": best, "executed": reps.executed, "success": reps.success,
              "min_clearance": reps.min_clearance}
    assert ref_engine.replay(starts, goals, rounds, 5, (10, 4), 1, answer) == {"slots": 0, "answers": 0,
                                                                                  "rounds": 0}
    assert info["rounds"] == len(rounds) > 1
    bad = dict(answer, executed=~np.asarray(answer["executed"]))
    assert ref_engine.replay(starts, goals, rounds, 5, (10, 4), 1, bad)["answers"] == 10
    assert ref_engine.replay(starts, goals, rounds[:1], 5, (10, 4), 1, answer)["rounds"] == int(
        not np.asarray(rounds[0]["executed"]).all())
