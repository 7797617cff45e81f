"""Checks of the port's plain (CPU) path against the plain reference on the
``ur10-bookshelves`` configuration (6 joints, standard DH, 17 spheres on 5
chain frames, the base as the reference's benchmark script sets it, the
bookshelves grid, a constant learning rate), at a tiny size in float64: that
the arm reaches into the shelves, the FK to the 17 spheres, both grid
lookups, the ELBO with its gradient and Adam's change, the metric's verdicts
and the engine's bookkeeping. Both test suites call
them: ``benchmark/tests/test_benchmark_ur10.py`` and the repository's
``tests/test_torch_ur10_bookshelves.py``."""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.harness import check
from benchmark.reference import engine as ref_engine
from benchmark.reference import metric as ref_metric
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT, TINY
from benchmark.tests.test_benchmark_reference import configs

CONFIG = ROOT / "benchmark/configs/ur10-bookshelves.json"


def config() -> dict:
    return json.loads(CONFIG.read_text())


def session_and_problem(dtype=torch.float64):
    """The configuration's session at :data:`TINY`'s budget on the CPU, and
    the reference's problem."""
    from vgpmp_torch.session import PlanningSession

    cfg = config()
    pp = dict(cfg["planner_params"], **TINY)
    sess = PlanningSession("ur10", "bookshelves", dtype=dtype, sdf_mode="packed", use_tuned=True, device="cpu",
                           overrides=pp)
    return sess, ref.Problem.load(ROOT / cfg["assets"], "ur10", "bookshelves", pp, "cpu")


def check_configuration(sess, pb) -> None:
    """The file states what the session runs: the published parameters with
    the tuned overlay, the train settings, the shapes; no schedule, no σ
    continuation; the reference reads the arm the session reads."""
    from vgpmp_torch.session import PlanningSession

    cfg = config()
    full = PlanningSession("ur10", "bookshelves", dtype=torch.float32, sdf_mode="packed", use_tuned=True,
                           device="cpu")
    assert full.planner_params == cfg["planner_params"] == dict(cfg["published_planner_params"],
                                                                **cfg["tuned_overlay"])
    t = full.train_config
    assert {k: getattr(t, k) for k in cfg["train"]} == cfg["train"]
    assert (t.lr_peak, t.sigma_anneal) == (0.0, 1.0)
    fk = full.model.collision.fk
    sh = cfg["shapes"]
    assert (fk.dof, fk.craig, fk.sphere_radii.shape[0]) == (sh["joints"], False, sh["spheres"]) == (pb.L, pb.craig,
                                                                                                  pb.P)
    assert full.model.num_inducing + 2 == sh["inducing_with_clamped_ends"]
    assert full.model.num_bases == sh["num_bases"] and full.num_queries == sh["queries"]
    assert tuple(full.sdf.data.shape) == tuple(sh["grid_cells"]) == tuple(pb.grid.shape)
    assert cfg["reduced"] == []
    # the base is not turned: the DH twist of pi on the first joint turns the chain
    torch.testing.assert_close(pb.base, torch.eye(4, dtype=torch.float64), rtol=0, atol=0)
    np.testing.assert_array_equal(full.base_pose, np.eye(4))
    assert sess.model.collision.fk.dof == 6


def check_the_arm_reaches_the_shelves(sess, pb) -> None:
    """The problemset's 11 states put the arm at the shelves, as every other
    robot's bookshelves states do: each state's worst sphere within 0.1 m of
    a shelf, some in contact; and the queries' straight lines touch the
    scene, so the ELBO's collision term and the metric have work."""
    S = torch.as_tensor(pb.states)
    worst = (ref.trilinear_distance(pb, ref.sphere_positions(pb, S)) - pb.radii).min(dim=-1).values
    assert (worst < 0.1).all() and (worst < 0).any(), worst
    starts, goals = (torch.as_tensor(x) for x in sess.queries())
    frac = torch.linspace(0, 1, 70, dtype=torch.float64)[None, :, None]
    lines = starts[:, None] + (goals - starts)[:, None] * frac
    clear = ref.trilinear_distance(pb, ref.sphere_positions(pb, lines)) - pb.radii
    hinge = (clear < pb.pp["epsilon"]).any(dim=-1)
    assert hinge.float().mean() > 0.5 and (clear < 0).any(dim=-1).any(dim=-1).float().mean() > 0.5


def check_sphere_positions(sess, pb) -> None:
    from vgpmp_torch.kinematics.dh import sphere_positions

    q = configs(pb, 200)
    np.testing.assert_allclose(ref.sphere_positions(pb, q), sphere_positions(sess.model.collision.fk, q), atol=1e-12)


def check_lookups(sess, pb) -> None:
    """The packed nearest cell (value and stored gradient) and the trilinear
    lookup on the bookshelves grid, at sphere centres of random
    configurations (many of them outside the grid: its border's cells) and
    at points drawn inside the grid's box."""
    from vgpmp_torch.sdf.grid import packed_lookup_plain, trilinear_distance

    scene = sess.scene
    lo = scene.base_offset + scene.base.origin
    box = scene.base.delta * (torch.tensor(scene.base.shape, dtype=torch.float64) - 1)
    inner = lo + box * torch.rand((4000, 3), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    pos = torch.cat([ref.sphere_positions(pb, configs(pb, 400, 1)).reshape(-1, 3), inner])
    rel = pos - scene.base_offset
    v, g = packed_lookup_plain(scene.base_packed, rel)
    p = pos.clone().requires_grad_(True)
    d = ref.packed_distance(pb, p)
    (gd,) = torch.autograd.grad(d.sum(), p)
    same = torch.isclose(d.detach(), v)
    assert same.float().mean() > 0.999  # a centre on a cell face may fall in either cell
    np.testing.assert_array_equal(gd[same], g[same])
    np.testing.assert_allclose(ref.trilinear_distance(pb, pos), trilinear_distance(scene.base, rel), atol=1e-12)
    assert (v[-4000:] < 0.05).any() and (v[-4000:] > 0.05).any()  # hinge-active cells and free ones


def check_elbo_gradient_and_adam(sess, pb, rows: int = 5, block: int = 2) -> None:
    """Three steps on the benchmark's own draws: the ELBO of every step to
    1e-9, the parameters after Adam's steps at the constant learning rate to
    1e-7."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.gp.pathwise import PathNoise

    model, cfg = sess.model, sess.train_config
    starts, goals = (torch.as_tensor(x[:rows]) for x in sess.queries())
    B, S, L, nb, Mc = rows, model.num_samples, pb.L, model.num_bases, model.num_inducing + 2
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
    assert float(ref.lr_at(train, torch.tensor([0, 2]))[1]) == cfg.learning_rate  # constant
    adam = ref.Adam(train, p)
    X = torch.linspace(0, 1, cfg.time_spacing_X, dtype=torch.float64)
    moved = False
    for j, d in enumerate(steps):
        v, g = ref.elbo_and_grad(pb, p, starts, goals, X, d, block=block)
        np.testing.assert_allclose(v, hist[:, j], rtol=1e-9)
        p = adam.step(p, g)
    for k in ref.LEAVES:
        np.testing.assert_allclose(p[k], getattr(st.params, k), rtol=1e-7, atol=1e-9)
        moved |= bool((getattr(st.params, k) != getattr(p0, k)).any())
    assert moved


def noisy_lines(sess, noise: float = 0.05, seed: int = 5):
    """The problemset's 55 queries' straight lines, bent by ``noise`` rad:
    ``(traj, starts, goals)``."""
    starts, goals = (torch.as_tensor(x) for x in sess.queries())
    T = sess.train_config.time_spacing_Xnew
    g = torch.Generator().manual_seed(seed)
    frac = torch.linspace(0, 1, T, dtype=torch.float64)[None, :, None]
    traj = starts[:, None] + (goals - starts)[:, None] * frac
    traj = traj + noise * torch.randn(traj.shape, generator=g, dtype=torch.float64) * torch.sin(np.pi * frac)
    return traj, starts, goals


def check_metric_verdicts(sess, pb) -> None:
    """The metric on 55 bent trajectories: the verdicts of every row a probe
    decides, and every worst clearance to 1e-9 m; rows executed and rows
    not."""
    from vgpmp_torch.engine.validator import execute_and_validate

    traj, starts, goals = noisy_lines(sess)
    rep = execute_and_validate(sess.model.collision, traj, starts, goals, sess.model.limits_low,
                               sess.model.limits_high)
    j = ref_metric.judge(pb, traj, starts, goals)
    decided = ~j["undecided"]
    assert decided.float().mean() > 0.9
    np.testing.assert_array_equal(rep.executed[decided], j["executed"][decided])
    np.testing.assert_array_equal(rep.success[decided], j["success"][decided])
    np.testing.assert_allclose(rep.min_clearance, j["min_clearance"], atol=1e-9)
    assert 0 < int(j["executed"].sum()) < len(traj)


def check_engine_replay() -> None:
    """``solve_adaptive`` with the configuration's inits (frand4, linear,
    zeros), 5 rounds at most, against the reference engine's replay of its
    rounds; a wrong answer and a dropped round are caught."""
    from vgpmp_torch.engine import solver

    sess, _ = session_and_problem(torch.float32)
    starts, goals = sess.queries()
    starts, goals = starts[:10], goals[:10]
    rounds = []
    inner = solver.make_round_solver(sess.model, sess.train_config)

    def solve(params, s, g, generator=None, noise=None):
        best, reps = inner(params, s, g, generator, noise)
        rounds.append({"starts": np.asarray(s), "goals": np.asarray(g), "best": best.numpy(),
                       **{f: getattr(reps, f).numpy() for f in ("executed", "success", "min_clearance")}})
        return best, reps

    inits = tuple(config()["planner_params"]["q_mu_inits"])
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
