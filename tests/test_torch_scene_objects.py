"""Port parity: franka/industrial with objects in its scene, against JAX.

Both packages build the same objects with their own ``SceneBuilder`` (the
table, the duck, the pringles can and the boxes scene's grid as a grid
object, where the queries' straight-line paths sweep) and hand the extras to
their ``PlanningSession``, in float64 with the packed scene and a small
training budget (S = 2, N = 8, the robot's full 37 spheres). On the CPU the
port composes through ``Scene.distance``, the plain version of K1 and K3.

Tolerances: the collision log-density and the metric's clearance agree to
1e-10 relative (the same cells gathered; float64 sums in another order);
d/dq to 1e-10 of the largest, with NaN in the same places (a sphere centre
inside the table: JAX's norm has a NaN gradient at 0). A 4-step solve with
JAX's draws injected, in which the guard skips a row's step in both
packages, and a scored round agree to 1e-6 relative, the bound optax's
float32 learning-rate schedule sets (``test_torch_solver.py``); verdicts are
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise, source_wins
from vgpmp_tpu import scene as jscene
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.engine import validator as jval
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_tpu.sdf import grid as jg
from vgpmp_tpu.session import PlanningSession as JaxSession
from vgpmp_torch import scene as tscene
from vgpmp_torch.convert import params_from_numpy, params_to_numpy, report_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.engine.validator import execute_and_validate
from vgpmp_torch.likelihoods import collision as tcol
from vgpmp_torch.models import vgpmp as tm
from vgpmp_torch.robots import ASSET_DIR
from vgpmp_torch.sdf import grid as tg
from vgpmp_torch.session import PlanningSession

# the objects of chip_smoke.py's phase (o), world positions in metres, and an
# 8 cm box ("marker", an explicit spec) on the straight path of query 7 at
# the training time 3/7, around its sphere 30: samples of that row enter it
# at some steps and not at others
OBJECTS = (("table", (0.9, 0.0, -0.25)), ("duck", (0.5, 0.3, 0.5)), ("pringles", (0.4, -0.4, 0.4)),
           ("boxes", (0.3, 0.5, 0.4)), ("marker", (-0.2333, -0.1535, 0.9122)))
MARKER = {"kind": "box", "half_extents": [0.04, 0.04, 0.04]}
ROWS = [0, 7, 2]
B, S, M, NB, STEPS, K = 3, 2, 4, 64, 4, 4
TRAIN = dict(num_samples=S, num_bases=NB, num_inducing=M, time_spacing_X=8, time_spacing_Xnew=10,
             num_steps=STEPS)
BOOLS = ["success", "collision_free", "endpoints_ok", "limits_ok", "velocity_ok", "executed"]


def _extras(pkg_scene, pkg_grid, dtype, **kw):
    """The built objects' extras: ``SceneBuilder`` on a stand-in base grid
    (a session takes only the extras of a built scene and loads its own)."""
    stand_in = pkg_grid.SdfGrid.from_arrays(np.ones((2, 2, 2)), np.zeros(3), 1.0, dtype, **kw)
    b = pkg_scene.SceneBuilder(base=stand_in, dtype=dtype, **kw)
    for name, pos in OBJECTS:
        grid = (pkg_grid.SdfGrid.load(ASSET_DIR / "scenes" / "boxes.npz", dtype, **kw)
                if name == "boxes" else None)
        b.add_object(name, pos, grid=grid, spec=MARKER if name == "marker" else None)
    sc = b.build()
    return dict(extra_grids=sc.extra_grids, extra_offsets=sc.extra_offsets, primitives=sc.primitives)


@pytest.fixture(scope="module")
def sessions():
    """franka/industrial with the objects, float64 and packed, in both packages.
    PyTorch's first float64 ``sin``/``cos`` of a process on the CPU can be off
    by up to 7e-9 in a worker thread's chunk (ROADMAP.md Queue 3,
    ``tools/first_sin_call.py``); the fixture makes that call before the FK
    that the tests compare."""
    warm = torch.linspace(-3, 3, 35840, dtype=torch.float64)
    torch.sin(warm), torch.cos(warm)
    jsess = JaxSession("franka", "industrial", dtype=jnp.float64, overrides=TRAIN,
                       **_extras(jscene, jg, jnp.float64))
    tsess = PlanningSession("franka", "industrial", dtype=torch.float64, device="cpu", overrides=TRAIN,
                            **_extras(tscene, tg, torch.float64, device="cpu"))
    return jsess, tsess


def _configs(sess, n_lines=12, n=20, seed=0):
    """Configs along the first queries' straight lines, perturbed, and as
    many uniform over the joint box: ``[2 * n_lines, n, 7]``."""
    rng = np.random.default_rng(seed)
    starts, goals = (x[:n_lines] for x in sess.queries())
    w = np.linspace(0, 1, n)[None, :, None]
    lines = starts[:, None] + (goals - starts)[:, None] * w + 0.1 * rng.normal(size=(n_lines, n, 7))
    lo, hi = sess.spec.limits_low, sess.spec.limits_high
    return np.clip(np.concatenate([lines, rng.uniform(lo, hi, (n_lines, n, 7))]), lo, hi)


def test_object_scene_matches_jax(sessions):
    jsess, tsess = sessions
    js_, ts_ = jsess.scene, tsess.scene
    assert ts_.mode == js_.mode == "packed" and len(ts_.extra_packed) == len(js_.extra_packed) == 1
    np.testing.assert_array_equal(ts_.extra_offsets.numpy(), np.asarray(js_.extra_offsets))
    for f in dataclasses.fields(tscene.Primitives):
        np.testing.assert_array_equal(getattr(ts_.primitives, f.name).numpy(),
                                      np.asarray(getattr(js_.primitives, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(ts_.extra_packed[0].words.numpy().view(np.uint32),
                                  np.asarray(js_.extra_packed[0].words).reshape(-1, 2))
    assert tsess.model.collision.tables.counts == [1, 2, 1]


def test_log_prob_and_grad_match_jax(sessions):
    """Every source attains the minimum at some hinge-active sphere; the
    log-density and d/dq as the module docstring says."""
    jsess, tsess = sessions
    q = _configs(tsess)
    R, N, _ = q.shape
    sigma = np.full((R, 37), 0.005)
    jf = jax.vmap(lambda qb, sb: jsess.model.collision.log_prob(qb, sb))
    want = np.asarray(jf(jnp.asarray(q), jnp.asarray(sigma)))
    jg_ = np.asarray(jax.grad(lambda x: jf(x, jnp.asarray(sigma)).sum())(jnp.asarray(q)))
    col = tsess.model.collision
    x = torch.as_tensor(q).requires_grad_()
    lik = col.log_prob(x, torch.as_tensor(sigma))
    lik.sum().backward()
    np.testing.assert_allclose(lik.detach().numpy(), want, rtol=1e-10, atol=1e-12)
    got = x.grad.numpy()
    nan = np.isnan(jg_)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.any(axis=-1).sum() > 5 and not nan.all()
    np.testing.assert_allclose(got[~nan], jg_[~nan], rtol=0, atol=1e-10 * np.abs(jg_[~nan]).max())
    qt = torch.as_tensor(q)
    with torch.no_grad():
        from vgpmp_torch.kinematics.dh import sphere_positions

        active = col.hinge_cost(qt) > 0
        wins = source_wins(col.scene, sphere_positions(col.fk, qt), active)
    assert len(wins) == 5 and min(wins.values()) > 0, wins


def test_min_clearance_and_metric_match_jax(sessions):
    """The metric's trilinear clearance over the composed scene, and
    ``execute_and_validate`` (K3's two call sites: the probes with the floor
    compare, and the endpoints) on trajectories along the queries' lines."""
    jsess, tsess = sessions
    q = _configs(tsess, seed=1)
    want = np.asarray(jsess.model.collision.sphere_clearance_eval(jnp.asarray(q)).min(axis=-1))
    got = tsess.model.collision.min_clearance_eval(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    trajs = _configs(tsess, n_lines=6, n=10, seed=2)[:6]
    starts, goals = trajs[:, 0], trajs[:, -1]
    jrep = jax.vmap(lambda t, s, g: jval.execute_and_validate(
        jsess.model.collision, t, s, g, jsess.model.limits_low, jsess.model.limits_high))(
        *(jnp.asarray(x) for x in (trajs, starts, goals)))
    trep = report_to_numpy(execute_and_validate(
        tsess.model.collision, *(torch.as_tensor(x) for x in (trajs, starts, goals)),
        tsess.model.limits_low, tsess.model.limits_high))
    for f in BOOLS:
        np.testing.assert_array_equal(trep[f], np.asarray(getattr(jrep, f)), err_msg=f)
    np.testing.assert_allclose(trep["min_clearance"], np.asarray(jrep.min_clearance), rtol=1e-9, atol=1e-12)


def _init_params(sess, starts, goals):
    pp = sess.planner_params
    p0 = jm.init_params_batch(sess.model, jnp.asarray(starts), jnp.asarray(goals), jnp.zeros(B, jnp.int32),
                              jnp.asarray(0.5 * (starts + goals)),
                              *(jnp.asarray(pp[k]) for k in ("lengthscales", "variance", "sigma_obs", "alpha")))
    return p0, {k: np.asarray(getattr(p0, k)) for k in tm.PlannerParams.names()}


def _noise(keys):
    """JAX's per-step and posterior draws from each row's key, for the port."""
    step_keys = [jax.random.split(k, STEPS + 1) for k in keys]
    return ts.SolveNoise(
        steps=[jax_path_noise([sk[i] for sk in step_keys], 7, M + 2, S, NB) for i in range(STEPS)],
        posterior=jax_path_noise([sk[-1] for sk in step_keys], 7, M + 2, K, NB))


@pytest.fixture(scope="module")
def solved(sessions, monkeypatch_module):
    """A 4-step solve of queries ``ROWS`` in both packages; the port records
    which rows' steps its guard skipped."""
    jsess, tsess = sessions
    jcfg = dataclasses.replace(jsess.train_config, num_posterior_samples=K)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    starts, goals = (x[ROWS] for x in tsess.queries())
    jp0, p0 = _init_params(jsess, starts, goals)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jparams, jres = js.make_batch_solver(jsess.model, jcfg)(jp0, jnp.asarray(starts), jnp.asarray(goals), keys)
    skipped = []
    step = ts.BatchedAdam.step

    def recording_step(self, params, grads):
        before = self.count.clone()
        out = step(self, params, grads)
        skipped.append((self.count == before).numpy())
        return out

    monkeypatch_module.setattr(ts.BatchedAdam, "step", recording_step)
    tparams, tres = ts.make_batch_solver(tsess.model, tcfg)(params_from_numpy(p0), starts, goals,
                                                            noise=_noise(keys))
    monkeypatch_module.undo()
    return p0, jparams, jres, tparams, tres, np.array(skipped)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_solve_skips_the_steps_jax_skips(solved):
    """Row 1 (query 7) skips a step, but not every step, where a sample's
    sphere centre enters the marker box (NaN gradient in both packages):
    after it the parameters and trajectories still agree, so JAX skipped the
    same step."""
    *_, skipped = solved
    assert skipped.shape == (STEPS, B)
    assert 0 < skipped[:, 1].sum() < STEPS, skipped


@pytest.mark.parametrize("leaf", tm.PlannerParams.names())
def test_solve_params_match_jax(solved, leaf):
    _, jparams, _, tparams, _, _ = solved
    got, want = params_to_numpy(tparams)[leaf], np.asarray(getattr(jparams, leaf))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * max(np.abs(want).max(), 1.0), err_msg=leaf)


@pytest.mark.parametrize("field", ["elbo_history", "best", "best_score"])
def test_solve_result_matches_jax(solved, field):
    _, _, jres, _, tres, _ = solved
    want, got = np.asarray(getattr(jres, field)), getattr(tres, field).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-6,
                               atol=1e-8 * max(np.abs(want).max(), 1.0), err_msg=field)
    assert np.isfinite(got).all()


def test_scored_round_verdicts_match_jax(sessions):
    """``make_round_solver`` on the object scene: the best trajectories to
    1e-6 relative plus 1e-7 (the schedule's float32 rounding, carried through
    the posterior draw onto entries near zero), the verdicts equal, the
    clearances to 1e-6."""
    jsess, tsess = sessions
    jcfg = dataclasses.replace(jsess.train_config, num_posterior_samples=K)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    starts, goals = (x[ROWS] for x in tsess.queries())
    jp0, p0 = _init_params(jsess, starts, goals)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jbest, jrep = js.make_round_solver(jsess.model, jcfg)(jp0, jnp.asarray(starts), jnp.asarray(goals), keys)
    tbest, trep = ts.make_round_solver(tsess.model, tcfg)(params_from_numpy(p0), starts, goals,
                                                          noise=_noise(keys))
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=1e-6, atol=1e-7)
    got = report_to_numpy(trep)
    for f in BOOLS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jrep, f)), err_msg=f)
    for f in ("min_clearance", "max_endpoint_err"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jrep, f)), rtol=1e-6, atol=1e-6, err_msg=f)


def test_move_objects_matches_a_rebuilt_model(sessions):
    """``move_objects`` with the scene a moved builder gives: the model's
    log-density equals that of a model built afresh on the moved scene, and
    its pose tables are rewritten in place."""
    _, tsess = sessions
    col = tsess.model.collision
    b = tscene.SceneBuilder(base=tsess.sdf, base_offset=tsess.scene_offset, dtype=torch.float64, device="cpu")
    for name, pos in OBJECTS:
        grid = tsess.scene.extra_grids[0] if name == "boxes" else None
        b.add_object(name, pos, grid=grid, spec=MARKER if name == "marker" else None)
    b.move_object("duck", (0.45, -0.1, 0.45))
    b.move_object("boxes", (0.25, 0.45, 0.35))
    moved = b.build()
    fresh = tcol.CollisionModel(fk=col.fk, scene=moved.packed(), epsilon=col.epsilon)
    ptrs = (col.tables.grid_f.data_ptr(), col.tables.prims.data_ptr())
    q = torch.as_tensor(_configs(tsess, n_lines=4, n=10, seed=5))
    sigma = torch.full((q.shape[0], 37), 0.005, dtype=torch.float64)
    before = col.log_prob(q, sigma)
    col.move_objects(moved)
    after = col.log_prob(q, sigma)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, fresh.log_prob(q, sigma), rtol=0, atol=0)
    assert (col.tables.grid_f.data_ptr(), col.tables.prims.data_ptr()) == ptrs
    torch.testing.assert_close(col.tables.grid_f, fresh.tables.grid_f, rtol=0, atol=0)
    torch.testing.assert_close(col.tables.prims, fresh.tables.prims, rtol=0, atol=0)
    with pytest.raises(ValueError, match="objects differ"):
        b.remove_object("duck")
        col.move_objects(b.build())
