"""Port parity on the CPU for the sessions beyond the main path that the
port's kernels now take on the card: the collision likelihood in the
reference's nearest-cell mode and in trilinear mode, the float32 Gram island,
and K2's plain path above n = 32.

- ``Scene.distance`` and its spatial gradient in both modes against
  ``vgpmp_tpu.scene`` at points outside the grid, on cell faces, on its upper
  border and on a flat plateau (where the central difference is 0 and the
  reference's 0.1 replaces it), float64, 1e-12;
- ``CollisionModel.log_prob`` and ``∂/∂q`` in both modes, on the base grid
  and on a scene with objects, against JAX's on the same configs, float64;
- the plain factorisation and solves at n = 40, 64, 128, 129, 160 and 256
  against ``vgpmp_tpu.ops.linalg``;
- a 20-step solve of a float32 model whose Gram island is float32 (jitter
  escalation on) against JAX's on the same draws;
- the first ELBO and every gradient of a float64 planner with 130 inducing
  points (Mc = 132) against JAX's on the same draws;
- the dispatch: every mode and dtype takes the plain version on a CPU tensor,
  and ``log_prob`` hands a CUDA tensor to K1 only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise, planner_models, scene_objects, smooth_grid
from vgpmp_tpu import robots as jrobots
from vgpmp_tpu import scene as jscene
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.kinematics import dh as jdh
from vgpmp_tpu.likelihoods import collision as jcol
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_tpu.ops import linalg as jla
from vgpmp_tpu.sdf import grid as jg
from vgpmp_torch import robots as trobots
from vgpmp_torch import scene as tscene
from vgpmp_torch.convert import params_from_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.kinematics import dh as tdh
from vgpmp_torch.likelihoods import collision as tcol
from vgpmp_torch.models import vgpmp as tm
from vgpmp_torch.ops import linalg as tla
from vgpmp_torch.sdf import grid as tg

# dyadic origin and voxel edge: cell faces and the grid's border are exact
# floating-point points
ORIGIN = np.array([-1.25, -1.25, -0.625])
DELTA = 0.0625
SHAPE = (40, 40, 36)
OFFSET = np.array([0.125, 0.0, -0.0625])
MODES = ["nearest", "trilinear"]


def _grid_data():
    return smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)


def _scenes(mode, objects=False):
    """The same scene in both packages, float64, looked up in ``mode``."""
    data = _grid_data()
    jbase = jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jnp.float64)
    tbase = tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, torch.float64)
    jkw, tkw = {}, {}
    if objects:
        grids, offsets, prims = scene_objects()
        jkw = dict(extra_grids=tuple(jg.SdfGrid.from_arrays(d, o, dl, jnp.float64) for d, o, dl in grids),
                   extra_offsets=jnp.asarray(offsets),
                   primitives=jscene.Primitives(**{k: jnp.asarray(v) for k, v in prims.items()}))
        tkw = dict(extra_grids=tuple(tg.SdfGrid.from_arrays(d, o, dl, torch.float64) for d, o, dl in grids),
                   extra_offsets=torch.as_tensor(offsets),
                   primitives=tscene.Primitives(**{k: torch.as_tensor(v) for k, v in prims.items()}))
    jsc = jscene.Scene(base=jbase, base_offset=jnp.asarray(OFFSET), mode=mode, **jkw)
    tsc = tscene.Scene(base=tbase, base_offset=torch.as_tensor(OFFSET), mode=mode, **tkw)
    return jsc, tsc


def _points(rng):
    """World points: uniform over a box larger than the grid (outside on
    every side), on cell faces (each axis on a face in turn), exactly on the
    grid's lower and upper border, and in the flat plateau of cells 2..4."""
    top = ORIGIN + DELTA * (np.array(SHAPE) - 1)
    box = rng.uniform(ORIGIN - 0.3, top + 0.3, size=(200, 3))
    cells = rng.integers(1, np.array(SHAPE) - 1, size=(60, 3))
    faces = ORIGIN + DELTA * (cells + rng.uniform(0.1, 0.9, size=(60, 3)))
    for a in range(3):
        faces[20 * a:20 * (a + 1), a] = ORIGIN[a] + DELTA * cells[20 * a:20 * (a + 1), a]
    border = ORIGIN + DELTA * (rng.integers(1, np.array(SHAPE) - 1, size=(12, 3)) + 0.5)
    for a in range(3):
        border[4 * a:4 * a + 2, a] = ORIGIN[a]
        border[4 * a + 2:4 * a + 4, a] = top[a]
    plateau = ORIGIN + DELTA * rng.uniform(2.2, 4.8, size=(20, 3))
    return np.concatenate([box, faces, border, plateau]) + OFFSET


@pytest.mark.parametrize("mode", MODES)
def test_scene_distance_and_gradient_match_jax_at_the_edges(mode):
    """The lookup and its spatial gradient at the points where the two
    modes' semantics have edges: outside the grid (the clip), on cell faces
    (the floor), on the border (the clip's tie: JAX's ``jnp.clip`` halves the
    gradient there, and so does the port) and on the plateau (the nearest
    cell's 0.1 replacement); float64, 1e-12."""
    jsc, tsc = _scenes(mode)
    p = _points(np.random.default_rng(3))
    want = np.asarray(jsc.distance(jnp.asarray(p)))
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jsc.distance(x)))(jnp.asarray(p)))
    pt = torch.as_tensor(p).requires_grad_()
    got = tsc.distance(pt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.grad.numpy(), gwant, rtol=0, atol=1e-12)
    plateau = pt.grad[-20:].numpy()
    if mode == "nearest":  # the reference's escape from flat plateaus
        assert (plateau == 0.1).any()
    else:
        assert (plateau == 0.0).any()
    border = pt.grad[-32:-20].numpy()
    assert np.isfinite(border).all()


def _models(robot, mode, objects=False):
    jsc, tsc = _scenes(mode, objects)
    jspec, tspec = jrobots.load_robot(robot), trobots.load_robot(robot)
    jmod = jcol.CollisionModel(fk=jdh.FkModel.from_spec(jspec, np.eye(4), dtype=jnp.float64), scene=jsc,
                               epsilon=jnp.asarray(0.05))
    tmod = tcol.CollisionModel(fk=tdh.FkModel.from_spec(tspec, np.eye(4), dtype=torch.float64),
                               scene=tsc, epsilon=0.05)
    return jspec, jmod, tmod


def _log_prob_check(jspec, jmod, tmod, seed, nan_ok=False):
    rng = np.random.default_rng(seed)
    lo, hi = jspec.joint_limits[:, 1], jspec.joint_limits[:, 0]
    q = rng.uniform(lo, hi, size=(3, 40, jspec.dof))
    sigma = rng.uniform(0.004, 0.006, size=(3, jspec.num_spheres))
    jf = jax.vmap(lambda qb, sb: jmod.log_prob(qb, sb))
    want = np.asarray(jf(jnp.asarray(q), jnp.asarray(sigma)))
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jf(x, jnp.asarray(sigma))))(jnp.asarray(q)))
    qt = torch.as_tensor(q).requires_grad_()
    got = tmod.log_prob(qt, torch.as_tensor(sigma))
    got.sum().backward()
    assert (want < 0).mean() > 0.2  # the hinge is active for a good share of configs
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10, atol=1e-10)
    if nan_ok:  # a sphere centre inside a box: NaN on both sides
        np.testing.assert_array_equal(np.isnan(qt.grad.numpy()), np.isnan(gwant))
    np.testing.assert_allclose(qt.grad.numpy(), gwant, rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_log_prob_grid_modes_match_jax(robot, mode):
    """``log_prob`` and ``∂/∂q`` on the unpacked grid in each mode against
    ``jax.grad`` of JAX's on the same configs (the same cells gathered, so
    1e-10 relative; gradients 1e-9)."""
    _log_prob_check(*_models(robot, mode), seed=1)


def test_log_prob_nearest_scene_with_objects_matches_jax():
    """A scene with two extra grids and every primitive kind, in the
    reference's nearest-cell mode: each extra grid's nearest cell and central
    difference, folded into the minimum as JAX folds them."""
    jspec, jmod, tmod = _models("franka", "nearest", objects=True)
    _log_prob_check(jspec, jmod, tmod, seed=2, nan_ok=True)


@pytest.mark.parametrize("n", [40, 64, 128, 129, 160, 256])
def test_k2_plain_path_above_32_matches_jax(n):
    """The plain factorisation and both solves (the CPU's ``chol``,
    ``solve_lower``, ``solve_upper_T``, ``cho_solve`` and ``factor_solve``)
    at the sizes K2's block design (n <= 128) and its streamed design (above)
    take, against ``vgpmp_tpu.ops.linalg`` on the same float64 SPD matrices;
    1e-10 relative to the largest entry."""
    rng = np.random.default_rng(n)
    G = rng.normal(size=(3, n, n))
    K = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    B = rng.normal(size=(3, n, 5))
    Kt, Bt = torch.as_tensor(K), torch.as_tensor(B)
    Lj = np.asarray(jla.chol(jnp.asarray(K)))
    L = tla.chol(Kt)
    close = lambda got, want: np.testing.assert_allclose(got, want, rtol=0,
                                                          atol=1e-10 * np.abs(want).max())
    close(L.numpy(), Lj)
    for fn, jfn in ((tla.solve_lower, jla.solve_lower), (tla.solve_upper_T, jla.solve_upper_T),
                    (tla.cho_solve, jla.cho_solve)):
        close(fn(L, Bt).numpy(), np.asarray(jfn(jnp.asarray(Lj), jnp.asarray(B))))
    Lf, Xf = tla.factor_solve(Kt, Bt)
    close(Lf.numpy(), Lj)
    close(Xf.numpy(), np.asarray(jla.solve_lower(jnp.asarray(Lj), jnp.asarray(B))))
    # a non-SPD matrix comes back NaN, as the escalation expects
    bad = Kt.clone()
    bad[1] = -bad[1]
    assert torch.isnan(tla.chol(bad)[1]).any() and torch.isfinite(tla.chol(bad)[[0, 2]]).all()


S, NB, M, K_POST, STEPS, B = 3, 32, 4, 4, 20, 3


@pytest.fixture(scope="module")
def island_solved():
    """A 20-step solve of a float32 model with a float32 Gram island (jitter
    1e-9 and 3 escalations, JAX's settings without x64) in both packages from
    the same initial state and on the same draws."""
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9,
                                           escalations=3, dtype=np.float32, solve_dtype=np.float32)
    assert tmodel.solve_dtype == torch.float32 and tmodel.dtype == torch.float32
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.02, lr_peak=0.15, warmup_steps=10,
                          sigma_anneal=2.0, time_spacing_X=8, time_spacing_Xnew=10,
                          num_posterior_samples=K_POST)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    rng = np.random.default_rng(1)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = (0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))).astype(np.float32)
    goals = (0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))).astype(np.float32)
    args = [np.full(7, 1.5, np.float32), np.float32(0.2), np.float32(0.005), np.float32(100.0)]
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray([0, 1, 2]),
                               jnp.asarray(0.5 * (starts + goals)), *map(jnp.asarray, args))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jparams, jres = js.make_batch_solver(jmodel, jcfg)(jp0, jnp.asarray(starts), jnp.asarray(goals), keys)
    step_keys = [jax.random.split(k, STEPS + 1) for k in keys]
    draw = lambda ks, n: jax_path_noise(ks, 7, M + 2, n, NB, dtype=np.float32)
    noise = ts.SolveNoise(steps=[draw([sk[i] for sk in step_keys], S) for i in range(STEPS)],
                          posterior=draw([sk[-1] for sk in step_keys], K_POST))
    tp0 = params_from_numpy({k: np.asarray(getattr(jp0, k)) for k in tm.PlannerParams.names()})
    assert tp0.q_mu.dtype == torch.float32
    tparams, tres = ts.make_batch_solver(tmodel, tcfg)(tp0, starts, goals, noise=noise)
    return jres, tres


def test_float32_island_solve_matches_jax(island_solved):
    """The float32 island's 20 steps against JAX's. A float32 factor of these
    Grams (condition ~1e5) carries the two compilers' float32 roundings of
    the Gram (~1e-7) into the first step's ELBO at up to ~1e-4, and Adam
    compounds that: the first step is held to 1e-3 relative, the first five
    to 1e-2, and every step of both must be finite (rows go their own ways
    later, as two float32 runs of either package on two machines do)."""
    jres, tres = island_solved
    assert tres.elbo_history.dtype == torch.float32
    got, want = tres.elbo_history.numpy(), np.asarray(jres.elbo_history).reshape(tres.elbo_history.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=1e-2, atol=0)
    assert np.isfinite(tres.best.numpy()).all()


def test_float32_island_escalation_matches_jax():
    """``cholesky_kuu`` in float32 with jitter 1e-9 and 3 escalations, the
    island's factorisation, on Grams whose lengthscales reach 4 (condition
    far beyond float32's): every problem escalates in both packages and both
    come back finite. Which rows escalate how often is decided by pivots
    within a rounding of zero, so it may differ by a row; what each package
    factors agrees with JAX's Gram to 2e-6 (float32 roundings of entries of
    order 0.5, ~1e-6, plus the 1e-6 jitter one side may add where the other
    stopped at 1e-7)."""
    from vgpmp_tpu.gp import conditioned as jc
    from vgpmp_tpu.ops import kernels as jk
    from vgpmp_torch.gp import conditioned as tc
    from vgpmp_torch.ops.kernels import matern52

    rng = np.random.default_rng(0)
    nb, L, Mi = 6, 7, 10
    Z = np.linspace(0.1, 0.9, Mi)[:, None].repeat(L, 1).astype(np.float32)
    ls = rng.uniform(0.3, 4.0, (nb, L)).astype(np.float32)
    s2 = rng.uniform(0.2, 0.6, (nb, L)).astype(np.float32)
    ny = np.array([0.0, 1.0], np.float32)
    kfn = jk.KERNELS["matern52"][0]
    jK, jL, jinfo = (np.asarray(x) for x in jax.vmap(lambda l_, v_: jc.cholesky_kuu(
        kfn, jnp.asarray(ny), jnp.asarray(Z), l_, v_, jitter=1e-9, escalations=3, with_info=True))(
        jnp.asarray(ls), jnp.asarray(s2)))
    tK, tL, tinfo = tc.cholesky_kuu(matern52, torch.as_tensor(ny), torch.as_tensor(Z).expand(nb, Mi, L),
                                    torch.as_tensor(ls), torch.as_tensor(s2), jitter=1e-9, escalations=3,
                                    with_info=True)
    assert jL.dtype == np.float32 and tL.dtype == torch.float32
    assert (jinfo > 0).all() and (tinfo.numpy() > 0).all()
    assert np.isfinite(jL).all() and torch.isfinite(tL).all()
    np.testing.assert_allclose((tL @ tL.mT).numpy(), jK, rtol=0, atol=2e-6)
    np.testing.assert_allclose(jL @ np.swapaxes(jL, -1, -2), tK.numpy(), rtol=0, atol=2e-6)


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on CUDA: what ``log_prob`` sees of a
    CUDA tensor, on a machine without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["packed", "nearest", "trilinear"])
def test_log_prob_dispatch(mode, dtype, monkeypatch):
    """On a CPU tensor every mode and dtype takes the plain version; a CUDA
    tensor goes to K1 and never to ``log_prob_plain``; ``k1_loglik`` refuses
    an SDF mode it has no lookup for and a dtype that is not the model's,
    before it loads the extension."""
    sc = tg.SdfGrid.from_arrays(_grid_data(), ORIGIN, DELTA, dtype)
    tsc = tscene.Scene(base=sc, base_offset=torch.as_tensor(OFFSET, dtype=dtype), mode="nearest")
    tsc = tsc.packed() if mode == "packed" else dataclasses.replace(tsc, mode=mode)
    spec = trobots.load_robot("franka")
    model = tcol.CollisionModel(fk=tdh.FkModel.from_spec(spec, np.eye(4), dtype=dtype), scene=tsc,
                                epsilon=0.05)
    assert model.fk.k1_robot.dtype == dtype and model.tables.data.dtype == dtype
    q = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (2, 5, 7)), dtype=dtype)
    sigma = torch.full((spec.num_spheres,), 0.005, dtype=dtype)
    plain_calls, k1_calls = [], []
    plain = tcol.log_prob_plain
    monkeypatch.setattr(tcol, "log_prob_plain", lambda *a: plain_calls.append(a) or plain(*a))
    monkeypatch.setattr(tcol, "_k1_log_prob", lambda *a: k1_calls.append(a) or torch.zeros(2, 5))
    model.log_prob(q, sigma)
    assert len(plain_calls) == 1 and not k1_calls
    model.log_prob(torch.Tensor._make_subclass(_CudaLike, q), sigma)
    assert len(plain_calls) == 1 and len(k1_calls) == 1

    def no_build():
        raise AssertionError("the extension was loaded")

    monkeypatch.setattr(tcol._build, "load", no_build)
    fake = torch.Tensor._make_subclass(_CudaLike, q.reshape(-1, 7))
    sig = torch.full((1, spec.num_spheres), 0.005, dtype=dtype)
    with pytest.raises(TypeError):  # configs of the other dtype
        other = torch.float32 if dtype == torch.float64 else torch.float64
        tcol.k1_loglik(model, torch.Tensor._make_subclass(_CudaLike, q.reshape(-1, 7).to(other)),
                       sig.to(other), True)
    with pytest.raises(ValueError, match="no K1 lookup"):
        tcol.k1_loglik(dataclasses.replace(model, scene=dataclasses.replace(tsc, mode="cubic")), fake,
                       sig, True)


def test_elbo_above_128_inducing_matches_jax():
    """The first ELBO and its gradient with respect to every leaf of a small
    float64 planner with 130 inducing points (Mc = 132, above the block
    design's 128: the streamed design's sizes on the card), in the port's
    CPU path and in JAX on the same draws (2 rows, S = 2, N = 8, 32 bases).
    Both factor the Gram with LAPACK (``torch.linalg``, ``jnp.linalg``); at
    jitter 1e-6 its condition is ~3e7, and the two agree to 6e-11 on the
    ELBO and to 4e-9 of each gradient's largest entry: held to 1e-8
    relative, and to 1e-6 relative plus 5e-8 of the largest entry."""
    B_, S_, N_, M_, NB_ = 2, 2, 8, 130, 32
    jspec, jmodel, tmodel = planner_models(num_samples=S_, num_bases=NB_, num_inducing=M_)
    rng = np.random.default_rng(132)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B_, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B_, 7))
    rows = [jm.init_params(jmodel, starts[b], goals[b], [1.5] * 7, 0.2, 0.005, 100.0) for b in range(B_)]
    p = {k: np.stack([np.asarray(getattr(r, k)) for r in rows]) for k in tm.PlannerParams.names()}
    p["q_mu"] = p["q_mu"] + 0.3 * rng.normal(size=p["q_mu"].shape)
    p["q_sqrt"] = p["q_sqrt"] + 0.1 * np.tril(rng.normal(size=p["q_sqrt"].shape))
    X = np.linspace(0, 1, N_)
    keys = jax.random.split(jax.random.PRNGKey(11), B_)
    fn = jax.jit(jax.vmap(jax.value_and_grad(lambda pp, s, g, k: jm.elbo(pp, jmodel, s, g, jnp.asarray(X), k))))
    val, grads = fn(jm.PlannerParams(**{k: jnp.asarray(v) for k, v in p.items()}), jnp.asarray(starts),
                    jnp.asarray(goals), keys)
    tp = params_from_numpy(p)
    for v in tp.leaves().values():
        v.requires_grad_(True)
    got = tm.elbo(tp, tmodel, torch.as_tensor(starts), torch.as_tensor(goals), torch.as_tensor(X),
                  noise=jax_path_noise(keys, 7, M_ + 2, S_, NB_))
    got.sum().backward()
    assert np.isfinite(np.asarray(val)).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(val), rtol=1e-8)
    for k, v in tp.leaves().items():
        want = np.asarray(getattr(grads, k))
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-6, atol=5e-8 * np.abs(want).max(), err_msg=k)
