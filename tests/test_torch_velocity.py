"""Port parity: the velocity-constrained inducing set (``gp/velocity.py``, the
derivative kernels of ``ops/kernels.py``, the derivative features of
``gp/pathwise.py`` and the velocity branches of ``models/vgpmp.py``).

float64 on the CPU against ``vgpmp_tpu``: the kernels, Grams and features
are the same formulas in the same order, so 1e-12 relative. The 10-step
solve runs the port on JAX's own draws (``jax_path_noise`` with
``Mc = 2C + M``) and is held at the batch solver's tolerance, 1e-6 relative
plus 1e-8 of the field's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.gp import pathwise as jp
from vgpmp_tpu.gp import velocity as jv
from vgpmp_tpu.ops import kernels as jk
from vgpmp_tpu.session import PlanningSession as JaxSession
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.gp import pathwise as tp
from vgpmp_torch.ops import rff
from vgpmp_torch.gp import velocity as tv
from vgpmp_torch.models import vgpmp as tm
from vgpmp_torch.ops import kernels as tk
from vgpmp_torch.ops import linalg
from vgpmp_torch.session import PlanningSession

L, M, C = 3, 5, 2
TINY = dict(num_steps=10, num_samples=3, num_bases=64, num_inducing=5, time_spacing_X=12,
            time_spacing_Xnew=40)


@pytest.fixture(scope="module")
def hyper():
    """Two problems' inducing inputs and hyperparameters, ``[2, M, L]`` and ``[2, L]``."""
    r = np.random.default_rng(99)
    ls = r.uniform(0.8, 1.5, (2, L))
    s2 = r.uniform(0.3, 0.8, (2, L))
    Z = np.sort(r.uniform(0.15, 0.85, (2, M, L)), axis=1)
    return np.array([0.0, 1.0]), Z, ls, s2


@pytest.mark.parametrize("name", ["matern52_grad", "matern52_grad_grad", "se_grad", "se_grad_grad"])
def test_derivative_kernel_matches_jax(name):
    """Against JAX's on points that include r = 0 (repeated inputs), batched
    over a leading problem axis."""
    r = np.random.default_rng(1)
    x1 = r.uniform(0, 1, (2, L, 6))
    x2 = np.concatenate([x1[..., :3], r.uniform(0, 1, (2, L, 4))], axis=-1)  # 3 coincident
    ls, s2 = r.uniform(0.3, 1.5, (2, L)), r.uniform(0.2, 1.0, (2, L))
    got = getattr(tk, name)(*(torch.as_tensor(a) for a in (x1, x2, ls, s2))).numpy()
    want = np.stack([np.asarray(getattr(jk, name)(*(jnp.asarray(a[b]) for a in (x1, x2, ls, s2))))
                     for b in range(2)])
    assert got.shape == (2, L, 6, 7)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert tk.KERNEL_DERIVATIVES["matern52" if name.startswith("matern") else "se"][
        name.endswith("grad_grad")] is getattr(tk, name)


def test_matern52_grad_grad_exact_limit_at_r0():
    ls, s2 = torch.tensor([0.4, 1.3], dtype=torch.float64), torch.tensor([0.7, 0.2], dtype=torch.float64)
    x = torch.tensor([[0.25], [0.6]], dtype=torch.float64)
    got = tk.matern52_grad_grad(x, x, ls, s2)[:, 0, 0]
    np.testing.assert_allclose(got.numpy(), (s2 * 5.0 / (3.0 * ls * ls)).numpy(), rtol=1e-15)
    # the slope's sign: positive for x1 > x2 (the reference's negated dk/dx1)
    assert float(tk.matern52_grad(x + 0.1, x, ls, s2)[0, 0, 0]) > 0


def test_kuu_kuf_velocity_match_jax_and_are_psd(hyper):
    ny, Z, ls, s2 = hyper
    X = np.linspace(0, 1, 9)
    t = lambda a: torch.as_tensor(a)
    Kt = tv.kuu_velocity(t(ny), t(Z), t(ls), t(s2), jitter=1e-8).numpy()
    Ft = tv.kuf_velocity(t(ny), t(Z), t(X), t(ls), t(s2)).numpy()
    Kj = np.stack([np.asarray(jv.kuu_velocity(jnp.asarray(ny), jnp.asarray(Z[b]), jnp.asarray(ls[b]),
                                              jnp.asarray(s2[b]), jitter=1e-8)) for b in range(2)])
    Fj = np.stack([np.asarray(jv.kuf_velocity(jnp.asarray(ny), jnp.asarray(Z[b]), jnp.asarray(X),
                                              jnp.asarray(ls[b]), jnp.asarray(s2[b]))) for b in range(2)])
    assert Kt.shape == (2, L, 2 * C + M, 2 * C + M) and Ft.shape == (2, L, 2 * C + M, 9)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(Ft, Fj, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(Kt, np.swapaxes(Kt, -1, -2))
    assert np.linalg.eigvalsh(Kt).min() > 0
    # one grid per problem (grid_rows), the solve dtype cast
    Xb = np.stack([X, X ** 2])
    Fb = tv.kuf_velocity(t(ny), t(Z), t(Xb), t(ls), t(s2)).numpy()
    np.testing.assert_allclose(Fb[0], Ft[0], rtol=1e-15)
    Fj1 = np.asarray(jv.kuf_velocity(jnp.asarray(ny), jnp.asarray(Z[1]), jnp.asarray(X ** 2),
                                     jnp.asarray(ls[1]), jnp.asarray(s2[1])))
    np.testing.assert_allclose(Fb[1], Fj1, rtol=1e-12, atol=1e-14)
    K32 = tv.kuu_velocity(*(t(a).float() for a in (ny, Z, ls, s2)), solve_dtype=torch.float64)
    assert K32.dtype == torch.float64
    np.testing.assert_array_equal(tv.deriv_mask(C, M).numpy(), np.asarray(jv.deriv_mask(C, M)))
    q = [np.full((2, C, L), v) for v in (0.0, 1.0)] + [np.full((2, M, L), 2.0)]
    np.testing.assert_array_equal(tv.extend_q_mu(*map(t, q))[0].numpy(),
                                  np.asarray(jv.extend_q_mu(*(jnp.asarray(a[0]) for a in q))))


def test_derivative_features_match_jax():
    r = np.random.default_rng(2)
    x, omega, phase = r.uniform(0, 1, (L, 9)), r.normal(size=(L, 16)) * 4, r.uniform(0, 6.28, (L, 16))
    mask = np.arange(9) < 2
    want = np.asarray(jp._rff_features(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(phase),
                                       jnp.asarray(mask)))
    got = rff.rff_features(torch.as_tensor(x), torch.as_tensor(omega), torch.as_tensor(phase),
                           torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[:, :2], -omega[:, None] * np.sin(x[:, :2, None] * omega[:, None]
                                                                     + phase[:, None]), rtol=1e-12)


def test_velocity_draw_matches_jax_and_clamps_the_endpoints(hyper):
    """The fused draw and evaluation on JAX's draws of two problems against
    JAX's ``draw_paths``/``eval_paths``, then the clamp: positions and
    finite-difference velocities at both ends (the bounds of JAX's own test)."""
    ny, Z, ls, s2 = hyper
    S, NB, Mc = 24, 2048, 2 * C + M
    r = np.random.default_rng(3)
    query = r.normal(size=(2, C, L)) * 0.4
    h = 1e-3
    X = np.array([0.0, h, 1.0 - h, 1.0])
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    mask = jv.deriv_mask(C, M)
    want = []
    for b in range(2):
        Kmm = jv.kuu_velocity(jnp.asarray(ny), jnp.asarray(Z[b]), jnp.asarray(ls[b]), jnp.asarray(s2[b]),
                              jitter=1e-6)
        q_mu_full = jv.extend_q_mu(jnp.zeros((C, L)), jnp.asarray(query[b]), jnp.zeros((M, L)))
        st = jp.draw_paths(keys[b], jnp.asarray(ny), jnp.asarray(Z[b]), jnp.asarray(ls[b]),
                           jnp.asarray(s2[b]), jnp.linalg.cholesky(Kmm), q_mu_full,
                           jnp.eye(M)[None].repeat(L, 0), S, NB, jitter=1e-6, deriv_mask=mask)
        kuf = jv.kuf_velocity(jnp.asarray(ny), jnp.asarray(Z[b]), jnp.asarray(X), jnp.asarray(ls[b]),
                              jnp.asarray(s2[b]))
        want.append(np.asarray(jp.eval_paths(st, kuf, jnp.asarray(X))))
    t = lambda a: torch.as_tensor(a)
    kuu = tv.kuu_velocity(t(ny), t(Z), t(ls), t(s2), jitter=1e-6)
    kuf = tv.kuf_velocity(t(ny), t(Z), t(X), t(ls), t(s2))
    q_mu_full = tv.extend_q_mu(torch.zeros(2, C, L, dtype=torch.float64), t(query),
                               torch.zeros(2, M, L, dtype=torch.float64))
    q_sqrt = torch.eye(M, dtype=torch.float64).expand(2, L, M, M)
    _, _, f, _ = tp.draw_and_eval_paths(t(ny), t(Z), t(ls), t(s2), kuu, kuf, t(X), q_mu_full, q_sqrt,
                                        S, NB, jitter=1e-6, noise=jax_path_noise(keys, L, Mc, S, NB),
                                        deriv_mask=tv.deriv_mask(C, M))
    f = f.numpy()
    # JAX factors with LAPACK (jnp.linalg.cholesky), the port with its
    # unrolled plain Cholesky: two summation orders on Grams of condition up
    # to 5e6, so 1e-7 relative here
    np.testing.assert_allclose(f, np.stack(want), rtol=1e-7, atol=1e-9)
    pos_err = np.abs(np.stack([f[:, :, 0], f[:, :, 3]], 2) - query[:, None])
    assert pos_err.max() < 2e-2, pos_err.max()
    for v in ((f[:, :, 1] - f[:, :, 0]) / h, (f[:, :, 3] - f[:, :, 2]) / h):
        assert np.abs(v).max() < 0.12, np.abs(v).max()


# --- the velocity-mode solve against JAX's ------------------------------------

B = 2


@pytest.fixture(scope="module")
def solved():
    """A 10-step B = 2 solve of franka/industrial (float64, packed scene,
    ``velocity_constrained`` through the session overlay) in both packages,
    the port on JAX's per-step and posterior draws."""
    jsess = JaxSession("franka", "industrial", dtype=jnp.float64, overrides=TINY)
    tsess = PlanningSession("franka", "industrial", dtype=torch.float64, device="cpu",
                            overrides=dict(TINY, velocity_constrained=True))
    jmodel = jsess.model.replace(velocity_constrained=True)
    jcfg = jsess.train_config.replace(num_posterior_samples=8)
    tcfg = dataclasses.replace(tsess.train_config, num_posterior_samples=8)
    starts, goals = (x[:B] for x in tsess.queries())
    jp0 = js.init_batch(jmodel, starts, goals, jsess.planner_params)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jparams, jres = js.make_batch_solver(jmodel, jcfg)(jp0, jnp.asarray(starts), jnp.asarray(goals), keys)
    Mc = 2 * 2 + TINY["num_inducing"]
    step_keys = [jax.random.split(k, jcfg.num_steps + 1) for k in keys]
    noise = ts.SolveNoise(
        steps=[jax_path_noise([sk[i] for sk in step_keys], 7, Mc, TINY["num_samples"], TINY["num_bases"])
               for i in range(jcfg.num_steps)],
        posterior=jax_path_noise([sk[-1] for sk in step_keys], 7, Mc, 8, TINY["num_bases"]))
    tp0 = params_from_numpy({k: np.asarray(getattr(jp0, k)) for k in tm.PlannerParams.names()})
    tparams, tres = ts.make_batch_solver(tsess.model, tcfg)(tp0, starts, goals, noise=noise)
    return jparams, jres, tparams, tres, tsess


def test_velocity_session_takes_the_fused_path(solved, monkeypatch):
    """The overlay sets the flag; a float64 session keeps 3 jitter
    escalations, yet the velocity Gram is factored once, by the fused call."""
    *_, tsess = solved
    m = tsess.model
    assert m.velocity_constrained and m.jitter_escalations == 3
    calls = {"draw_and_eval_paths": 0, "draw_paths": 0, "factor_solve": 0}
    for mod, name in ((tp, "draw_and_eval_paths"), (tp, "draw_paths"), (linalg, "factor_solve")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    starts, goals = (torch.as_tensor(x[:B]) for x in tsess.queries())
    params = ts.init_batch(m, starts.numpy(), goals.numpy(), tsess.planner_params)
    value = tm.elbo(params, m, starts, goals, torch.linspace(0, 1, 12, dtype=torch.float64),
                    torch.Generator().manual_seed(0))
    assert calls == {"draw_and_eval_paths": 1, "draw_paths": 0, "factor_solve": 1}
    assert torch.isfinite(value).all()
    assert not PlanningSession("franka", "industrial", dtype=torch.float64, device="cpu",
                               overrides=TINY).model.velocity_constrained


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * max(np.abs(want).max(), 1.0))


def test_velocity_solve_params_match_jax(solved):
    jparams, _, tparams, _, _ = solved
    for k, v in params_to_numpy(tparams).items():
        _close(v, np.asarray(getattr(jparams, k)))


@pytest.mark.parametrize("field", ["elbo_history", "best", "mean"])
def test_velocity_solve_result_matches_jax(solved, field):
    _, jres, _, tres, _ = solved
    got = getattr(tres, field).numpy()
    assert np.isfinite(got).all()
    _close(got, np.asarray(getattr(jres, field)))


def test_velocity_solve_starts_and_ends_at_rest(solved):
    """The bound of JAX's ``test_velocity_mode_solver_runs`` on both ends of
    every row's best trajectory."""
    _, _, _, tres, _ = solved
    best = tres.best.numpy()
    dt = 1.0 / (best.shape[1] - 1)
    for row in best:
        v_mid = np.abs(np.diff(row, axis=0)).max() / dt
        for a, b in ((0, 1), (-1, -2)):
            assert np.abs(row[b] - row[a]).max() / dt < 0.35 * max(v_mid, 1e-6) + 0.05
