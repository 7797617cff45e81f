"""Port parity: the multi-restart ensemble (``init_ensemble``,
``make_ensemble_solver``).

``init_ensemble`` is ``init_slots`` once per mode, and the via-point draws are
numpy's in both packages, so the inits agree to 1e-12 on the same float64
session. The ensemble solve runs the small franka planner in both packages,
the port on JAX's draws for every ``[K, B]`` row: the chosen inits and the
reports' bools must be equal, trajectories and floats agree to 1e-6 (the
round's tolerance, ``tests/test_torch_round.py``).
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
from vgpmp_tpu.session import PlanningSession as JaxSession
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.engine.validator import ValidationReport
from vgpmp_torch.models import vgpmp as tm
from vgpmp_torch.session import PlanningSession

LEAVES = tm.PlannerParams.names()
K, B, S, M, NB, STEPS, KS = 2, 3, 3, 4, 64, 5, 6
BOOLS = ["success", "collision_free", "endpoints_ok", "limits_ok", "velocity_ok", "executed"]


@pytest.fixture(scope="module")
def sessions():
    """franka/industrial in float64 with the packed scene, in both packages."""
    return (JaxSession("franka", "industrial", dtype=jnp.float64),
            PlanningSession("franka", "industrial", dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("mode", ["linear", "zeros", "rand3", "frand5"])
def test_init_ensemble_matches_jax(sessions, mode):
    jsess, tsess = sessions
    starts, goals = (x[:10] for x in tsess.queries())
    inits = ("linear", mode)
    want = js.init_ensemble(jsess.model, starts, goals, jsess.planner_params, inits)
    got = params_to_numpy(ts.init_ensemble(tsess.model, starts, goals, tsess.planner_params, inits))
    for k in LEAVES:
        w = np.asarray(getattr(want, k))
        assert got[k].shape == w.shape and got[k].shape[:2] == (2, 10), k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def ensembles():
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.02, lr_peak=0.15, warmup_steps=10,
                          sigma_anneal=2.0, time_spacing_X=8, time_spacing_Xnew=10,
                          num_posterior_samples=KS)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    rng = np.random.default_rng(1)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals[2] = starts[2] + 0.1  # a short, clear motion: a row that is executed
    args = [jnp.asarray(a) for a in ([1.5] * 7, 0.2, 0.005, 100.0)]
    jp_kb = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(ids),
                             jnp.asarray(0.5 * (starts + goals)), *args)
        for ids in ([0, 0, 0], [1, 2, 1])])
    keys = jax.random.split(jax.random.PRNGKey(3), K * B).reshape(K, B, 2)
    jout = js.make_ensemble_solver(jmodel, jcfg, keep_member_reports=True)(
        jp_kb, jnp.asarray(starts), jnp.asarray(goals), keys)
    step_keys = [[jax.random.split(keys[k, b], STEPS + 1) for b in range(B)] for k in range(K)]

    def kb_noise(i, n):
        rows = [jax_path_noise([sk[i] for sk in step_keys[k]], 7, M + 2, n, NB) for k in range(K)]
        return type(rows[0])(*(torch.stack([r[f] for r in rows]) for f in range(4)))

    noise = ts.SolveNoise(steps=[kb_noise(i, S) for i in range(STEPS)], posterior=kb_noise(-1, KS))
    tp_kb = params_from_numpy({k: np.asarray(getattr(jp_kb, k)) for k in LEAVES})
    tout = ts.make_ensemble_solver(tmodel, tcfg, keep_member_reports=True)(tp_kb, starts, goals, noise=noise)
    return jax.tree.map(np.asarray, jout), tout, (tmodel, tcfg, tp_kb, starts, goals, noise)


def test_ensemble_chosen_and_best_match_jax(ensembles):
    (jbest, _, jchosen, _), (tbest, _, tchosen, _), _ = ensembles
    np.testing.assert_array_equal(tchosen.numpy(), jchosen)
    assert tbest.shape == jbest.shape == (B, 10, 7)
    np.testing.assert_allclose(tbest.numpy(), jbest, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("members", [False, True])
def test_ensemble_reports_match_jax(ensembles, members):
    (_, jrep, _, jrep_kb), (_, trep, _, trep_kb), _ = ensembles
    want, got = (jrep_kb, trep_kb) if members else (jrep, trep)
    assert isinstance(got, ValidationReport)
    for f in ValidationReport._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape == ((K, B) if members else (B,)), f
        if f in BOOLS:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f)


def test_ensemble_picks_the_best_member(ensembles):
    """The chosen member is the argmax of ``ensemble_score`` over the
    members' reports, and its report is that member's."""
    _, (tbest, trep, tchosen, trep_kb), _ = ensembles
    score = ts.ensemble_score(trep_kb.executed, trep_kb.success, trep_kb.min_clearance)
    np.testing.assert_array_equal(tchosen.numpy(), np.argmax(score.numpy(), axis=0))
    for f in ValidationReport._fields:
        np.testing.assert_array_equal(getattr(trep, f).numpy(),
                                      getattr(trep_kb, f).numpy()[tchosen.numpy(), np.arange(B)])
    assert trep.executed.any()


def test_tie_resolves_to_the_first_init(ensembles):
    """Two identical members (same init, same draws) score equal on every
    row: the first init wins, as ``jnp.argmax`` breaks ties."""
    _, _, (tmodel, tcfg, tp_kb, starts, goals, noise) = ensembles
    cfg = dataclasses.replace(tcfg, num_steps=2)
    twin = tp_kb.map(lambda x: x[:1].expand((2,) + x.shape[1:]).clone())
    same = lambda pn: type(pn)(*(x[:1].expand((2,) + x.shape[1:]) for x in pn))
    tnoise = ts.SolveNoise(steps=[same(n) for n in noise.steps[:2]], posterior=same(noise.posterior))
    best, rep, chosen, members = ts.make_ensemble_solver(tmodel, cfg, keep_member_reports=True)(
        twin, starts, goals, noise=tnoise)
    score = ts.ensemble_score(members.executed, members.success, members.min_clearance)
    assert torch.equal(score[0], score[1])
    assert chosen.tolist() == [0] * B
    assert int(np.argmax(np.zeros(2, np.float32))) == int(jnp.argmax(jnp.zeros(2, jnp.float32))) == 0


def test_nan_member_scores_minus_inf_and_loses(ensembles):
    """A member whose state is NaN diverges: its trajectory and clearance are
    NaN, it scores −inf in both packages, and the other member is chosen."""
    _, _, (tmodel, tcfg, tp_kb, starts, goals, noise) = ensembles
    cfg = dataclasses.replace(tcfg, num_steps=2)
    bad = tp_kb.map(lambda x: x.clone())
    bad.q_mu[0, 1] = float("nan")
    two = ts.SolveNoise(steps=noise.steps[:2], posterior=noise.posterior)
    best, rep, chosen, members = ts.make_ensemble_solver(tmodel, cfg, keep_member_reports=True)(
        bad, starts, goals, noise=two)
    assert torch.isnan(members.min_clearance[0, 1]) and not members.executed[0, 1]
    score = ts.ensemble_score(members.executed, members.success, members.min_clearance)
    jscore = js.ensemble_score(members.executed.numpy(), members.success.numpy(),
                               members.min_clearance.numpy())
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    assert score[0, 1] == float("-inf") and int(chosen[1]) == 1
    assert torch.isfinite(best[1]).all()
