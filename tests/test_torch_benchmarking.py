"""The port's matrix driver ``benchmarking_torch.py`` at a tiny budget on the
CPU: each combo's record carries ``benchmarking.py``'s keys (those of the JAX
record ``RESULTS_r05.json``) plus the card, the SDF mode, the jitter and the
executed rows by round; ``--parity`` runs ``nearest`` at jitter 1e-6; a
fault in a combo propagates and the run exits non-zero, with no retry (the
opposite of the JAX driver's ``test_mid_matrix_failure_contained``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import benchmarking_torch as bt  # noqa: E402

TINY = dict(num_steps=2, num_samples=2, num_bases=16, num_inducing=4, time_spacing_X=6,
            time_spacing_Xnew=8)
JAX_KEYS = set(json.loads((ROOT / "RESULTS_r05.json").read_text())[0])
EXTRA = {"card", "sdf_mode", "jitter", "executed_by_round"}


def test_combos_are_the_jax_drivers():
    """The same nine combos as ``benchmarking.py:ALL_COMBOS``, read from its
    source (importing it would set JAX's process-wide options)."""
    import ast

    tree = ast.parse((ROOT / "benchmarking.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "ALL_COMBOS")
    assert bt.ALL_COMBOS == [tuple(c) for c in ast.literal_eval(node.value)]


def test_tuned_combo_writes_the_jax_keys():
    """Two adaptive runs of franka/industrial (inits frand5, linear)."""
    out = bt.run_combo("franka", "industrial", runs=2, sdf_mode="packed", seed=0, adaptive_rounds=1,
                       device="cpu", overrides=dict(TINY, q_mu_inits=["frand5", "linear"]))
    assert set(out) == JAX_KEYS | EXTRA
    assert out["card"] == "cpu" and out["device"] == "cpu" and out["tuned"] is True
    assert out["problems"] == 36 and out["restarts"] == 2 and out["sdf_mode"] == "packed"
    assert out["budget"]["num_steps"] == 2 and out["budget"]["num_inducing"] == 4
    assert len(out["per_run_solved"]) == 2 and len(out["executed_by_round"]) == 2
    for run, rounds in zip(out["per_run_solved"], out["executed_by_round"]):
        assert 1 <= len(rounds) <= 3 and rounds[0] <= run <= 36
    assert 1.0 <= out["k_eff"] <= 3.0 and len(out["adaptive_rounds_used"]) == 2
    assert out["avg_solved"] == sum(out["per_run_solved"]) / 2
    assert out["solves_per_sec"] > 0 and out["steady_batch_seconds"] > 0
    json.dumps(out)


def test_parity_combo_runs_nearest_at_reference_jitter():
    out = bt.run_combo("kuka", "industrial", runs=1, sdf_mode="nearest", seed=0, use_tuned=False,
                       device="cpu", overrides=TINY)
    assert set(out) == JAX_KEYS | EXTRA
    assert out["jitter"] == 1e-6 and out["sdf_mode"] == "nearest" and out["tuned"] is False
    assert out["restarts"] == 1 and out["k_eff"] == 1.0 and out["adaptive_rounds_used"] is None
    assert out["executed_by_round"] == [[out["per_run_solved"][0]]]


def test_parity_flag_sets_nearest_and_no_adaptive_rounds(monkeypatch, tmp_path):
    calls = []

    def fake(robot, problemset, runs, sdf_mode, seed, use_tuned=True, adaptive_rounds=0,
             device=None, overrides=None):
        calls.append((robot, problemset, sdf_mode, use_tuned, adaptive_rounds))
        return {"problems": 36, "avg_solved": 30.0, "card": "cpu"}

    monkeypatch.setattr(bt, "run_combo", fake)
    monkeypatch.setattr(bt, "ROOT", tmp_path)  # leave the card runs' records alone
    assert bt.main(["--parity", "--adaptive-rounds", "3", "--runs", "1"], device="cpu") == 0
    assert bt.main(["--all", "--adaptive-rounds", "3", "--runs", "1"], device="cpu") == 0
    assert calls[0] == ("franka", "industrial", "nearest", False, 0)
    assert [c[:2] for c in calls[1:]] == bt.ALL_COMBOS
    assert all(c[2:] == ("packed", True, 3) for c in calls[1:])
    written = json.loads((tmp_path / "chiprun_out" / "benchmarking_torch.json").read_text())
    assert len(written) == len(bt.ALL_COMBOS)
    assert len(json.loads((tmp_path / "chiprun_out" / "benchmarking_torch_parity.json").read_text())) == 1


def test_a_failing_combo_ends_the_run(monkeypatch, tmp_path):
    """No retry and no record of the fault: the exception propagates out of
    ``main`` after the combos before it, so the process exits non-zero."""
    done = []

    def fake(robot, problemset, *a, **k):
        if (robot, problemset) == ("kuka", "industrial"):
            raise RuntimeError("device fault")
        done.append((robot, problemset))
        return {"problems": 36, "avg_solved": 36.0, "card": "cpu"}

    monkeypatch.setattr(bt, "run_combo", fake)
    monkeypatch.setattr(bt, "ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="device fault"):
        bt.main(["--all", "--runs", "1"], device="cpu")
    assert done == bt.ALL_COMBOS[:2]
    assert len(json.loads((tmp_path / "chiprun_out" / "benchmarking_torch.json").read_text())) == 2


def test_exits_non_zero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, str(ROOT / "benchmarking_torch.py"), "--runs", "1"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert "TOTAL" not in proc.stdout


@pytest.mark.parametrize("robot,problemset", [("ur10", "industrial"), ("wam", "industrial")])
def test_full_width_first_step_matches_jax(robot, problemset):
    """The two combos whose card runs fall below the JAX record, at their full
    tuned configuration in float64 on the CPU: the first tuned init
    (``init_slots``) to 1e-12, then one training step's posterior draws on
    JAX's own noise and the collision log-density of the same configs.

    The log-density of the same configs is the same to 1e-12. The draws
    agree to 1e-7 rad, not to float64's 1e-13: the conditioned Gram at these
    lengthscales (M = 18 and 24) is near singular, so the float64 solves of
    the two packages, summed in different orders, differ at that level. From
    there the 130-150-step optimisation diverges, so these combos are held
    to JAX in verdict statistics, not trajectories (PERF.md, ROADMAP.md
    Queue 3)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from _torch_support import jax_path_noise
    from vgpmp_tpu.engine import solver as js
    from vgpmp_tpu.gp import pathwise as jpw
    from vgpmp_tpu.likelihoods.collision import joint_sigmoid
    from vgpmp_tpu.models import vgpmp as jm
    from vgpmp_tpu.session import PlanningSession as JSession
    from vgpmp_torch.convert import params_to_numpy
    from vgpmp_torch.engine import solver as ts
    from vgpmp_torch.models import vgpmp as tm
    from vgpmp_torch.session import PlanningSession as TSession

    j = JSession(robot, problemset, dtype=jnp.float64)
    t = TSession(robot, problemset, dtype=torch.float64, device="cpu")
    starts, goals = (x[[0, 7]] for x in j.queries())
    init = j.planner_params["q_mu_inits"][0]
    jp = js.init_slots(j.model, starts, goals, j.planner_params, [init] * 2)
    tp = ts.init_slots(t.model, starts, goals, t.planner_params, [init] * 2)
    for k, v in params_to_numpy(tp).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jp, k)), rtol=1e-12, atol=1e-12, err_msg=k)

    m, N = j.model, j.train_config.time_spacing_X
    X = jnp.linspace(0.0, 1.0, N)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)

    def jax_configs(b):
        p = jm.PlannerParams(**{k: getattr(jp, k)[b] for k in tm.PlannerParams.names()})
        c = jm.constrain(p, m.variance_lower)
        _, chol = jm._gram(m, c)
        q_full = jm._q_mu_full(m, c, jm.query_latent(m, jnp.asarray(starts[b]), jnp.asarray(goals[b])))
        state = jpw.draw_paths(keys[b], m.ny, c["Z"], c["lengthscales"], c["variance"], chol, q_full,
                               c["q_sqrt"], m.num_samples, m.num_bases, jitter=m.jitter)
        return np.asarray(joint_sigmoid(jpw.eval_paths(state, jm._kuf(m, c, X), X), m.limits_low,
                                        m.limits_high))

    want = np.stack([jax_configs(b) for b in range(2)])
    noise = jax_path_noise(keys, j.spec.dof, m.num_inducing + 2, m.num_samples, m.num_bases)
    c, _, _, got = tm._sample_configs(tp, t.model, torch.as_tensor(starts), torch.as_tensor(goals),
                                      torch.tensor(np.asarray(X)), m.num_samples, None, noise, False)
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    sigma = c["sigma_obs"].detach().numpy() * j.train_config.sigma_anneal
    lik_j = np.stack([np.asarray(m.collision.log_prob(jnp.asarray(got[b]), jnp.asarray(sigma[b])))
                      for b in range(2)])
    lik_t = t.model.collision.log_prob(torch.as_tensor(got), torch.as_tensor(sigma)).numpy()
    np.testing.assert_allclose(lik_t, lik_j, rtol=1e-12, atol=1e-12)
    assert (lik_j < 0).any()
