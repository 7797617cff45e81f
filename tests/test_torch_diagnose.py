"""The port's failure diagnosis (``tools/diagnose_failures_torch.py``) against
the JAX tool (``tools/diagnose_failures.py``) on the CPU.

Both tools' ``main()`` run on a float32 franka/industrial session with the
adaptive solve replaced, in both packages, by one that returns the same
injected best trajectories and executed mask: 4 failing rows of 36, one
rigged to miss its goal and one with a NaN waypoint. The rows must agree in
keys, problem indices and classes, and in every number to 1e-4 (one unit of
the rounding). The profile behind a row is held to the JAX tool's closure,
recomputed with ``vgpmp_tpu`` functions on the same inputs, to 1e-5.
"""

import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FAILING = (3, 10, 17, 29)
MISS, NAN_ROW = 10, 17


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    cache = jax.config.jax_compilation_cache_dir
    jtool = _load("diagnose_failures_jax_tool", ROOT / "tools" / "diagnose_failures.py")
    jax.config.update("jax_compilation_cache_dir", cache)  # the JAX tool points it at its own
    ttool = _load("diagnose_failures_torch_tool", ROOT / "tools" / "diagnose_failures_torch.py")
    return jtool, ttool


def _injected(starts, goals, T):
    """Smooth trajectories from each start to its goal with a bump, float32;
    row ``MISS`` ends 0.08 rad from its goal, row ``NAN_ROW`` has a NaN
    waypoint, row 29 bends far from the straight line."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, T)[None, :, None]
    bump = np.sin(np.pi * t) * rng.uniform(-0.4, 0.4, (len(starts), 1, starts.shape[1]))
    traj = starts[:, None] + (goals - starts)[:, None] * t + bump
    traj[29] += 1.2 * np.sin(np.pi * t[0])
    traj[MISS, -1] += 0.08
    traj[NAN_ROW, 40, 2] = np.nan
    executed = np.ones(len(starts), dtype=bool)
    executed[list(FAILING)] = False
    return traj.astype(np.float32), executed


@pytest.fixture(scope="module")
def diagnosed(tools, tmp_path_factory):
    """Both tools' ``main()`` on the same injected solve: ``(jax json, torch
    json, calls, models, injected trajectories)``."""
    jtool, ttool = tools
    import vgpmp_tpu.engine.solver as jsolver
    import vgpmp_torch.engine.solver as tsolver

    out = tmp_path_factory.mktemp("diag")
    calls, models, injected = {}, {}, {}

    def fake(pkg):
        def solve_adaptive(model, cfg, starts, goals, planner_params, inits, max_rounds, seed):
            calls[pkg] = dict(inits=tuple(inits), max_rounds=max_rounds, seed=seed)
            models[pkg] = model
            best, executed = _injected(np.asarray(starts), np.asarray(goals),
                                       cfg.time_spacing_Xnew)
            injected[pkg] = best, np.asarray(starts), np.asarray(goals)
            return best, types.SimpleNamespace(executed=executed), {"k_eff": 1.5}
        return solve_adaptive

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsolver, "solve_adaptive", fake("jax"))
        mp.setattr(tsolver, "solve_adaptive", fake("torch"))
        argv = ["--robot", "franka", "--env", "industrial", "--seed", "2", "--adaptive-rounds", "3"]
        mp.setattr(sys, "argv", ["diagnose_failures.py", *argv, "--json-out", str(out / "jax.json")])
        jtool.main()
        result = ttool.main([*argv, "--json-out", str(out / "torch.json"), "--device", "cpu"])
    finally:
        mp.undo()
    jres = json.loads((out / "jax.json").read_text())
    tres = json.loads((out / "torch.json").read_text())
    assert tres == json.loads(json.dumps(result))
    return jres, tres, calls, models, injected


def test_solve_is_called_as_jax_calls_it(diagnosed):
    _, _, calls, _, injected = diagnosed
    assert calls["torch"] == calls["jax"]
    assert calls["torch"]["max_rounds"] == 6 + 3 and calls["torch"]["seed"] == 2
    for got, want in zip(injected["torch"], injected["jax"]):
        np.testing.assert_array_equal(got, want)


def test_rows_match_the_jax_tool(diagnosed):
    jres, tres, _, _, _ = diagnosed
    assert set(jres) <= set(tres)
    assert set(tres) - set(jres) == {"card", "seed", "allow_tf32", "tf32_override_env",
                                     "matmul_probe_err"}
    assert tres["card"] == "cpu" and tres["seed"] == 2
    assert 0 < tres["matmul_probe_err"] < 1e-3  # float32 products on the CPU
    for k in ("robot", "env", "executed", "problems", "k_eff"):
        assert tres[k] == jres[k], k
    assert [r["problem"] for r in tres["failures"]] == list(FAILING)
    assert [r["problem"] for r in jres["failures"]] == list(FAILING)
    for jr, tr in zip(jres["failures"], tres["failures"]):
        assert list(tr) == list(jr)
        assert tr["class"] == jr["class"], (tr, jr)
        for k, v in jr.items():
            if k != "class":
                np.testing.assert_allclose(tr[k], v, rtol=0, atol=1e-4 + 1e-9, err_msg=k)
    by = {r["problem"]: r for r in tres["failures"]}
    assert by[MISS]["class"] == "endpoint-miss" and by[MISS]["endpoint_err_rad"] >= 0.08 - 1e-4
    # a NaN waypoint: np.argmax takes the first NaN and the class falls through
    assert np.isnan(by[NAN_ROW]["worst_violation_m"]) and by[NAN_ROW]["class"] == "deep-sweep"
    assert all(r["class"] in ("endpoint-miss", "graze<1cm", "shallow<3cm", "deep-sweep")
               for r in tres["failures"])


def _jax_profile(col, traj, s, g, R, slack=5e-3):
    """The JAX tool's closure ``profile`` (``tools/diagnose_failures.py``)
    with ``vgpmp_tpu`` functions."""
    from vgpmp_tpu.engine.validator import densify

    dense = densify(traj, 8)
    clear = jnp.min(col.sphere_clearance(dense), axis=-1)
    d_s = jnp.maximum(0.0, -jnp.min(col.sphere_clearance(s)))
    d_g = jnp.maximum(0.0, -jnp.min(col.sphere_clearance(g)))
    dist_s = jnp.max(jnp.abs(dense - s), axis=-1)
    dist_g = jnp.max(jnp.abs(dense - g), axis=-1)
    ramp = lambda d: jnp.maximum(0.0, 1.0 - d / R)
    allowed = jnp.maximum(d_s * ramp(dist_s), d_g * ramp(dist_g))
    viol = -allowed - slack - clear
    end_err = jnp.maximum(jnp.max(jnp.abs(traj[0] - s)), jnp.max(jnp.abs(traj[-1] - g)))
    return viol, clear, dist_s, dist_g, d_s, d_g, end_err


@pytest.mark.parametrize("radius", [0.5, 0.2])
def test_failure_profile_matches_jax_closure(tools, diagnosed, radius):
    _, ttool = tools
    _, _, _, models, injected = diagnosed
    best, starts, goals = injected["torch"]
    names = ("viol", "clear", "dist_s", "dist_g", "d_s", "d_g", "end_err")
    for i in FAILING:
        want = _jax_profile(models["jax"].collision, jnp.asarray(best[i]),
                            jnp.asarray(starts[i], jnp.float32), jnp.asarray(goals[i], jnp.float32),
                            radius)
        got = ttool.failure_profile(models["torch"].collision, torch.as_tensor(best[i]),
                                    torch.as_tensor(starts[i], dtype=torch.float32),
                                    torch.as_tensor(goals[i], dtype=torch.float32), radius)
        for name, w, g in zip(names, want, got):
            assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                       err_msg=f"row {i} {name}")
        assert np.isnan(got[0].numpy()).any() == (i == NAN_ROW)


def test_tool_raises_without_cuda(tools, monkeypatch):
    _, ttool = tools
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttool.main(["--robot", "franka", "--env", "industrial"])
