"""Port package rules and the planning session.

- no file of ``vgpmp_torch`` (nor ``chip_smoke.py``, nor the port's tools)
  imports JAX, flax, optax or anything of ``vgpmp_tpu``, in the source text
  and in a fresh interpreter;
- entry points default to the CUDA device and raise where there is none;
- ``PlanningSession`` builds the same model configuration as the JAX one
  (the one test that loads the full industrial scene).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vgpmp_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


PORT_SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "tools" / "gather_bench_torch.py",
                ROOT / "tools" / "k2_designs.py", ROOT / "tools" / "k1_designs.py",
                ROOT / "tools" / "k3_designs.py", ROOT / "tools" / "k6_designs.py", ROOT / "benchmarking_torch.py",
                ROOT / "tools" / "solve_digest_torch.py", ROOT / "tools" / "launch_multihost_torch.py",
                ROOT / "tools" / "tune_execution_torch.py"]
PORT_TOOLS = ["tools/diagnose_failures_torch.py", "tools/batch_scaling_torch.py",
              "tools/profile_breakdown_torch.py", "tools/gram_bench_torch.py",
              "tools/profiler_drops_torch.py", "tools/gen_scene_sdfs_torch.py", "tools/gen_extents_torch.py"]
PORT_SCRIPTS += [ROOT / t for t in PORT_TOOLS]
NEW_MODULES = ["vgpmp_torch.sim", "vgpmp_torch.engine.validator", "vgpmp_torch.ops.gather",
               "vgpmp_torch.timing", "vgpmp_torch.convert", "vgpmp_torch.engine.solver",
               "vgpmp_torch.config", "vgpmp_torch.engine.analysis", "vgpmp_torch.session",
               "vgpmp_torch.gp.velocity", "vgpmp_torch.engine.replan", "vgpmp_torch.engine.repl",
               "vgpmp_torch.utils.checkpoint", "vgpmp_torch.utils.profiling",
               "vgpmp_torch.parallel.mesh", "vgpmp_torch.parallel.sharded", "vgpmp_torch.parallel.multihost",
               "vgpmp_torch.likelihoods.collision", "vgpmp_torch.ops.linalg", "vgpmp_torch._build",
               "vgpmp_torch.sdf.gen", "vgpmp_torch.kinematics.urdf", "vgpmp_torch.ops.rff"]


def test_port_imports_no_jax_package():
    files = sorted((ROOT / "vgpmp_torch").rglob("*.py")) + PORT_SCRIPTS
    assert len(files) > 20 and all(f.exists() for f in files)
    names = {str(f.relative_to(ROOT / "vgpmp_torch").with_suffix("")).replace("/", ".")
             for f in files[:-len(PORT_SCRIPTS)]}
    assert {m.removeprefix("vgpmp_torch.") for m in NEW_MODULES} <= names
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("target", NEW_MODULES + ["vgpmp_torch.parallel", "chip_smoke", "bench_torch", "tools/gather_bench_torch.py",
                                                   "tools/k2_designs.py", "tools/k1_designs.py",
                                                   "tools/k3_designs.py", "tools/k6_designs.py",
                                                   "benchmarking_torch",
                                                   "tools/solve_digest_torch.py",
                                                   "tools/launch_multihost_torch.py",
                                                   "tools/tune_execution_torch.py",
                                                   "vgpmp_torch.sdf"] + PORT_TOOLS)
def test_importing_the_port_loads_no_jax(target):
    """In a fresh interpreter, importing the module (or loading the script
    without running its entry point) leaves ``sys.modules`` free of JAX and of
    the JAX package."""
    load = (f"import runpy; runpy.run_path({target!r}, run_name='loaded')" if target.endswith(".py")
            else f"import importlib; importlib.import_module({target!r})")
    code = (f"import sys; {load}; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_default_device_raises_without_cuda(monkeypatch):
    from vgpmp_torch import resolve_device
    from vgpmp_torch.session import PlanningSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanningSession("franka", "industrial")
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_to_sdf_raises_without_cuda(monkeypatch, tmp_path):
    """``mesh_to_sdf`` and the scene tool voxelize on the card unless asked
    for the CPU; there is no host voxelizer to fall back to."""
    from vgpmp_torch.sdf.gen import mesh_to_sdf

    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import gen_scene_sdfs_torch

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float64)
    tris = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], dtype=np.int32)
    piece = np.zeros(4, dtype=np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_to_sdf(verts, tris, piece, dim=4, padding=1)
    data, origin, delta = mesh_to_sdf(verts, tris, piece, dim=4, padding=1, device="cpu")
    assert data.device.type == "cpu" and tuple(data.shape) == (7, 7, 7) and delta == 0.25
    obj = tmp_path / "scenes" / "boxes" / "boxes-acd.obj"
    obj.parent.mkdir(parents=True)
    obj.write_text("o t\n" + "".join(f"v {x} {y} {z}\n" for x, y, z in verts)
                   + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris))
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_scene_sdfs_torch.main(["--data-dir", str(tmp_path), "--out-dir", str(tmp_path / "out"),
                                   "--scenes", "boxes", "--dim", "4", "--padding", "1"])
    assert not (tmp_path / "out").exists()


def test_every_kernel_source_is_built_into_an_ignored_directory():
    """``_build.SOURCES`` names every kernel source (K5 among them) and builds
    into ``build/kernels``, which git ignores."""
    from vgpmp_torch import _build

    csrc = ROOT / "vgpmp_torch" / "csrc"
    assert {p.name for p in csrc.glob("k*.cu")} | {"bindings.cpp"} == set(_build.SOURCES)
    assert "k5_mesh_sdf.cu" in _build.SOURCES and (csrc / "k5_mesh_sdf.cuh").exists()
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert {"build/", "build"} & set((ROOT / ".gitignore").read_text().split())


def test_gather_benchmark_raises_without_cuda(monkeypatch):
    """The gather benchmark has no CPU mode."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import gather_bench_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_bench_torch.main()


def test_k1_designs_refuses_without_cuda(monkeypatch):
    """The K1 design timer has no CPU mode: it exits 1 and builds nothing."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import k1_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(k1_designs, "build", lambda sources: pytest.fail("built without CUDA"))
    assert k1_designs.main([]) == 1


def test_k3_designs_refuses_without_cuda(monkeypatch):
    """The K3 design timer has no CPU mode: it exits 1 and builds nothing."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import k3_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(k3_designs, "build", lambda sources: pytest.fail("built without CUDA"))
    assert k3_designs.main([]) == 1


def test_solve_digest_raises_without_cuda(monkeypatch):
    """The solve digest has no CPU mode."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import solve_digest_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_digest_torch.main([])


def test_parallel_entry_points_raise_without_cuda(monkeypatch):
    """The mesh, the runtime and the multi-process tools run on the card unless
    asked for the CPU; there is no other device to fall back to."""
    from vgpmp_torch.parallel import init_distributed, make_mesh
    from vgpmp_torch.parallel.multihost import run_sharded

    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import launch_multihost_torch
    import tune_execution_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sharded("franka", "industrial")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_multihost_torch.main(["--processes", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_execution_torch.main(["--inits", "linear"])
    assert make_mesh(device="cpu").device == torch.device("cpu")


def test_k2_designs_refuses_without_cuda(monkeypatch, capsys):
    """The K2 design comparison has no CPU mode: it exits non-zero."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import k2_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k2_designs.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_round_solver_runs_where_its_model_lives(monkeypatch):
    """``make_round_solver`` follows its model's device: a session asked for
    the CPU gives a CPU round, and without CUDA there is no other session to
    build one from."""
    from _torch_support import planner_models
    from vgpmp_torch.engine import solver
    from vgpmp_torch.session import PlanningSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanningSession("franka", "industrial", overrides=dict(num_steps=1))
    _, _, tmodel = planner_models()
    cfg = solver.TrainConfig(num_steps=1, time_spacing_X=6, time_spacing_Xnew=8,
                             num_posterior_samples=4)
    solve = solver.make_round_solver(tmodel, cfg)
    from vgpmp_torch.models import vgpmp as planner

    lo, hi = tmodel.limits_low.numpy(), tmodel.limits_high.numpy()
    starts = (0.5 * (lo + hi))[None] - 0.2
    goals = (0.5 * (lo + hi))[None] + 0.2
    params = planner.init_params_batch(tmodel, starts, goals, [0], 0.5 * (starts + goals),
                                       [1.5] * 7, 0.2, 0.005, 100.0)
    best, rep = solve(params, starts, goals, torch.Generator().manual_seed(0))
    assert best.device.type == "cpu" and best.shape == (1, 8, 7)
    assert all(v.shape == (1,) for v in rep)


def test_session_matches_jax_session():
    import jax.numpy as jnp

    from vgpmp_tpu.session import PlanningSession as JaxSession
    from vgpmp_torch.session import PlanningSession

    js = JaxSession("franka", "industrial", dtype=jnp.float32, sdf_mode="nearest")
    ts = PlanningSession("franka", "industrial", dtype=torch.float32, sdf_mode="nearest",
                         device="cpu")
    for name in ("num_samples", "num_bases", "num_inducing", "jitter", "jitter_escalations",
                 "kernel", "antithetic", "variance_lower", "velocity_constrained"):
        assert getattr(ts.model, name) == getattr(js.model, name), name
    assert ts.model.solve_dtype == torch.float64 and js.model.solve_dtype == jnp.float64
    for name in ("num_steps", "learning_rate", "lr_peak", "warmup_steps", "sigma_anneal",
                 "time_spacing_X", "time_spacing_Xnew", "num_posterior_samples",
                 "ee_uncertainty", "randomize_timesteps"):
        assert getattr(ts.train_config, name) == getattr(js.train_config, name), name
    for a, b in zip(ts.queries(), js.queries()):
        np.testing.assert_array_equal(a, b)
    assert ts.num_queries == js.num_queries == 36
    np.testing.assert_array_equal(ts.base_pose, js.base_pose)
    np.testing.assert_array_equal(ts.sdf.data.numpy(), np.asarray(js.sdf.data))
    np.testing.assert_array_equal(ts.model.limits_low.numpy(), np.asarray(js.model.limits_low))
    assert ts.planner_params == js.planner_params
