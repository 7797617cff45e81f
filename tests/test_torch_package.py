"""Port package rules and the planning session.

- no file of ``vgpmp_torch`` (or ``chip_smoke.py``) imports JAX, flax, optax
  or anything of ``vgpmp_tpu``;
- entry points default to the CUDA device and raise where there is none;
- ``PlanningSession`` builds the same model configuration as the JAX one
  (the one test that loads the full industrial scene).
"""

import ast
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


def test_port_imports_no_jax_package():
    files = sorted((ROOT / "vgpmp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    from vgpmp_torch import resolve_device
    from vgpmp_torch.session import PlanningSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanningSession("franka", "industrial")
    assert resolve_device("cpu") == torch.device("cpu")


def test_session_matches_jax_session():
    import jax.numpy as jnp

    from vgpmp_tpu.session import PlanningSession as JaxSession
    from vgpmp_torch.session import PlanningSession

    js = JaxSession("franka", "industrial", dtype=jnp.float32, sdf_mode="nearest")
    ts = PlanningSession("franka", "industrial", dtype=torch.float32, sdf_mode="nearest",
                         device="cpu")
    for name in ("num_samples", "num_bases", "num_inducing", "jitter", "jitter_escalations",
                 "kernel", "antithetic", "variance_lower"):
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
