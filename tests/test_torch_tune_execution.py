"""The port's execution-tuning tool (``tools/tune_execution_torch.py``).

``greedy_subsets`` is held bit for bit to the JAX tool's, read from its
source without importing that module (it configures JAX when imported); a
tiny run on the CPU writes the schema the JAX tool writes.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _jax_greedy_subsets():
    """``tools/tune_execution.py:greedy_subsets``, compiled from its source."""
    tree = ast.parse((ROOT / "tools" / "tune_execution.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "greedy_subsets")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "tune_execution.py", "exec"), ns)
    return ns["greedy_subsets"]


@pytest.fixture
def tool(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import tune_execution_torch

    return tune_execution_torch


@pytest.mark.parametrize("seed", range(6))
def test_greedy_subsets_matches_jax(tool, seed):
    rng = np.random.default_rng(seed)
    K, B = int(rng.integers(1, 13)), int(rng.integers(1, 60))
    executed = rng.random((K, B)) < rng.uniform(0.05, 0.9)
    if seed == 0:
        executed[:] = False  # nothing executes: one init, no gain
    inits = [f"init{k}" for k in range(K)]
    want = _jax_greedy_subsets()(executed.copy(), inits)
    assert tool.greedy_subsets(executed.copy(), inits) == want


def test_tiny_run_writes_the_jax_schema(tool, tmp_path, capsys):
    out = tmp_path / "tune.json"
    tiny = dict(num_steps=2, num_samples=2, num_bases=16, num_inducing=4, time_spacing_X=6,
                time_spacing_Xnew=8)
    argv = ["--inits", "linear", "frand0", "--epsilon", "0.05", "0.08", "--device", "cpu",
            "--json-out", str(out), "--set"] + [f"{k}={v}" for k, v in tiny.items()]
    results = tool.main(argv)
    rows = json.loads(out.read_text())
    assert rows == json.loads(json.dumps(results)) and len(rows) == 2
    for row in rows:
        assert set(row) == {"overrides", "union_executed", "per_init_executed", "greedy_subset",
                            "unsolved", "seconds", "device"}
        assert row["overrides"]["epsilon"] in (0.05, 0.08) and row["device"] == "cpu"
        assert set(row["per_init_executed"]) == {"linear", "frand0"}
        assert all(0.0 <= v <= 1.0 for v in row["per_init_executed"].values())
        assert all(0 <= b < 36 for b in row["unsolved"])
        assert len(row["unsolved"]) == round(36 * (1 - row["union_executed"]))
    assert rows[0]["union_executed"] >= rows[1]["union_executed"]
    assert "BEST:" in capsys.readouterr().out
