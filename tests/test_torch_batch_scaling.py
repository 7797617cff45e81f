"""The port's batch-size sweep (``tools/batch_scaling_torch.py``) on the CPU:
one size's row carries the JAX tool's keys (those of ``SCALING_r05.json``)
plus the port's, and the parent records a child that exits non-zero as a
failed row with its exit code and goes on."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TINY = {"num_steps": 2, "num_samples": 2, "num_bases": 16, "num_inducing": 4, "time_spacing_X": 6,
        "time_spacing_Xnew": 8}
PORT_KEYS = {"steady_runs_seconds", "peak_memory_bytes", "peak_bytes_per_row", "executed_share",
             "launches"}


@pytest.fixture
def tool(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import batch_scaling_torch

    return batch_scaling_torch


def _jax_row_keys():
    rows = json.loads((ROOT / "SCALING_r05.json").read_text())["rows"]
    return set(next(r for r in rows if not r.get("failed")))


def test_run_one_row_has_jax_keys_and_the_ports(tool):
    row = tool.run_one("franka", "industrial", 4, 2, device="cpu", overrides={"num_steps": 2})
    assert set(row) == _jax_row_keys() | PORT_KEYS
    assert row["batch"] == 4 and len(row["steady_runs_seconds"]) == 2
    assert row["steady_seconds"] == min(row["steady_runs_seconds"]) > 0
    assert row["solves_per_sec"] == pytest.approx(4 / row["steady_seconds"])
    assert row["ms_per_problem"] == pytest.approx(1e3 * row["steady_seconds"] / 4)
    assert row["compile_plus_first_seconds"] > 0
    # no card: no device memory to read
    assert row["peak_memory_bytes"] is None and row["peak_bytes_per_row"] is None
    assert 0.0 <= row["executed_share"] <= 1.0 and row["executed_share"] * 4 == int(row["executed_share"] * 4)
    # the CPU runs the plain versions: no kernel is launched
    assert set(row["launches"]) == {"k1_loglik", "k2_factor_solve", "k2_factor_solve_bwd", "k2_trsm",
                                    "k2_chol", "k3_min_clearance", "k3_probe_clearance"}
    assert not any(row["launches"].values())


def test_sweep_records_a_failing_child_and_goes_on(tool, tmp_path):
    out = tmp_path / "scaling.json"
    # batch 0 is refused by the child (ValueError, exit code 1)
    rec = tool.main(["--sizes", "0", "3", "--reps", "1", "--device", "cpu", "--json-out", str(out),
                     "--overrides", json.dumps(TINY)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["card"] == "cpu" and "partial" not in rec
    failed, ok = rec["rows"]
    assert failed["batch"] == 0 and failed["failed"] is True and failed["rc"] == 1
    assert "must be at least 1" in failed["tail"]
    assert ok["batch"] == 3 and not ok.get("failed")
    assert set(ok) == _jax_row_keys() | PORT_KEYS


def test_sweep_raises_without_cuda(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--sizes", "4", "--json-out", str(tmp_path / "s.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.run_one("franka", "industrial", 4, 1)
