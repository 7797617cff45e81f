"""The port's benchmark driver ``bench_torch.py`` at a tiny budget on the CPU:
one stdout line with ``bench.py``'s keys plus ``card``, and no write to the
JAX bench's files."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

TINY = dict(num_steps=2, num_samples=2, num_bases=16, num_inducing=4, time_spacing_X=6,
            time_spacing_Xnew=8, q_mu_inits=["frand5", "linear"])


def test_bench_torch_prints_bench_keys_on_the_cpu(capsys):
    partial = (ROOT / "BENCH_PARTIAL.json").read_bytes()
    result = bench_torch.run(device="cpu", overrides=TINY, batch=8, adaptive_rounds=0)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    want = set(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]) | {"card"}
    assert set(result) == want
    assert result["card"] == "cpu" and result["throughput_batch"] == 8
    assert result["adaptive"]["inits"] == ["frand5", "linear"] and result["adaptive"]["max_rounds"] == 2
    assert 1.0 <= result["adaptive"]["k_eff"] <= 2.0
    assert result["value"] > 0 and 0.0 <= result["success_rate"] <= 1.0
    assert result["budget"].startswith("2 steps, S=2, B_rff=16, M=4 per restart")
    assert (ROOT / "BENCH_PARTIAL.json").read_bytes() == partial
    real = json.loads((ROOT / "chiprun_out" / "bench_torch_partial.json").read_text())
    assert real["throughput_batch"] == 36 and real["card"] == "cpu"


def test_bench_torch_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.run()
