"""The controls on the card, at each one-card cell's own round-0 size: the
program one precision step below the configuration's fails the comparison
that decides ``correct``, where the program as configured passes it. (At 64
rows cuBLAS keeps wam's small products off the TF32 path, and TF32 then
failed no number.) Run on the card: ``python -m pytest benchmark/tests -m cuda``."""

import pytest
import torch

from benchmark.harness import check, program, traffic
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT

NUMBERS = ("elbo_gap", "grad_gap", "change_gap", "best_gap")


def numbers(system, pb, seed):
    s, g = traffic.batch(system.starts, system.goals, system.rows, 0)
    out = check.model_numbers(system, pb, s, g, seed)
    out.pop("_verdicts")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["franka-industrial-b512", "wam-industrial-b1024"])
def test_controls_fail_where_the_program_passes(cuda_device, name):
    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(ROOT), name, ROOT)
    limits = cell["limits"]
    cfg = cell["config"]
    sound = program.System(cell, cuda_device)
    pb = ref.Problem.load(ROOT / cfg["assets"], cfg["robot"], cfg["problemset"], sound.pp, cuda_device)
    island = program.System(cell, cuda_device, overrides={"solve_dtype": torch.float32})
    for seed in (1, 2, 3):
        ok = numbers(sound, pb, seed)
        assert all(ok[k] <= limits[k] for k in NUMBERS), ok
        bad = numbers(island, pb, seed)
        assert any(bad[k] > limits[k] for k in NUMBERS), bad
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            bad = numbers(sound, pb, seed)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert any(bad[k] > limits[k] for k in NUMBERS), bad
