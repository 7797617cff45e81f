"""Shared set-up of the benchmark's own tests: the repository on the path,
one intra-op thread (the plain CPU paths are many small operations), and a
small budget that keeps a whole run of a cell to seconds on the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(num_steps=4, num_samples=2, num_bases=16, num_inducing=4, time_spacing_X=6,
            time_spacing_Xnew=24)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread, and the reference in blocks of a few rows, so
    that a tiny batch still spans blocks."""
    import torch

    from benchmark.harness import check

    monkeypatch.setattr(check, "BLOCK", 4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str = "franka-industrial-b512", rows: int = 12, sizes=(12, 6, 4)):
    """The cell ``name`` as the manifest gives it, with a few rows a batch."""
    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(ROOT), name, ROOT)
    cell["traffic"] = dict(cell["traffic"], rows=rows, round_sizes=list(sizes))
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda:0")
