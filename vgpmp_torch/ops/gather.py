"""Table gather ``out[i] = table[idx[i]]`` (the port's counterpart of the
Pallas gather kernel in ``tools/gather_bench.py:bench_pallas``).

``table`` holds int32 words: ``[ncells]`` (4-byte entries, the value-only
table the Pallas kernel gathers) or ``[ncells, 2]`` (8-byte entries, a packed
SDF row: value and gradient as 4 x bf16). ``idx`` is int32 of any shape; an
index outside the table is clamped to it, as ``jnp.take`` clamps. On a CUDA
tensor :func:`gather` runs kernel K4 (``csrc/k4_gather.cu``), on a CPU tensor
:func:`gather_plain`.
"""

from __future__ import annotations

import torch

from vgpmp_torch import _build

__all__ = ["gather", "gather_plain", "k4_gather"]


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: advanced indexing with the clamped indices."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def k4_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4 launch: ``table [ncells]`` or ``[ncells, 2]`` int32 and ``idx`` int32,
    both contiguous on CUDA -> ``idx.shape`` (``+ (2,)`` for a row table)."""
    if not table.is_cuda:
        raise ValueError(f"k4_gather: needs CUDA tensors, got the table on {table.device}")
    out = _build.load().k4_gather(table, idx)
    k4_gather.launches += 1
    return out


k4_gather.launches = 0


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with clamped indices: K4 on CUDA, the plain version on the CPU."""
    if table.is_cuda:
        return k4_gather(table, idx.contiguous())
    return gather_plain(table, idx)
