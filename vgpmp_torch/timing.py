"""Timing of work on the CUDA device, shared by the smoke run and the tools."""

from __future__ import annotations

import torch

__all__ = ["time_ms", "l2_flush_buffer"]


def l2_flush_buffer(device) -> torch.Tensor:
    """A buffer several times the 50 MB L2 of an H100; rewriting it evicts
    whatever a kernel left there."""
    return torch.empty(256 * 2**20, dtype=torch.uint8, device=device)


def time_ms(fn, reps: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean CUDA-event time of ``fn`` per call, after one warm-up call;
    ``flush`` (see :func:`l2_flush_buffer`) is rewritten between calls so
    that each call finds the L2 cold, as a caller in a larger program does."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps
