"""Profiling and observability helpers (port of ``vgpmp_tpu/utils/profiling.py``).

- :func:`timing`: a wall-clock decorator that waits for the device when an
  output lies on CUDA (``torch.cuda.synchronize``), so that it times the work
  and not its launch;
- :func:`trace`: a ``torch.profiler`` window that writes a Chrome trace
  (``chrome://tracing``, Perfetto);
- :func:`grad_tap`: the identity forward whose backward prints or records the
  upstream gradient (the reference's ``check_gradients`` idea).
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch

__all__ = ["timing", "trace", "grad_tap"]

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"  # git-ignored


def _on_cuda(out) -> bool:
    """Whether any tensor in ``out`` (nested tuples, lists, dicts, named
    tuples, dataclass-like objects with ``leaves()``) lies on a CUDA device."""
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(v) for v in out)
    if hasattr(out, "leaves"):
        return _on_cuda(out.leaves())
    return False


def timing(f: Callable) -> Callable:
    """Print ``f``'s wall-clock ms per call, after the device has finished
    where an output lies on CUDA."""

    @functools.wraps(f)
    def wrap(*args, **kwargs):
        t0 = time.perf_counter()
        out = f(*args, **kwargs)
        if _on_cuda(out):
            torch.cuda.synchronize()
        print(f"{f.__name__} took {(time.perf_counter() - t0) * 1e3:.3f} ms")
        return out

    return wrap


@contextlib.contextmanager
def trace(log_dir=DEFAULT_TRACE_DIR) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (host, and the CUDA device when there is
    one) and write ``log_dir/trace.json``::

        with profiling.trace(log_dir) as prof:
            solve(...)
        prof.key_averages()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class _Tap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, printer):
        ctx.name, ctx.printer = name, printer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.printer is None:
            print(f"{ctx.name}: upstream grad = {g}")
        else:
            ctx.printer(g)
        return g, None, None


def grad_tap(x: torch.Tensor, name: str = "tap",
             printer: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
    """``x`` unchanged; in the backward pass the upstream gradient goes to
    ``printer`` (or is printed with ``name``) and on unchanged."""
    return _Tap.apply(x, name, printer)
