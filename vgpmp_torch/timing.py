"""Timing of work on the CUDA device, shared by the smoke run and the tools."""

from __future__ import annotations

import subprocess
import time

import torch

__all__ = ["time_ms", "time_stages", "l2_flush_buffer", "card"]


def card(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


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


TOP_KERNELS = 8  # the kernels :func:`time_stages` lists per stage


def time_stages(stages: dict, reps: int, device) -> dict:
    """Per call of each stage (``name -> fn``, its inputs held by ``fn``): on
    the card ``stream_ms`` (CUDA events around ``reps`` back-to-back calls),
    ``device_ms`` (the kernels' summed device time in a ``torch.profiler``
    window over another ``reps`` calls), ``launches`` (device operations in
    that window) and the :data:`TOP_KERNELS` kernels by device time. Every stage's event
    window runs before the first profiler window, since a traced process
    launches more slowly afterwards. On the CPU ``stream_ms`` is host time
    and the device fields are ``None``. Each stage is called once before it
    is timed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for name, fn in stages.items():
        fn()
        sync()
        if cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            ms = s.elapsed_time(e)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = 1e3 * (time.perf_counter() - t0)
        out[name] = {"stream_ms": ms / reps, "device_ms": None, "launches": None, "kernels": None}
    if not cuda:
        return out
    for name, fn in stages.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            sync()
        dev = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
        ranked = sorted(dev, key=lambda ev: -ev.self_device_time_total)[:TOP_KERNELS]
        out[name].update(
            device_ms=sum(ev.self_device_time_total for ev in dev) / 1e3 / reps,
            launches=sum(ev.count for ev in dev) / reps,
            kernels=[{"name": ev.key[:120], "count": ev.count / reps,
                      "device_ms": ev.self_device_time_total / 1e3 / reps} for ev in ranked])
    return out
