"""The traced run's record: one batch of the window under ``torch.profiler``
(no stacks, no shapes), reduced to the program's spans, the device
operations with the host time of their launch, and what the per-layer
readers under ``benchmark/metrics`` take; and two stages timed alone with
CUDA events afterwards, on the cell's own shapes.

Spans are the program's ``record_function`` labels: ``elbo_forward``,
``elbo_backward``, ``adam_update``, ``extract`` and ``validate``. A device
operation belongs to the span in whose host interval its launch lies (the
backward's launches come from autograd's device thread while the caller
waits inside ``elbo_backward``).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType

SPANS = ("elbo_forward", "elbo_backward", "adam_update", "extract", "validate")
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
BATCH = "benchmark_batch"  # the benchmark's own span around the traced batch


def profile_call(fn: Callable):
    """``fn()`` under the profiler; returns ``(fn's result, raw events)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(BATCH):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, prof.profiler.kineto_results.events()


def _kind(e) -> str:
    """The profiler's activity type of an event; older PyTorch builds name
    none, and then a device event is a device operation unless it is an
    annotation, and a host event named ``cu...`` is a runtime or driver call."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    note = e.is_user_annotation()
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if note else "kernel"
    if note:
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def kinds(events) -> Dict[str, int]:
    """How many events of each activity type the profiler kept."""
    out: Dict[str, int] = {}
    for e in events:
        k = _kind(e)
        out[k] = out.get(k, 0) + 1
    return out


def reduce_events(events) -> Dict:
    """Spans ``{name: [(start_ns, end_ns)]}`` and device operations ``[(name,
    start_ns, end_ns, launch_ns or None)]``, the launch being the start of
    the host operation the device operation links to."""
    spans: Dict[str, List[Tuple[int, int]]] = {s: [] for s in (*SPANS, BATCH)}
    launch: Dict[int, int] = {}
    raw = []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_OPS:
            raw.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.linked_correlation_id()))
        elif kind != "gpu_user_annotation":
            # a device operation links to the host operation that launched it
            launch[e.correlation_id()] = e.start_ns()
            if kind == "user_annotation" and e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    ops = [(n, s, t, launch.get(c)) for n, s, t, c in raw]
    batch = spans.pop(BATCH)
    return {"spans": {k: sorted(v) for k, v in spans.items()}, "ops": sorted(ops, key=lambda o: o[1]),
            "batch": batch[0] if batch else None}


def _owner(spans: Dict[str, List[Tuple[int, int]]]) -> Callable[[int], str]:
    """Host time -> the name of the span that holds it, or ``"other"``."""
    ivals = sorted((s, t, n) for n, v in spans.items() for s, t in v)
    starts = [s for s, _, _ in ivals]

    def owner(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return ivals[i][2] if i >= 0 and ivals[i][1] >= t else "other"

    return owner


def busy(ops, t0: int, t1: int) -> float:
    """Seconds of ``[t0, t1]`` in which some device operation ran."""
    total, end = 0, t0
    for _, s, t, _ in ops:
        s, t = max(s, end), min(t, t1)
        if t > s:
            total += t - s
            end = t
    return total / 1e9


def record(reduced: Dict) -> Dict:
    """What the per-layer readers take from a traced batch: its wall time is
    the benchmark's span around it, up to the end of its last device
    operation."""
    spans, ops = reduced["spans"], reduced["ops"]
    t0, t1 = reduced["batch"]
    t1 = max([t1] + [t for _, _, t, _ in ops])
    owner = _owner(spans)
    per_span = {n: {"ops": 0, "device_s": 0.0} for n in (*SPANS, "other")}
    by_name: Dict[str, float] = {}
    val_ivals = spans["validate"]
    val_starts = [s for s, _ in val_ivals]
    val_first = [None] * len(val_ivals)
    val_last = [None] * len(val_ivals)
    for name, s, t, at in ops:
        who = owner(at) if at is not None else "other"
        per_span[who]["ops"] += 1
        per_span[who]["device_s"] += (t - s) / 1e9
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
        if who == "validate":
            i = bisect.bisect_right(val_starts, at) - 1
            val_first[i] = s if val_first[i] is None else min(val_first[i], s)
            val_last[i] = t if val_last[i] is None else max(val_last[i], t)
    # the device's idle gaps, each put down to what the host was doing at its middle
    gaps: Dict[str, float] = {}
    end = t0
    for _, s, t, _ in ops:
        if s > end and end >= t0:
            g = min(s, t1) - end
            if g > 0:
                who = owner((end + min(s, t1)) // 2)
                gaps[who] = gaps.get(who, 0.0) + g / 1e9
        end = max(end, t)
    if t1 > end:
        gaps[owner((end + t1) // 2)] = gaps.get(owner((end + t1) // 2), 0.0) + (t1 - end) / 1e9
    span_s = {n: sum(t - s for s, t in v) / 1e9 for n, v in spans.items()}
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy(ops, t0, t1),
        "steps": len(spans["adam_update"]),
        "span_s": span_s,
        "per_span": per_span,
        "validate_s": [(e - s) / 1e9 for s, e in zip(val_first, val_last) if s is not None],
        "ops_by_name": by_name,
        "nccl_s": sum(v for k, v in by_name.items() if "nccl" in k.lower()),
        "k1_records": sum(1 for n, *_ in ops if "loglik_tile_kernel" in n),
        "k2_records": sum(1 for n, *_ in ops if any(x in n for x in ("chol_kernel", "trsm_kernel",
                                                                       "factor_solve"))),
        "breakdown": {
            "device_ops": sorted(([n[:120], v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP],
            "idle_gaps": sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:TOP]},
    }


def time_ms(fn: Callable, reps: int, device) -> float:
    """Mean CUDA-event time of ``fn`` per call, after one warm-up call, with
    the L2 cache (50 MB) flushed before every call."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    fn()
    torch.cuda.synchronize(device)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps
