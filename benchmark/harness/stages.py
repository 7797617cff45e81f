"""The traced batch split by the program's stages: for each stage of the
model, forward and backward, and each span of the engine, the device
operations launched there (count and device time), the host time spent
there and the device's idle gaps put down to it; and, per adaptive round,
the blocking synchronisations the host made in it.

It reads the raw profiler events of :func:`trace.profile_call`, as
:func:`trace.record` does, and leaves that record as it is. Spans nest: on
the thread that opened them, the owner of a host time is the innermost
open span.

- **Forward.** The model's stages are the program's ``model.*`` labels
  (:data:`MODEL`) inside ``elbo_forward``; what ``elbo_forward`` holds
  outside them is ``model.other``. A ``model.*`` label outside the step (the
  extraction draws paths too) belongs to the span around it.
- **Backward.** Each autograd node (``autograd::engine::evaluate_function:
  ...``) carries the sequence number of the forward operation that made it;
  a forward operation with a sequence number that starts inside a stage,
  keyed by ``(thread, sequence number)``, gives the node that stage. Nodes
  with none (the ELBO's sum, the gradients' accumulation) are
  ``model.other``. While the host waits inside ``elbo_backward``, the time
  is the node's then running on autograd's device thread; the engine's time
  between two nodes is the next node's.
- **Device operations** go to the owner of their launch: the host
  operation they link to, on its own thread (where no span or node of that
  thread holds it, the host's timeline at its start). **Idle gaps** go to
  the owner of their midpoint on the host's timeline, as
  :func:`trace.record` puts them down to the flat spans.

Without a device (the CPU) every host operation stands in for a launch:
``reduce(events, cpu_ops=True)``. ``python -m benchmark.harness.stages
--workload <cell> --seed <n>`` prints a cell's table (:func:`main`).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from benchmark.harness import trace

MODEL = ("model.gram", "model.rff", "model.k2", "model.collision", "model.kl")
STAGES = MODEL + ("model.other",)
ENGINE = ("adam_update", "extract", "validate", "round.select", "round.fetch", "round")
ROWS = tuple(f"{s}/{d}" for s in STAGES for d in ("fwd", "bwd")) + ENGINE + ("other",)
SPANS = trace.SPANS + MODEL + ("round", "round.select", "round.fetch")
NODE = "autograd::engine::evaluate_function: "
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
RUNTIME = ("cuda_runtime", "cuda_driver")
FIELDS = ("launches", "device_ms", "host_self_ms", "idle_ms", "syncs")


def _row(labels: list) -> str:
    """The table's row of a host time from the labels open there, outermost
    first: a span's name, or a backward node's row."""
    inner = labels[-1]
    if inner.endswith("/bwd"):
        return inner
    if inner in MODEL:
        if "elbo_forward" in labels:
            return f"{inner}/fwd"
        return _row(labels[:-1]) if len(labels) > 1 else "other"
    if inner == "elbo_forward":
        return "model.other/fwd"
    if inner == "elbo_backward":
        return "model.other/bwd"
    return inner


def _segments(ivals: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str, str]]:
    """One thread's nested intervals ``(start, end, label)`` as disjoint
    segments ``(start, end, row, label)``: each the row and the label of the
    innermost open interval."""
    segs: list = []
    stack: list = []  # (end, label, row)
    cur = 0

    def close(upto: int) -> None:
        nonlocal cur
        while stack and stack[-1][0] <= upto:
            end, lab, row = stack.pop()
            if end > cur:
                segs.append((cur, end, row, lab))
                cur = end

    for s, t, lab in sorted(ivals, key=lambda v: (v[0], -v[1])):
        close(s)
        if stack and s > cur:
            segs.append((cur, s, stack[-1][2], stack[-1][1]))
        labels = [x[1] for x in stack] + [lab]
        stack.append((min(t, stack[-1][0]) if stack else t, lab, _row(labels)))
        cur = s
    close(float("inf"))
    return segs


class _Lookup:
    """Time -> row over disjoint sorted segments, ``"other"`` outside them."""

    def __init__(self, segs):
        self.segs = segs
        self.starts = [s[0] for s in segs]

    def __call__(self, t: int, outside: str = "other") -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.segs[i][2] if i >= 0 and t < self.segs[i][1] else outside


def _is_node(label: str) -> bool:
    return label.endswith("/bwd")


def _overlay(main: list, nodes: list) -> List[Tuple[int, int, str]]:
    """The host's timeline ``(start, end, row)``: the main thread's segments,
    where it waits inside ``elbo_backward`` the rows of the nodes then
    running on other threads. The engine's time between two nodes (taking
    the next from its queue, setting it up) goes to the node it starts."""
    starts = [n[0] for n in nodes]
    out = []  # (start, end, row, is a node)
    for s, e, row, lab in main:
        if lab != "elbo_backward":
            out.append((s, e, row, _is_node(lab)))
            continue
        cur, i = s, max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(nodes) and nodes[i][0] < e:
            a, b = max(nodes[i][0], cur), min(nodes[i][1], e)
            if b > a:
                if a > cur:
                    out.append((cur, a, row, False))
                out.append((a, b, nodes[i][2], True))
                cur = b
            i += 1
        if e > cur:
            out.append((cur, e, row, False))
    for i in range(1, len(out) - 1):
        s, e, row, node = out[i]
        if row == "model.other/bwd" and not node and out[i - 1][3] and out[i + 1][3]:
            out[i] = (s, e, out[i + 1][2], False)
    return [(s, e, row) for s, e, row, _ in out]


def reduce(events, cpu_ops: bool = False) -> Dict:
    """The stage table of one traced batch from the profiler's raw events.

    Returns ``{"rows": {row: {launches, device_ms, host_self_ms, idle_ms,
    syncs}}, "spans": {name: count}, "steps", "rounds": [{"ms", "syncs"}],
    "window_ms", "idle_ms"}``: one row per stage and direction
    (``model.rff/fwd``, ``model.rff/bwd``, ...), per span of the engine
    (``round`` is its own time, outside its select, step and fetch spans)
    and ``other``. ``cpu_ops``: count host operations as the launches (a
    run without a device).
    """
    spans: Dict[int, list] = {}
    nodes: Dict[int, list] = {}
    fwd_ops, launch_at, device, host_ops, syncs = [], {}, [], [], []
    batch = None
    for e in events:
        kind, name = trace._kind(e), e.name()
        s = e.start_ns()
        tid = e.start_thread_id()
        if kind in trace.DEVICE_OPS:
            device.append((s, s + e.duration_ns(), e.linked_correlation_id()))
        elif kind in RUNTIME:
            if name in SYNCS:
                syncs.append(s)
        elif kind == "user_annotation":
            # a device operation links to the host operation that launched it
            launch_at[e.correlation_id()] = (s, tid)
            if name == trace.BATCH:
                batch = (s, s + e.duration_ns(), tid)
            elif name in SPANS:
                spans.setdefault(tid, []).append((s, s + e.duration_ns(), name))
        elif kind == "cpu_op":
            launch_at[e.correlation_id()] = (s, tid)
            if name.startswith(NODE):
                key = (e.fwd_thread_id(), e.sequence_nr())
                nodes.setdefault(tid, []).append((s, s + e.duration_ns(), key))
                continue
            if e.sequence_nr() >= 0:
                fwd_ops.append((s, tid, e.sequence_nr()))
            if cpu_ops:
                host_ops.append((s, s, (s, tid)))
    counts = {n: 0 for n in SPANS}
    for v in spans.values():
        for _, _, n in v:
            counts[n] += 1
    main = batch[2] if batch else max(spans, key=lambda k: len(spans[k]), default=None)

    # the stage of each forward operation, by the spans of its own thread
    span_rows = {tid: _Lookup(_segments(v)) for tid, v in spans.items()}
    stage_of = {}
    for s, tid, seq in fwd_ops:
        row = span_rows[tid](s) if tid in span_rows else "other"
        if row.endswith("/fwd") and row != "model.other/fwd":
            stage_of[(tid, seq)] = row[:-4]

    # every thread's spans and nodes, then the host's timeline
    segs = {}
    for tid in set(spans) | set(nodes):
        ivals = list(spans.get(tid, []))
        ivals += [(s, t, stage_of.get(key, "model.other") + "/bwd") for s, t, key in nodes.get(tid, [])]
        segs[tid] = _segments(ivals)
    others = sorted((s, e, r) for tid, v in segs.items() if tid != main for s, e, r, lab in v
                    if _is_node(lab))
    timeline = _overlay(segs.get(main, []), others)
    owner = _Lookup(timeline)

    rows = {r: dict.fromkeys(FIELDS, 0) for r in ROWS}
    for s, e, r in timeline:
        rows[r]["host_self_ms"] += (e - s) / 1e6
    own = {tid: _Lookup(v) for tid, v in segs.items()}
    launches = host_ops if cpu_ops else [(s, t, launch_at.get(c)) for s, t, c in device]
    for s, t, op in launches:
        row = "other"
        if op is not None:
            at, tid = op
            row = (own[tid](at, None) if tid in own else None) or owner(at)
        rows[row]["launches"] += 1
        rows[row]["device_ms"] += (t - s) / 1e6
    for s in syncs:
        rows[owner(s)]["syncs"] += 1

    # the window and its idle gaps, as trace.record takes them
    ops = sorted((s, t) for s, t, _ in device)
    if batch:
        t0, t1 = batch[0], max([batch[1]] + [t for _, t in ops])
    elif timeline:
        t0, t1 = timeline[0][0], timeline[-1][1]
    else:
        t0 = t1 = 0
    covered = sum(e - s for s, e, _ in timeline)
    rows["other"]["host_self_ms"] += max(t1 - t0 - covered, 0) / 1e6
    idle, end = 0, t0
    for s, t in (ops + [(t1, t1)]) if ops else []:
        g = min(s, t1) - end
        if g > 0:
            rows[owner((end + min(s, t1)) // 2)]["idle_ms"] += g / 1e6
            idle += g
        end = max(end, t)

    sync_at = sorted(syncs)
    rounds = [{"ms": (t - s) / 1e6,
               "syncs": bisect.bisect_right(sync_at, t) - bisect.bisect_left(sync_at, s)}
              for s, t, n in sorted(spans.get(main, [])) if n == "round"]
    return {"rows": rows, "spans": counts, "steps": counts["adam_update"], "rounds": rounds,
            "window_ms": (t1 - t0) / 1e6, "idle_ms": idle / 1e6}


def table(rec: Dict) -> str:
    """The stage table as text, one row a line."""
    head = f"{'stage':<20}" + "".join(f"{f:>14}" for f in FIELDS)
    lines = [head]
    for r, v in rec["rows"].items():
        lines.append(f"{r:<20}" + "".join(f"{v[f]:>14.3f}" if isinstance(v[f], float) else f"{v[f]:>14}"
                                          for f in FIELDS))
    rounds = rec["rounds"]
    lines.append(f"steps {rec['steps']}, rounds {len(rounds)} (ms {[round(x['ms'], 1) for x in rounds]}, "
                 f"syncs {[x['syncs'] for x in rounds]}), window {rec['window_ms']:.1f} ms, "
                 f"idle {rec['idle_ms']:.1f} ms")
    return "\n".join(lines)


def traced_batch(system, seed: int):
    """The raw profiler events of batch 1 of a run seeded ``seed`` on the
    warmed-up ``system`` (:class:`program.System`), after batch 0: the batch
    the benchmark's traced run takes."""
    system.run_batch(0, seed)
    return trace.profile_call(lambda: system.run_batch(1, seed))[1]


def main(argv=None) -> int:
    """``python -m benchmark.harness.stages --workload <cell> --seed <n>``:
    a cell's set-up and warm-up, then its traced batch's stage table on
    standard output. On the card; elsewhere host operations stand in for
    launches."""
    import argparse

    import torch

    import benchmark.run  # noqa: F401  (the benchmark's environment: caches in the checkout, one host thread)
    from benchmark.harness import manifest, program

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    system = program.System(manifest.cell(manifest.load(), args.workload), device)
    system.warm_up()
    print(table(reduce(traced_batch(system, args.seed), cpu_ops=device.type != "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
