"""The program's ``torch.profiler`` labels of the model's stages and of the
adaptive round, and the benchmark's reduction of a traced batch by stage
(``benchmark/harness/stages.py``), on the CPU with a small franka batch.

- every ``model.*`` span lies inside ``elbo_forward``, as often per step as
  its path opens it; every forward operation of the step with a sequence
  number lies in one, and every backward node maps to its stage but the
  gradients' accumulation and the ELBO's negated sum;
- a label is a no-op while no profiler runs, and changes no number: a
  solve under the profiler is bit-equal to one without;
- ``solve_adaptive`` opens one ``round`` per round, each holding one
  ``round.select`` and one ``round.fetch``; the sharded round solver labels
  its metric ``validate``;
- the reduction, with host operations standing in for launches, counts per
  stage, forward and backward, the operations counted here directly; on a
  made-up card trace it puts launches, host time, idle gaps and
  synchronisations where they belong, and on a program without the labels
  it puts the step on ``model.other``.
"""

import contextlib
import dataclasses
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import stages, trace  # noqa: E402
from vgpmp_torch.engine import solver  # noqa: E402
from vgpmp_torch.parallel.mesh import RankMesh  # noqa: E402
from vgpmp_torch.parallel.sharded import make_sharded_round_solver  # noqa: E402
from vgpmp_torch.session import PlanningSession  # noqa: E402
from vgpmp_torch.utils.profiling import span  # noqa: E402

TINY = dict(num_steps=4, num_samples=2, num_bases=16, num_inducing=4, time_spacing_X=6,
            time_spacing_Xnew=24, num_posterior_samples=8)
ROWS = 4
# how often each path opens each stage per step
PER_STEP = {
    "fused": {"model.gram": 2, "model.rff": 2, "model.k2": 1, "model.collision": 2, "model.kl": 1},
    "escalation": {"model.gram": 2, "model.rff": 3, "model.k2": 4, "model.collision": 2, "model.kl": 1},
}
PER_STEP["aux"] = PER_STEP["fused"]
NOT_MAPPED = ("torch::autograd::AccumulateGrad", "NegBackward0", "SumBackward0")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sessions():
    """franka/industrial in float32 with the float64 island (the fused path),
    and with a float32 island (jitter escalation, the separate calls)."""
    fused = PlanningSession("franka", "industrial", dtype=torch.float32, overrides=TINY, device="cpu")
    esc = PlanningSession("franka", "industrial", dtype=torch.float32, device="cpu",
                          overrides=dict(TINY, solve_dtype=torch.float32))
    assert fused.model.jitter_escalations == 0 and esc.model.jitter_escalations > 0
    return {"fused": fused, "escalation": esc, "aux": fused}


def _chunk(sess, path, steps=2, seed=3):
    cfg = dataclasses.replace(sess.train_config, log_level=int(path == "aux"))
    s, g = (x[:ROWS] for x in sess.queries())
    init_state, train_chunk, _ = solver.make_resumable_solver(sess.model, cfg)
    p = solver.init_slots(sess.model, s, g, sess.planner_params, ["linear"] * ROWS)
    gen = torch.Generator().manual_seed(seed)
    return train_chunk(init_state(p), s, g, gen, n=steps)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def _spans(events):
    out = {}
    for e in events:
        if trace._kind(e) == "user_annotation":
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(t, ivals):
    return any(s <= t < e for s, e in ivals)


def _ops(events):
    return [e for e in events if trace._kind(e) == "cpu_op" and not e.name().startswith(stages.NODE)]


def _nodes(events):
    return [e for e in events if e.name().startswith(stages.NODE)]


def _stage_of_forward(events, spans):
    """``(thread, sequence number) -> stage`` of the step's forward operations."""
    out = {}
    for e in _ops(events):
        if e.sequence_nr() >= 0:
            for m in stages.MODEL:
                if _inside(e.start_ns(), spans.get(m, [])):
                    out[(e.start_thread_id(), e.sequence_nr())] = m
    return out


def test_a_label_does_nothing_without_a_profiler():
    assert isinstance(span("model.rff"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(span("model.rff"), record_function)
        with span("model.rff"):
            pass
    with span("model.rff"):  # no profiler: nothing is recorded, nothing fails
        pass
    labels = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert labels == ["model.rff"]


@pytest.mark.parametrize("path", ["fused", "escalation", "aux"])
def test_model_spans_lie_inside_the_step(sessions, path):
    steps = 2
    _, events = _profiled(lambda: _chunk(sessions[path], path, steps))
    spans = _spans(events)
    fwd = spans["elbo_forward"]
    assert len(fwd) == steps
    for m, n in PER_STEP[path].items():
        assert len(spans.get(m, [])) == n * steps, m
        for s, e in spans[m]:
            assert any(a <= s and e <= b for a, b in fwd), m
    assert set(spans) >= set(stages.MODEL)
    # every forward operation of the step with a sequence number lies in a stage
    # (but, logging, the step's detached copies of its metrics)
    for e in _ops(events):
        if e.sequence_nr() >= 0 and _inside(e.start_ns(), fwd):
            assert any(_inside(e.start_ns(), spans[m]) for m in stages.MODEL) or \
                (path == "aux" and e.name() == "aten::detach"), e.name()
    # every backward node maps to its stage, but the accumulation and the ELBO's -sum
    stage_of = _stage_of_forward(events, spans)
    loss = {(e.start_thread_id(), e.sequence_nr()) for e in _ops(events)
            if e.sequence_nr() >= 0 and _inside(e.start_ns(), spans["elbo_backward"])}
    nodes = _nodes(events)
    assert nodes
    unmapped = Counter()
    for e in nodes:
        key = (e.fwd_thread_id(), e.sequence_nr())
        if key not in stage_of:
            assert key in loss or e.name().endswith("AccumulateGrad"), e.name()
            unmapped[e.name()[len(stages.NODE):]] += 1
    assert set(unmapped) <= set(NOT_MAPPED) and unmapped["NegBackward0"] == steps


@pytest.mark.parametrize("path", ["fused", "escalation"])
def test_spans_change_no_number(sessions, path):
    (plain, hist, _) = _chunk(sessions[path], path, steps=3)
    (traced, hist_t, _), _ = _profiled(lambda: _chunk(sessions[path], path, steps=3))
    assert torch.equal(hist, hist_t)
    for k, v in plain.params.leaves().items():
        assert torch.equal(v, getattr(traced.params, k)), k


def test_one_round_span_per_round(sessions):
    sess = sessions["fused"]
    s, g = (x[:6] for x in sess.queries())
    (best, _, info), events = _profiled(lambda: solver.solve_adaptive(
        sess.model, sess.train_config, s, g, sess.planner_params, inits=("linear", "frand0", "zeros"),
        max_rounds=4, seed=5, round_sizes=(6, 4)))
    assert info["rounds"] >= 2 and best.shape[0] == 6
    spans = _spans(events)
    rounds = spans["round"]
    assert len(rounds) == info["rounds"]
    for child in ("round.select", "round.fetch"):
        assert len(spans[child]) == len(rounds)
        assert all(sum(a <= s and e <= b for s, e in spans[child]) == 1 for a, b in rounds), child
    # each round's steps, extraction and metric lie inside it
    for name in ("elbo_forward", "adam_update", "extract", "validate"):
        assert all(_inside(s, rounds) for s, _ in spans[name]), name
    rec = stages.reduce(events, cpu_ops=True)
    assert len(rec["rounds"]) == info["rounds"] and rec["steps"] == len(spans["adam_update"])
    assert rec["rows"]["round.select"]["launches"] > 0 and rec["rows"]["round.fetch"]["launches"] > 0


def test_the_sharded_round_solver_labels_its_metric(sessions):
    sess = sessions["fused"]
    s, g = (x[:ROWS] for x in sess.queries())
    mesh = RankMesh(dp=1, sp=1, dp_index=0, sp_index=0, device=torch.device("cpu"))
    solve = make_sharded_round_solver(sess.model, sess.train_config, mesh)
    p = solver.init_slots(sess.model, s, g, sess.planner_params, ["linear"] * ROWS)
    _, events = _profiled(lambda: solve(p, s, g, torch.Generator().manual_seed(1)))
    spans = _spans(events)
    assert len(spans["validate"]) == 1 and len(spans["extract"]) == 1


def test_stage_table_counts_the_host_ops(sessions):
    steps = 2
    _, events = _profiled(lambda: _chunk(sessions["fused"], "fused", steps))
    rec = stages.reduce(events, cpu_ops=True)
    rows, spans = rec["rows"], _spans(events)
    assert rec["steps"] == steps and rec["spans"]["model.rff"] == 2 * steps
    ops = _ops(events)
    assert sum(r["launches"] for r in rows.values()) == len(ops)
    # forward: the operations that start inside each stage's spans
    for m in stages.MODEL:
        assert rows[f"{m}/fwd"]["launches"] == sum(_inside(e.start_ns(), spans[m]) for e in ops), m
    # backward: the operations inside the nodes of each stage's forward operations
    stage_of = _stage_of_forward(events, spans)
    by_stage = {}
    for n in _nodes(events):
        m = stage_of.get((n.fwd_thread_id(), n.sequence_nr()), "model.other")
        by_stage.setdefault(m, []).append((n.start_ns(), n.start_ns() + n.duration_ns()))
    for m in stages.MODEL:
        assert rows[f"{m}/bwd"]["launches"] == sum(_inside(e.start_ns(), by_stage[m]) for e in ops), m
        assert rows[f"{m}/bwd"]["launches"] > 0 and rows[f"{m}/fwd"]["launches"] > 0, m
    assert rows["adam_update"]["launches"] == sum(_inside(e.start_ns(), spans["adam_update"]) for e in ops)
    # host time: each step's spans are covered once, by their stages
    step_ms = sum(e - s for n in ("elbo_forward", "elbo_backward") for s, e in spans[n]) / 1e6
    model_ms = sum(rows[f"{m}/{d}"]["host_self_ms"] for m in stages.STAGES for d in ("fwd", "bwd"))
    assert model_ms == pytest.approx(step_ms, rel=1e-9)


class _Ev:
    """A profiler event as ``stages.reduce`` reads it (times in microseconds)."""

    def __init__(self, kind, name, start, dur=0, tid=1, seq=-1, fwd_tid=0, corr=0, linked=0):
        self.kind, self._name, self.s, self.d = kind, name, int(start * 1000), int(dur * 1000)
        self.tid, self.seq, self.fwd_tid, self.corr, self.linked = tid, seq, fwd_tid, corr, linked

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def start_thread_id(self):
        return self.tid

    def fwd_thread_id(self):
        return self.fwd_tid

    def sequence_nr(self):
        return self.seq

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def _card_trace(labels=True):
    """One round of one step on a made-up card: each kernel links to the
    host operation that launched it, the backward's on autograd's thread
    while the host waits in ``elbo_backward`` (the engine's 10 µs between
    the Add and the Cos node is the Cos node's); runtime calls carry
    correlation ids and thread ids of their own."""
    span = lambda n, s, d, c: _Ev("user_annotation", n, s, d, corr=c)
    runtime = lambda n, s, c: _Ev("cuda_runtime", n, s, 1, tid=901, corr=c)
    kernel = lambda s, d, c: _Ev("kernel", "k", s, d, tid=7, linked=c)
    ev = [span(trace.BATCH, 0, 1000, 1), span("elbo_forward", 100, 200, 2),
          span("elbo_backward", 300, 200, 3), span("adam_update", 500, 100, 4),
          _Ev("cpu_op", "aten::mul", 130, 10, seq=7, corr=11), runtime("cudaLaunchKernel", 140, 1),
          kernel(150, 100, 11),
          _Ev("cpu_op", "aten::add", 250, 5, seq=8, corr=12), runtime("cudaLaunchKernel", 255, 2),
          kernel(260, 20, 12),
          _Ev("cpu_op", "aten::fill_", 310, 2, corr=13), runtime("cudaLaunchKernel", 311, 3),
          kernel(315, 5, 13),
          _Ev("cpu_op", stages.NODE + "MulBackward0", 330, 70, tid=2, seq=7, fwd_tid=1, corr=14),
          _Ev("cpu_op", "aten::mul", 340, 20, tid=2, corr=15), runtime("cudaLaunchKernel", 350, 4),
          kernel(360, 90, 15),
          _Ev("cpu_op", stages.NODE + "AddBackward0", 410, 10, tid=2, seq=8, fwd_tid=1, corr=16),
          _Ev("cpu_op", "aten::cos", 160, 5, seq=9, corr=18),
          _Ev("cpu_op", stages.NODE + "CosBackward0", 430, 10, tid=2, seq=9, fwd_tid=1, corr=19),
          _Ev("cpu_op", "aten::add_", 510, 5, corr=17), runtime("cudaLaunchKernel", 511, 5),
          kernel(520, 10, 17),
          runtime("cudaStreamSynchronize", 50, 6), runtime("cudaStreamSynchronize", 650, 7)]
    if labels:
        ev += [span("round", 0, 900, 21), span("round.select", 0, 100, 22), span("model.rff", 120, 80, 23),
               span("round.fetch", 600, 100, 24)]
    return ev


def test_stage_table_on_a_card_like_trace():
    rec = stages.reduce(_card_trace())
    rows = rec["rows"]
    want = {"model.rff/fwd": (1, 0.1, 0.08, 0.0), "model.other/fwd": (1, 0.02, 0.12, 0.045),
            "model.rff/bwd": (1, 0.09, 0.09, 0.04), "model.other/bwd": (1, 0.005, 0.11, 0.07),
            "adam_update": (1, 0.01, 0.1, 0.0), "round.select": (0, 0.0, 0.1, 0.15),
            "round.fetch": (0, 0.0, 0.1, 0.0), "round": (0, 0.0, 0.2, 0.47), "other": (0, 0.0, 0.1, 0.0)}
    for r, v in rows.items():
        got = (v["launches"], v["device_ms"], v["host_self_ms"], v["idle_ms"])
        assert got == pytest.approx(want.get(r, (0, 0.0, 0.0, 0.0)), abs=1e-12), r
    assert rows["round.select"]["syncs"] == 1 and rows["round.fetch"]["syncs"] == 1
    assert rec["rounds"] == [{"ms": 0.9, "syncs": 2}] and rec["steps"] == 1
    assert rec["window_ms"] == 1.0 and rec["idle_ms"] == pytest.approx(0.775)
    # the flat record of the same batch: the same idle time, the step's device time
    flat = trace.record(trace.reduce_events(_card_trace()))
    assert sum(v for _, v in flat["breakdown"]["idle_gaps"]) * 1e3 == pytest.approx(rec["idle_ms"])
    step = sum(flat["per_span"][s]["device_s"] for s in ("elbo_forward", "elbo_backward")) * 1e3
    assert sum(rows[f"{m}/{d}"]["device_ms"] for m in stages.STAGES for d in ("fwd", "bwd")) == \
        pytest.approx(step)


@pytest.mark.parametrize("labels", [True, False])
def test_stage_table_with_and_without_labels(labels):
    """A program without the labels (the parent of the change that added
    them) reduces too: its step falls on ``model.other``, it has no rounds,
    and the device time, launches and idle are the same."""
    rec = stages.reduce(_card_trace(labels))
    rows = rec["rows"]
    text = stages.table(rec)
    assert all(r in text for r in stages.ROWS)
    fwd = {m: rows[f"{m}/fwd"]["device_ms"] for m in stages.STAGES}
    if labels:
        assert fwd["model.rff"] == pytest.approx(0.1) and len(rec["rounds"]) == 1
        assert rows["round.select"]["idle_ms"] + rows["round.fetch"]["idle_ms"] + \
            rows["round"]["idle_ms"] == pytest.approx(0.62)
    else:
        assert all(v == 0 for m, v in fwd.items() if m != "model.other") and rec["rounds"] == []
        assert fwd["model.other"] == pytest.approx(0.12) and rows["other"]["syncs"] == 2
        assert rows["round"] == dict.fromkeys(stages.FIELDS, 0)
    assert sum(r["launches"] for r in rows.values()) == 5
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(0.225)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(rec["idle_ms"]) == pytest.approx(0.775)
