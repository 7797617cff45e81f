"""The stage table of a traced batch (``benchmark/harness/stages.py``) on a
small cell: on the CPU, with host operations standing in for launches, it
finds every stage and round of the batch; on the card it is held to the
flat record of the same batch (``trace.record``): the model's six stages,
``model.other`` included, add up to the step's device time and launches,
and every row's idle time to the batch's. The card test runs with
``python -m pytest benchmark/tests -m cuda``."""

import pytest
import torch

from benchmark.harness import program, stages, trace
from benchmark.tests.conftest import TINY, tiny_cell


def test_stages_of_a_tiny_batch_on_the_cpu():
    system = program.System(tiny_cell(), torch.device("cpu"), overrides=TINY)
    system.warm_up()
    events = stages.traced_batch(system, 2 ** 31 + 3)
    rec = stages.reduce(events, cpu_ops=True)
    rows = rec["rows"]
    assert rec["steps"] > 0 and len(rec["rounds"]) == rec["spans"]["round"] >= 1
    assert rec["spans"]["round.select"] == rec["spans"]["round.fetch"] == len(rec["rounds"])
    for m in stages.MODEL:
        assert rows[f"{m}/fwd"]["launches"] > 0 and rows[f"{m}/bwd"]["launches"] > 0, m
    assert rows["adam_update"]["launches"] > 0 and rows["validate"]["launches"] > 0
    flat = trace.record(trace.reduce_events(events))
    assert rec["steps"] == flat["steps"]
    assert all(r in stages.table(rec) for r in stages.ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["franka-industrial-b512", "wam-industrial-b1024"])
def test_stages_add_up_to_the_step(cuda_device, name):
    system = program.System(tiny_cell(name, rows=64, sizes=(64, 16)), cuda_device,
                            overrides={"num_steps": 8})
    system.warm_up()
    events = stages.traced_batch(system, 2 ** 31 + 3)
    flat = trace.record(trace.reduce_events(events))
    rec = stages.reduce(events)
    print(stages.table(rec))
    model = [rec["rows"][f"{m}/{d}"] for m in stages.STAGES for d in ("fwd", "bwd")]
    step_ms = 1e3 * sum(flat["per_span"][s]["device_s"] for s in ("elbo_forward", "elbo_backward"))
    assert sum(r["device_ms"] for r in model) == pytest.approx(step_ms, rel=0.05)
    assert rec["steps"] == flat["steps"] > 0 and len(rec["rounds"]) >= 1
    assert all(rec["spans"][m] > 0 for m in stages.MODEL)
    idle_ms = 1e3 * (flat["window_s"] - flat["busy_s"])
    assert sum(r["idle_ms"] for r in rec["rows"].values()) == pytest.approx(idle_ms, rel=0.01)
    launches = sum(flat["per_span"][s]["ops"] for s in ("elbo_forward", "elbo_backward"))
    print(f"model launches {sum(r['launches'] for r in model)} (flat {launches}), "
          f"device ms {sum(r['device_ms'] for r in model):.3f} (flat {step_ms:.3f})")
