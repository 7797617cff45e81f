"""Whole runs on the CPU at a small size, the look for a card skipped: a
sound run comes out correct, and each fault a cell can have, planted in the
timed path, makes ``correct`` false. Also the import guard."""

import argparse
import os
import sys

import pytest
import torch

from benchmark import run
from benchmark.harness import program
from benchmark.tests.conftest import ROOT, TINY, tiny_cell


def one_run(cell=None, seed=2 ** 31 + 11):
    cell = cell or tiny_cell()
    args = argparse.Namespace(workload=cell["workload"]["name"], seed=seed, seconds=0.1, trace=0, port=0)
    rc, line = run.finish(cell, args, [run.run_rank(cell, args, "cpu", overrides=TINY)])
    assert rc == 0
    return line


def failing(line):
    return {k for k, c in line["checks"].items() if not c["value"] <= c["limit"]}


def test_a_sound_run_is_correct():
    line = one_run()
    assert line["correct"], line["checks"]
    assert line["attempted"] == 12 and list(line["checks"])[-1] == "choice_mismatch"
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"solves_per_s", "executed_share", "setup_s"}


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from vgpmp_torch.engine import solver

    monkeypatch.setattr(solver.BatchedAdam, "step", lambda self, params, grads: params)
    line = one_run()
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("kept", ["first", "last"])
def test_half_of_the_batch_left_out(monkeypatch, kept):
    """The other half's ELBO detached: the kept rows train exactly as they
    should, the rest never move."""
    from vgpmp_torch.models import vgpmp as planner

    elbo = planner.elbo

    def half(params, model, start, goal, *a, **k):
        v = elbo(params, model, start, goal, *a, **k)
        h = v.shape[0] // 2
        return torch.cat([v[:h], v[h:].detach()]) if kept == "first" else torch.cat([v[:h].detach(), v[h:]])

    monkeypatch.setattr(planner, "elbo", half)
    line = one_run()
    assert not line["correct"]
    assert {"change_gap", "grad_gap"} <= failing(line)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from vgpmp_torch.engine import solver

    evaluate = solver.execute_and_validate

    def flipped(*a, **k):
        rep = evaluate(*a, **k)
        ex = rep.executed.clone()
        ex[0] = ~ex[0]
        return rep._replace(executed=ex)

    monkeypatch.setattr(solver, "execute_and_validate", flipped)
    line = one_run()
    assert not line["correct"]
    assert line["checks"]["verdict_mismatch"]["value"] > 0


def ranks(world, fault):
    port = run.free_port()
    cmds = [[sys.executable, "-m", "benchmark.tests._rank", str(r), str(world), str(port), fault]
            for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    results = sorted(run.spawn_ranks(cmds, env), key=lambda r: r["rank"])
    cell = tiny_cell(rows=4 * world)
    args = argparse.Namespace(workload=cell["workload"]["name"], seed=0, seconds=0.1, trace=0)
    rc, line = run.finish(cell, args, results)
    assert rc == 0 and line["device"]["count"] == world
    return line


def test_four_ranks_over_gloo_are_correct():
    line = ranks(4, "none")
    assert line["correct"], line["checks"]
    assert line["attempted"] % 16 == 0


def test_the_exchange_between_ranks_left_out():
    line = ranks(2, "no_exchange")
    assert not line["correct"]
    assert line["checks"]["verdict_mismatch"]["value"] + line["checks"]["choice_mismatch"]["value"] > 0


def test_forbidden_modules_are_found_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vgpmp_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert program.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert program.forbidden_modules() == ["jax.numpy"]


def test_a_forbidden_module_stops_the_result(monkeypatch):
    cell = tiny_cell()
    args = argparse.Namespace(trace=0)
    clean = {"forbidden": []}
    monkeypatch.setitem(sys.modules, "vgpmp_tpu", object())
    assert run.finish(cell, args, [clean]) == (3, None)
    monkeypatch.delitem(sys.modules, "vgpmp_tpu")
    assert run.finish(cell, args, [{"forbidden": ["flax"]}]) == (3, None)
