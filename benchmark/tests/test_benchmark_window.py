"""The window's arithmetic: whole batches, no batch started after the
window's seconds, and a stall anywhere in it lowers the rate."""

from benchmark.harness import window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def batches(durations, seconds, at_least=1):
    clock = Clock()

    def run_batch(k):
        clock.t += durations[k]
        return {"rows": 100, "executed": 90, "failed": 0, "rounds": 3, "spent": 150}

    return window.run(seconds, run_batch, clock=clock, at_least=at_least)


def test_whole_batches_until_the_seconds_have_passed():
    out = batches([4.0] * 10, 10.0)
    # batches start at 0, 4 and 8 s; the third ends at 12 s, after the window's 10
    assert [b.index for b in out] == [0, 1, 2]
    t = window.totals(out)
    assert t["seconds"] == 12.0
    assert t["solves_per_s"] == 300 / 12.0
    assert t["executed_share"] == 0.9
    assert t["restarts_per_problem"] == 1.5


def test_at_least_runs_that_many_batches():
    assert len(batches([30.0] * 5, 10.0, at_least=2)) == 2
    assert len(batches([30.0] * 5, 10.0)) == 1


def test_a_stall_in_one_batch_lowers_the_rate():
    steady = window.totals(batches([4.0] * 10, 20.0))
    stalled = window.totals(batches([4.0, 4.0, 9.0] + [4.0] * 7, 20.0))
    assert stalled["solves_per_s"] < steady["solves_per_s"]
    # the stall counts whole: 4 batches of 100 in 21 s against 5 in 20 s
    assert steady["solves_per_s"] == 500 / 20.0
    assert stalled["solves_per_s"] == 400 / 21.0


def test_processes_in_step_follow_one_decision():
    clock = Clock()
    seen = []

    def run_batch(k):
        clock.t += 1.0
        return {"rows": 1, "executed": 1, "failed": 0, "rounds": 1, "spent": 1}

    def go(k, wants):
        seen.append(wants)
        return k < 2  # rank 0's decision, whatever this rank wanted

    out = window.run(100.0, run_batch, clock=clock, go=go)
    assert len(out) == 2 and seen == [True, True, True]
