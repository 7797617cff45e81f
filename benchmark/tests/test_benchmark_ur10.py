"""The ``ur10-bookshelves`` configuration and the two cells beside it: the
port's plain path against the plain reference (``_ur10``'s checks), a whole
tiny run of the UR10 cell, both new cells found by name with the metrics
they report, the four-card share of the cells, and the readers of kernel
device time and NCCL time on a synthetic record."""

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest, program
from benchmark.tests import _ur10
from benchmark.tests.conftest import ROOT, tiny_cell
from benchmark.tests.test_benchmark_faults import one_run

UR10 = "ur10-bookshelves-b3520"
DP4 = "franka-industrial-b2048-dp4"


@pytest.fixture(scope="module")
def pair():
    return _ur10.session_and_problem()


def test_the_configuration_is_what_the_session_runs(pair):
    _ur10.check_configuration(*pair)


def test_the_arm_reaches_the_shelves(pair):
    _ur10.check_the_arm_reaches_the_shelves(*pair)


def test_sphere_positions(pair):
    _ur10.check_sphere_positions(*pair)


def test_lookups(pair):
    _ur10.check_lookups(*pair)


def test_elbo_gradient_and_adam(pair):
    _ur10.check_elbo_gradient_and_adam(*pair)


def test_metric_verdicts(pair):
    _ur10.check_metric_verdicts(*pair)


def test_engine_replay_matches_solve_adaptive():
    _ur10.check_engine_replay()


def test_a_tiny_run_of_the_ur10_cell_is_correct():
    line = one_run(tiny_cell(UR10, rows=12, sizes=(12, 6, 4)))
    assert line["correct"], line["checks"]
    assert line["attempted"] == 12 and line["failed"] == 0


def test_both_new_cells_load():
    m = manifest.load(ROOT)
    u, d = manifest.cell(m, UR10, ROOT), manifest.cell(m, DP4, ROOT)
    assert (u["workload"]["chips"], u["config"]["robot"], u["config"]["problemset"]) == (1, "ur10", "bookshelves")
    assert (u["traffic"]["rows"], u["traffic"]["round_sizes"], u["traffic"]["pool"]) == (3520, [3520, 880, 440], 4)
    assert u["traffic"]["rows"] == 64 * u["config"]["shapes"]["queries"]
    assert len(u["config"]["planner_params"]["q_mu_inits"]) + program.EXTRA_ROUNDS == 5
    assert (d["workload"]["chips"], d["config"]["name"]) == (4, "franka-industrial")
    assert (d["traffic"]["rows"], d["traffic"]["round_sizes"], d["traffic"]["pool"]) == (2048, [2048, 512, 256], 4)
    assert len(d["config"]["planner_params"]["q_mu_inits"]) + program.EXTRA_ROUNDS == 8
    for c in (u, d):
        assert {x["name"] for x in c["per_layer"]} >= {"k1_device_ms_per_step", "k3_device_ms_per_round"}
        assert {x["name"] for x in c["end_to_end"]} == {"solves_per_s", "executed_share", "setup_s"}
    # the one-card cell reports every accepted one-card metric; the four-card one its NCCL time
    one_card = {x["name"] for x in manifest.cell(m, "franka-industrial-b512", ROOT)["per_layer"]}
    assert {x["name"] for x in u["per_layer"]} == one_card | {"k1_device_ms_per_step", "k3_device_ms_per_round"}
    assert "collective_ms_per_round" in {x["name"] for x in d["per_layer"]}
    assert "collective_ms_per_round" not in {x["name"] for x in u["per_layer"]}


def test_at_most_a_quarter_of_the_cells_ask_for_four_cards():
    m = manifest.load(ROOT)
    four = [w["name"] for w in m["workloads"] if w["chips"] == 4]
    assert four == [DP4] and len(m["workloads"]) == 4
    assert len(four) <= max(1, len(m["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in m["workloads"])


def _rec(ops, steps=10, validate=(0.004, 0.006)):
    return {"trace": {"steps": steps, "validate_s": list(validate), "ops_by_name": ops}}


OPS = {
    "void (anonymous namespace)::loglik_tile_kernel<float, 0, 6, false, true, false, false>(...)": 0.010,
    "void (anonymous namespace)::loglik_tile_kernel_blocks<double, 0, 7, true, true, false, false>(...)": 0.002,
    "void (anonymous namespace)::dsigma_kernel<float>(...)": 0.001,
    "void (anonymous namespace)::clearance_tile_kernel<float, 6, false, true, false>(...)": 0.003,
    "void (anonymous namespace)::clearance_tile_kernel<float, 6, false, false, false>(...)": 0.001,
    "void (anonymous namespace)::k6::fwd_kernel<float, 3, K6Args<float> >(...)": 0.5,
    "ncclDevKernel_Broadcast_RING_LL(...)": 0.2,
}


def test_the_kernel_readers_on_a_synthetic_record():
    rd = lambda name, rec: run.read_metric(name, rec)
    assert rd("k1_device_ms_per_step", _rec(OPS)) == pytest.approx(1e3 * 0.013 / 10)
    assert rd("k3_device_ms_per_round", _rec(OPS)) == pytest.approx(1e3 * 0.004 / 2)
    # the four-card cell's NCCL time a round, and nothing where no collective ran
    assert rd("collective_ms_per_round", {"trace": {"nccl_s": 0.2}, "traced_rounds": 4}) == pytest.approx(50.0)
    assert rd("collective_ms_per_round", {"trace": {"nccl_s": 0.0}, "traced_rounds": 4}) is None
    # nothing to read: no trace, no steps or rounds, or none of the kernel's operations
    for name in ("k1_device_ms_per_step", "k3_device_ms_per_round"):
        assert rd(name, {"window": {}}) is None
        assert rd(name, _rec(OPS, steps=0, validate=())) is None
        assert rd(name, _rec({"void at::native::vectorized_elementwise_kernel<4>(...)": 1.0})) is None
