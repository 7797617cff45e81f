"""The work counts against shapes worked by hand."""

import math

import pytest
import torch

from benchmark.harness import peaks
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT, TINY
from benchmark.work import k1, k2, rff, step


@pytest.mark.parametrize("entry,n,k,values,ops", [
    ("chol", 12, 0, 78 + 144, 12 ** 3 / 3),
    ("trsm", 3, 2, 6 + 12, 18),
    ("pair", 12, 71, 78 + 144 + 2 * 12 * 71, 12 ** 3 / 3 + 144 * 71),
    ("bwd", 2, 1, 2 * 3 + 4 + 3 * 2, 2 * 4 * 1 + 4 * 8 / 3),
])
def test_k2(entry, n, k, values, ops):
    v, o = k2.work(entry, n, k)
    assert v == values
    assert math.isclose(o, ops)


def test_rff_one_of_everything():
    w = rff.work(B=1, S=1, L=1, N=1, nb=1, Mc=1)
    # two cosines at 8, the prior's two contractions (2 each), the update's (2)
    assert w["f32_flops"] == 8 * 2 + 4 + 2
    assert math.isclose(w["f64_flops"], 1 / 3 + 3)       # a pair at n = 1 with 3 columns
    assert w["bytes"] == 4 + 8 * (1 + 1 + 2 * 3)
    assert math.isclose(w["least_s"], max(22 / peaks.F32_FLOPS + (10 / 3) / peaks.F64_TC_FLOPS,
                                          w["bytes"] / peaks.HBM_BYTES_PER_S))


def test_rff_at_the_bench_shapes_is_bound_by_operations():
    w = rff.work(B=512, S=20, L=7, N=50, nb=1024, Mc=12)
    assert w["f32_flops"] > 2 * 512 * 20 * 7 * 50 * 1024
    assert w["least_s"] == w["f32_flops"] / peaks.F32_FLOPS + w["f64_flops"] / peaks.F64_TC_FLOPS


def test_step_grows_with_rows_and_covers_the_draw():
    a = step.least_s(64, 20, 7, 50, 1024, 10, 37)
    b = step.least_s(128, 20, 7, 50, 1024, 10, 37)
    assert math.isclose(b, 2 * a, rel_tol=1e-12)
    assert a > rff.work(64, 20, 7, 50, 1024, 12)["least_s"]


def test_k1_counts_sectors_and_active_pairs():
    pp = dict(__import__("json").load(open(ROOT / "benchmark/configs/franka-industrial.json"))["planner_params"],
              **TINY)
    pb = ref.Problem.load(ROOT / "vgpmp_tpu/assets", "franka", "industrial", pp, "cpu")
    q = torch.as_tensor(pb.states[:3], dtype=torch.float32)
    w = k1.work(pb, q, sigma_numel=37)
    T, L, P = 3, 7, 37
    assert 1 <= w["sectors"] <= T * P
    assert 0 <= w["active"] <= T * P
    assert w["bytes"] == 32 * w["sectors"] + 4 * (T * L + 37 + T * (1 + L))
    assert w["flops"] == T * (L * 60 + P * 30) + w["active"] * L * 16
    # the same configuration twice reads no new sector
    w2 = k1.work(pb, torch.cat([q, q]), sigma_numel=37)
    assert w2["sectors"] == w["sectors"] and w2["active"] == 2 * w["active"]
