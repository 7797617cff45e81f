"""The port's stage breakdown (``tools/profile_breakdown_torch.py``) and Gram
leg (``tools/gram_bench_torch.py``) on the CPU.

- the ten stages carry the names the JAX tool's ``report(...)`` calls give
  them (read from its source: importing it configures JAX);
- both tools write the JAX artifacts' keys (``PROFILE_r05.json``,
  ``GRAM_BENCH.json``) plus the port's, at B = 2 and 2 reps;
- the Gram leg's piece 1 (float64 Gram and Cholesky) is held to
  ``vgpmp_tpu.gp.conditioned.cholesky_kuu`` on the same inputs to 1e-12, and
  piece 5 (the prior KL) to ``vgpmp_tpu.gp.kl.prior_kl`` to 1e-10.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def tools(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import gram_bench_torch
    import profile_breakdown_torch

    return profile_breakdown_torch, gram_bench_torch


def _jax_stage_names():
    tree = ast.parse((ROOT / "tools" / "profile_breakdown.py").read_text())
    return [n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "report"
            and isinstance(n.args[0], ast.Constant)]


def test_stage_names_are_the_jax_tools(tools):
    pb, _ = tools
    names = _jax_stage_names()
    assert len(names) == 10 and list(pb.STAGES) == names
    assert pb.STEP == names[-1]


def test_breakdown_writes_the_jax_keys_on_the_cpu(tools, tmp_path):
    pb, _ = tools
    out = tmp_path / "pb.json"
    rec = pb.main(["--batch", "2", "--reps", "2", "--device", "cpu", "--json-out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    jax_rec = json.loads((ROOT / "PROFILE_r05.json").read_text())
    assert set(rec) == set(jax_rec) | {"stages_device_ms", "stages_launches", "stages_kernels",
                                       "kernel_launches", "reps", "card"}
    assert rec["card"] == "cpu" and rec["device"] == "cpu" and rec["batch"] == 2 and rec["reps"] == 2
    assert set(rec["shapes"]) == set(jax_rec["shapes"])
    assert rec["shapes"] == {"S": 20, "N": 50, "L": 7, "P": 37, "M": 10, "bases": 1024}
    assert list(rec["stages_ms"]) == list(jax_rec["stages_ms"])
    assert all(v > 0 for v in rec["stages_ms"].values())
    # no card: no device time is reported
    for key in ("stages_device_ms", "stages_launches", "stages_kernels"):
        assert list(rec[key]) == list(rec["stages_ms"]) and all(v is None for v in rec[key].values())
    assert rec["projected_full_optimize_seconds"] == pytest.approx(
        rec["stages_ms"][pb.STEP] * 200 / 1e3)
    assert not any(rec["kernel_launches"].values())


def test_gram_bench_writes_the_jax_keys_on_the_cpu(tools, tmp_path):
    _, gb = tools
    out = tmp_path / "gb.json"
    rec = gb.main(["--batch", "2", "--reps", "2", "--device", "cpu", "--json-out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    jax_rec = json.loads((ROOT / "GRAM_BENCH.json").read_text())
    # the round-4 twin is not ported
    assert set(rec) == (set(jax_rec) - {"draw_eval_r4_ms"}) | {
        "card", "reps", "device_ms", "launches", "kernels", "kernel_launches", "kernel_launches_by_dtype"}
    assert rec["gram_chol_f32_ms"] > 0
    assert set(rec["shapes"]) == set(jax_rec["shapes"]) and rec["shapes"]["batch"] == 2
    assert set(jax_rec["roofline"]) <= set(rec["roofline"])
    assert all(rec[f"{k}_ms"] > 0 for k in rec["device_ms"])
    assert all(v is None for v in rec["device_ms"].values())
    roof = rec["roofline"]
    assert roof["rff_cos_evals"] == 2 * 7 * 50 * 1024 and roof["rff_mac_flops"] == 2 * 2 * 20 * 7 * 50 * 1024
    assert roof["rff_bound_ms"] == max(roof["rff_flops_bound_ms"], roof["rff_bytes_bound_ms"])
    assert roof["rff_share_of_bound"] is None


def _jax_inputs(inp):
    return {k: jnp.asarray(v.numpy()) for k, v in inp.items()}


def test_gram_piece1_matches_jax_cholesky(tools):
    from vgpmp_tpu.gp import conditioned
    from vgpmp_tpu.ops import kernels as kops

    _, gb = tools
    inp = gb.inputs(5, "cpu")
    got = gb.gram_chol_f64(inp)
    assert got.dtype == torch.float64 and got.shape == (5, 7, 12, 12)
    j = _jax_inputs(inp)
    kfn = kops.KERNELS["matern52"][0]
    want = jax.vmap(lambda l_, v_: conditioned.cholesky_kuu(
        kfn, j["ny"], j["Z"][0], l_, v_, jitter=1e-9, solve_dtype=jnp.float64)[1])(j["ls"], j["s2"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_gram_piece1_float32_matches_jax_cholesky(tools):
    """The float32 piece (``gram_chol_f32``, jitter 1e-6) against the JAX
    tool's: both build and factor the Gram in float32 by the same unrolled
    column updates. Their products L Lᵀ agree to 1e-5 (float32 rounding of
    entries of order one); the factors' own entries to 2e-4, since the last
    pivots of a Gram whose condition reaches ~1e6 are ~1e-3 and amplify the
    two assemblies' last-bit differences by as much."""
    from vgpmp_tpu.gp import conditioned
    from vgpmp_tpu.ops import kernels as kops

    _, gb = tools
    inp = gb.inputs(5, "cpu")
    got = gb.gram_chol_f32(inp)
    assert got.dtype == torch.float32 and got.shape == (5, 7, 12, 12)
    j = _jax_inputs(inp)
    kfn = kops.KERNELS["matern52"][0]
    want = jax.vmap(lambda l_, v_: conditioned.cholesky_kuu(
        kfn, j["ny"], j["Z"][0], l_, v_, jitter=1e-6)[1])(j["ls"], j["s2"])
    assert want.dtype == jnp.float32 and np.isfinite(np.asarray(want)).all()
    want = np.asarray(want)
    np.testing.assert_allclose((got @ got.mT).numpy(), want @ np.swapaxes(want, -1, -2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


def test_gram_piece5_matches_jax_prior_kl(tools):
    from vgpmp_tpu.gp import kl

    _, gb = tools
    inp = gb.inputs(5, "cpu")
    chol = gb.gram_chol_f64(inp)
    got = gb.kl_leg(inp, chol)
    j = _jax_inputs(inp)
    C = gb.C

    def one(ch, qm, qs):
        Kuu = jnp.einsum("lij,lkj->lik", ch, ch)
        return kl.prior_kl(Kuu, ch, qm[C:].astype(jnp.float64), qs.astype(jnp.float64),
                           qm[:C].astype(jnp.float64))

    want = jax.vmap(one)(jnp.asarray(chol.numpy()), j["q_mu_full"], j["q_sqrt"])
    assert got.shape == (5,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)


def test_tools_raise_without_cuda(tools, monkeypatch):
    pb, gb = tools
    import profiler_drops_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.main(["--batch", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        gb.main(["--batch", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler_drops_torch.main([])
