"""Port parity: the parallel layer (``vgpmp_torch/parallel``).

Four rank processes join a gloo world on the CPU (``_torch_parallel_worker.py``,
a free port, a timeout on each) and run, at a tiny float64 size, a dp = 4
sharded solve from a generator and from JAX's per-row draws, the sharded
round solver inside ``solve_adaptive``, a dp = 2 x sp = 2 solve on JAX's
per-shard draws (``fold_in(key, k)``), the sample mean's gradient and the
best-sample selection. The test holds them to the unsharded port and to
JAX's sharded solver on conftest's 8-device mesh. Tolerances:
``tests/test_parallel.py``'s (best 1e-9, ELBO 1e-7) between the sharded and
the unsharded port, ``tests/test_torch_solver.py``'s (1e-6 relative plus
1e-8) between the port and JAX.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_support import jax_path_noise, planner_models
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_tpu.parallel import make_mesh as jax_make_mesh
from vgpmp_tpu.parallel import make_sharded_solver as jax_sharded_solver
from vgpmp_tpu.parallel import pad_problems as jax_pad_problems
from vgpmp_torch.convert import params_from_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.models import vgpmp as tm
from vgpmp_torch.parallel import make_mesh, pad_problems
from vgpmp_torch.parallel.mesh import rank_grid

HERE = Path(__file__).resolve().parent
WORLD, B, VALID, STEPS, M, S, NB, K = 4, 8, 5, 6, 4, 2, 32, 4
JCFG = js.TrainConfig(num_steps=STEPS, learning_rate=0.05, time_spacing_X=8, time_spacing_Xnew=10,
                      num_posterior_samples=K)
TCFG = ts.TrainConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(ts.TrainConfig)})
PLANNER_PARAMS = {"lengthscales": [1.5] * 7, "variance": 0.2, "sigma_obs": 0.005, "alpha": 100.0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _solve_noise_arrays(prefix, keys):
    """JAX's draws for a solve of rows ``keys`` (each row's key split into the
    steps' and the extraction's), flattened for ``np.savez``."""
    split = [jax.random.split(k, STEPS + 1) for k in keys]
    out = {}
    for i in range(STEPS + 1):
        name = f"step{i}" if i < STEPS else "post"
        pn = jax_path_noise([sk[i] for sk in split], 7, M + 2, S if i < STEPS else K, NB)
        out.update({f"{prefix}_{name}_{f}": getattr(pn, f).numpy() for f in pn._fields})
    return out


def _selection_cases(rng):
    """Winner scores [4 shards, rows, samples] that exercise the selection:
    a plain maximum, an exact tie across shards, a NaN on one shard, NaN on
    two, all -inf, a tie inside a shard, a NaN trajectory on a losing shard."""
    n_rows, n_s = 7, 3
    scores = rng.normal(size=(4, n_rows, n_s))
    scores[:, 1] = -2.5                        # tie everywhere: shard 0, sample 0
    scores[1, 2, 1] = np.nan                   # one NaN: shard 1
    scores[1, 3, 2] = scores[3, 3, 0] = np.nan  # NaN on shards 1 and 3: shard 1
    scores[:, 4] = -np.inf                     # all -inf: shard 0, sample 0
    scores[:, 5] = -3.0
    scores[2:, 5, 1:] = -1.0                   # tie inside shards 2 and 3 and across: shard 2, sample 1
    scores[:, 6] = [[-1.0, -2.0, -3.0], [-5.0, -6.0, -7.0], [-1.0, -9.0, -9.0], [-4.0, -4.0, -4.0]]
    samples = rng.normal(size=(4, n_rows, n_s, 5, 7))
    samples[1, 6] = np.nan                     # a losing shard's NaN trajectories
    samples[3, 6] = np.nan
    return scores, samples


def _jax_selection(scores, samples):
    """JAX's rule (``vgpmp_tpu/models/vgpmp.py:466-475``): each shard's argmax,
    then the argmax of the gathered winners' scores."""
    out = []
    for r in range(scores.shape[1]):
        local = [int(jnp.argmax(jnp.asarray(scores[k, r]))) for k in range(len(scores))]
        won = int(jnp.argmax(jnp.asarray([scores[k, r, i] for k, i in enumerate(local)])))
        out.append(samples[won, r, local[won]])
    return np.stack(out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Launch the gloo world, compute the references while it runs, and
    return everything the tests compare."""
    torch.sin(torch.zeros(64, dtype=torch.float64))  # the first float64 sin of the process
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    rng = np.random.default_rng(11)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals[:4] = starts[:4] + 0.05 * (goals[:4] - starts[:4])  # short moves, which execute
    mask = np.arange(B) < VALID
    args = ([1.5] * 7, 0.2, 0.005, 100.0)
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals),
                               jnp.asarray([0, 1, 2, 0, 1, 2, 0, 1]), jnp.asarray(0.5 * (starts + goals)),
                               *map(jnp.asarray, args))
    p0 = {k: np.asarray(getattr(jp0, k)) for k in tm.PlannerParams.names()}
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    sel_scores, sel_samples = _selection_cases(rng)
    spec = dict(starts=starts, goals=goals, mask=mask, probe_w=rng.normal(size=3),
                probe_x=rng.normal(size=(2, 6, 3)), sel_scores=sel_scores, sel_samples=sel_samples,
                **{f"p0_{k}": v for k, v in p0.items()}, **_solve_noise_arrays("dp", keys))
    for s in range(2):
        spec.update(_solve_noise_arrays(f"sp{s}", [jax.random.fold_in(k, s) for k in keys[:4]]))
    d = tmp_path_factory.mktemp("gloo_world")
    np.savez(d / "spec.npz", **spec)

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "_torch_parallel_worker.py"), str(d), str(r),
                               str(WORLD), str(port)], cwd=HERE.parent, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        ref = {}
        mesh4 = jax_make_mesh(1, devices=jax.devices()[:4])
        jres, jmet = jax_sharded_solver(jmodel, JCFG, mesh4)(jp0, jnp.asarray(starts), jnp.asarray(goals),
                                                               keys, jnp.asarray(mask))
        ref["jax_dp"] = (jax.tree.map(np.asarray, jres), jax.tree.map(np.asarray, jmet))
        mesh22 = jax_make_mesh(2, devices=jax.devices()[:4])
        jres, _ = jax_sharded_solver(jmodel, JCFG, mesh22)(
            jax.tree.map(lambda x: x[:4], jp0), jnp.asarray(starts[:4]), jnp.asarray(goals[:4]), keys[:4],
            jnp.ones(4, bool))
        ref["jax_sp"] = jax.tree.map(np.asarray, jres)
        ref["probe"] = _jax_probe(spec["probe_w"], spec["probe_x"])
        ref["sel2"] = _jax_selection(sel_scores[:2], sel_samples[:2])
        ref["sel4"] = _jax_selection(sel_scores, sel_samples)

        tp0 = params_from_numpy(p0)
        batch = ts.make_batch_solver(tmodel, TCFG)
        ref["port_gen"] = batch(tp0, starts, goals, torch.Generator().manual_seed(7))[1]
        injected = ts.SolveNoise(
            [_path(spec, f"dp_step{i}") for i in range(STEPS)], _path(spec, "dp_post"))
        ref["port_jax"] = batch(tp0, starts, goals, noise=injected)[1]
        ref["adaptive"] = ts.solve_adaptive(tmodel, TCFG, starts, goals, PLANNER_PARAMS,
                                            inits=("linear", "zeros", "rand0", "frand1"), max_rounds=4,
                                            seed=3, round_sizes=(8, 4))
        for r, p in enumerate(procs):
            stdout, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{stdout[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return spec, ref, ranks


def _path(spec, prefix):
    from vgpmp_torch.gp.pathwise import PathNoise

    return PathNoise(*(torch.as_tensor(spec[f"{prefix}_{f}"]) for f in PathNoise._fields))


def _jax_probe(w, xs):
    """JAX's gradient of ``pmean(mean(sin(x_k @ w)))`` on each of 2 shards
    under ``shard_map(check_vma=False)``, and the forward value."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))

    def local(w, x):
        loss = lambda w: jax.lax.pmean(jnp.mean(jnp.sin(x[0] @ w)), "sp")
        return loss(w)[None], jax.grad(loss)(w)[None]

    value, grad = jax.shard_map(local, mesh=mesh, in_specs=(P(), P("sp")), out_specs=(P("sp"), P("sp")),
                                check_vma=False)(jnp.asarray(w), jnp.asarray(xs))
    return np.asarray(value), np.asarray(grad)


def _rows(ranks, key, sp=1):
    """The whole ``[B]`` field every rank returned: the same on every rank."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_rank_layout_matches_jax_mesh(sp):
    """Rank r sits at (r // sp, r % sp), as JAX reshapes its 8 devices."""
    want = np.vectorize(lambda d: d.id)(np.asarray(jax_make_mesh(sp, devices=jax.devices()[:8]).devices))
    np.testing.assert_array_equal(rank_grid(8, sp), want)
    with pytest.raises(ValueError, match="not divisible by num_sample_shards=3"):
        rank_grid(8, 3)


def test_world_of_one_mesh():
    mesh = make_mesh(1, device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.sp_group is None and mesh.dp_group is None
    with pytest.raises(ValueError, match="1 devices not divisible by num_sample_shards=2"):
        make_mesh(2, device="cpu")


@pytest.mark.parametrize("n, multiple", [(5, 4), (8, 4), (1, 3), (36, 8)])
def test_pad_problems_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    s, g = rng.normal(size=(n, 7)), rng.normal(size=(n, 7))
    for got, want in zip(pad_problems(s, g, multiple), jax_pad_problems(s, g, multiple)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_gloo_world_mesh_coordinates(world):
    _, _, ranks = world
    for r, out in enumerate(ranks):
        # dp, sp, dp index, sp index, dp ranks, -1, sp ranks
        np.testing.assert_array_equal(out["mesh_dp4"], [4, 1, r, 0, 0, 1, 2, 3, -1, r])
        row, col = divmod(r, 2)
        np.testing.assert_array_equal(out["mesh_sp2"], [2, 2, row, col, col, 2 + col, -1, 2 * row, 2 * row + 1])


def test_dp_sharded_solve_matches_unsharded_port(world):
    """Each rank draws the whole batch from the shared generator and keeps its
    rows: the sharded solve is the unsharded one from the same seed."""
    _, ref, ranks = world
    np.testing.assert_allclose(_rows(ranks, "gen_best"), ref["port_gen"].best.numpy(), atol=1e-9)
    np.testing.assert_allclose(_rows(ranks, "gen_elbo_history"), ref["port_gen"].elbo_history.numpy(),
                               atol=1e-7)
    np.testing.assert_allclose(_rows(ranks, "jax_best"), ref["port_jax"].best.numpy(), atol=1e-9)
    np.testing.assert_allclose(_rows(ranks, "jax_elbo_history"), ref["port_jax"].elbo_history.numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("field", ["best", "mean", "elbo_history", "best_score", "failed", "ee_uncertainty"])
def test_dp_sharded_solve_matches_jax_sharded_solver(world, field):
    _, ref, ranks = world
    want = np.asarray(getattr(ref["jax_dp"][0], field))
    np.testing.assert_allclose(_rows(ranks, f"jax_{field}"), want.reshape(ranks[0][f"jax_{field}"].shape),
                               rtol=1e-6, atol=1e-8, err_msg=field)


def test_masked_rows_left_out_of_the_metrics(world):
    """Padded rows count in no metric; a diverged row counts in no clearance
    mean; the metrics are JAX's on the same draws."""
    _, ref, ranks = world
    for name in ("gen", "jax"):
        m = {k: _rows(ranks, f"{name}_metric_{k}") for k in
             ("success_rate", "num_problems", "num_failed", "mean_min_clearance", "success",
              "min_clearance", "failed")}
        valid = np.arange(B) < VALID
        ok = valid & ~m["failed"]
        assert m["num_problems"] == VALID
        assert m["success_rate"] == m["success"][valid].sum() / VALID
        assert m["num_failed"] == m["failed"][valid].sum()
        np.testing.assert_allclose(m["mean_min_clearance"], m["min_clearance"][ok].sum() / max(ok.sum(), 1),
                                   rtol=1e-12)
    jmet = ref["jax_dp"][1]
    for k in ("success_rate", "num_problems", "num_failed", "success", "failed"):
        np.testing.assert_array_equal(_rows(ranks, f"jax_metric_{k}"), jmet[k], err_msg=k)
    for k in ("mean_min_clearance", "min_clearance"):
        np.testing.assert_allclose(_rows(ranks, f"jax_metric_{k}"), jmet[k], rtol=1e-6, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("field", ["best", "elbo_history"])
def test_sp_sharded_solve_matches_jax(world, field):
    """dp = 2 x sp = 2 on JAX's draws of ``fold_in(key, k)`` per shard: the
    best trajectory is the row's on both of its shards and equals JAX's;
    each shard's ELBO history follows its own parameters, JAX's output is
    shard 0's."""
    _, ref, ranks = world
    got = _rows([ranks[0], ranks[2]], f"sp_{field}")  # the sp-0 ranks of both dp rows
    np.testing.assert_allclose(got, getattr(ref["jax_sp"], field).reshape(got.shape), rtol=1e-6, atol=1e-8)
    if field == "best":
        for a, b in ((0, 1), (2, 3)):
            np.testing.assert_array_equal(ranks[a]["sp_best"], ranks[b]["sp_best"])
            np.testing.assert_array_equal(ranks[a]["spgen_best"], ranks[b]["spgen_best"])
            assert np.isfinite(ranks[a]["spgen_best"]).all()
    else:
        assert not np.array_equal(ranks[0]["sp_elbo_history"], ranks[1]["sp_elbo_history"])


def test_sample_mean_is_bit_equal_on_the_shards(world):
    """Every step's averaged likelihood ``[B/dp, N]`` is one array on both
    ranks of a sample group."""
    _, _, ranks = world
    assert ranks[0]["sp_lik_means"].shape == (STEPS, 2, JCFG.time_spacing_X)
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a]["sp_lik_means"], ranks[b]["sp_lik_means"])


def test_sample_mean_gradient_is_jax_own_shard_gradient(world):
    """The collective's backward returns each shard the gradient of its own
    samples, as JAX's ``pmean`` under ``shard_map(check_vma=False)`` does, not
    the gradient of the mean (ROADMAP Queue 3)."""
    spec, ref, ranks = world
    value, grad = ref["probe"]
    own = np.stack([np.cos(x @ spec["probe_w"]) @ x / len(x) for x in spec["probe_x"]])
    np.testing.assert_allclose(grad, own, rtol=1e-12)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["probe_grad"], grad[r % 2], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(out["probe_value"], value[r % 2][None], rtol=1e-15)
    assert not np.allclose(ranks[0]["probe_grad"], own.mean(0))


@pytest.mark.parametrize("n", [2, 4])
def test_best_sample_selection_matches_jax(world, n):
    """NaN scores and ties pick what JAX's all-gather and ``jnp.argmax`` pick:
    the first NaN, the lowest shard on a tie, shard 0 when all are -inf; a
    losing shard's NaN trajectory does not leak into the winner's."""
    _, ref, ranks = world
    want = ref[f"sel{n}"]
    for out in ranks:
        np.testing.assert_array_equal(out[f"sel{n}"], want)
    assert np.isfinite(want[6]).all()


def test_sharded_round_solver_in_solve_adaptive(world):
    """The dp = 4 round solver inside ``solve_adaptive``: the bucket sizes
    round up to multiples of dp (3 -> 4), and the merge is the unsharded
    engine's with the rounded sizes."""
    _, ref, ranks = world
    best, reps, info = ref["adaptive"]
    got_info = json.loads(str(_rows(ranks, "adaptive_info")))
    sizes = got_info.pop("sizes")
    assert got_info == info
    assert all(c % 4 == 0 for c in sizes) and 4 in sizes, sizes
    np.testing.assert_allclose(_rows(ranks, "adaptive_best"), best, atol=1e-9)
    for k, v in reps._asdict().items():
        if v is None:
            continue
        if np.asarray(v).dtype == bool:
            np.testing.assert_array_equal(_rows(ranks, f"adaptive_rep_{k}"), v, err_msg=k)
        else:
            np.testing.assert_allclose(_rows(ranks, f"adaptive_rep_{k}"), v, atol=1e-9, err_msg=k)
