"""Port parity: the resumable (chunked) solver and its checkpoints
(``make_resumable_solver``, ``TrainState``, ``utils/checkpoint.py``).

The batch solver is the resumable solver's three functions with one chunk, so
chunks of one run must give the one-shot run bit for bit on the CPU, with a
checkpoint written and read between chunks, whether the draws are injected or
come from a generator (whose state the checkpoint carries). Against JAX's
``make_resumable_solver`` (float64, the port on JAX's draws, ``lr_peak`` and
``sigma_anneal`` set as in ``tests/test_replan.py``) the tolerance is the
batch solver's, 1e-6 relative plus 1e-8 of the field's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise, planner_models
from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.models import vgpmp as tm
from vgpmp_torch.utils import checkpoint as ck

B, S, M, NB, STEPS, K = 3, 3, 4, 64, 10, 6
LEAVES = tm.PlannerParams.names()


@pytest.fixture(scope="module")
def setup():
    jspec, jmodel, tmodel = planner_models(num_samples=S, num_bases=NB, num_inducing=M, jitter=1e-9)
    jcfg = js.TrainConfig(num_steps=STEPS, learning_rate=0.05, lr_peak=0.1, warmup_steps=3,
                          sigma_anneal=5.0, time_spacing_X=8, time_spacing_Xnew=10,
                          num_posterior_samples=K)
    tcfg = ts.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ts.TrainConfig)})
    rng = np.random.default_rng(1)
    lo, hi = jspec.limits_low, jspec.limits_high
    starts = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    goals = 0.5 * (lo + hi) + 0.3 * (hi - lo) * rng.uniform(-1, 1, (B, 7))
    args = ([1.5] * 7, 0.2, 0.005, 100.0)
    jp0 = jm.init_params_batch(jmodel, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray([0, 1, 2]),
                               jnp.asarray(0.5 * (starts + goals)), *map(jnp.asarray, args))
    tp0 = params_from_numpy({k: np.asarray(getattr(jp0, k)) for k in LEAVES})
    return jmodel, tmodel, jcfg, tcfg, jp0, tp0, starts, goals


def _noise(keys_steps, keys_post):
    return ts.SolveNoise(
        steps=[jax_path_noise(ks, 7, M + 2, S, NB) for ks in keys_steps],
        posterior=jax_path_noise(keys_post, 7, M + 2, K, NB))


def _chunked(solver, p0, starts, goals, chunks, tmp_path, generator=None, noise=None):
    """``solver``'s run as ``chunks`` step counts, with the state (and the
    generator's) written and read back between chunks."""
    init_state, train_chunk, extract = solver
    state = init_state(p0, generator, noise)
    hist, done = [], 0
    for i, n in enumerate(chunks):
        part = None if noise is None else noise._replace(steps=noise.steps[done:done + n])
        state, h, _ = train_chunk(state, starts, goals, generator, part, n=n)
        hist.append(h)
        done += n
        path = tmp_path / f"chunk{i}.pt"
        ck.save_train_state(path, state, generator)
        if generator is not None:
            generator = torch.Generator().manual_seed(12345)  # overwritten by the restore
        state = ck.restore_train_state(path, device="cpu", generator=generator)
    hist = torch.cat(hist, dim=1)
    return state, hist, extract(state, starts, goals, generator, noise, hist)


@pytest.mark.parametrize("draws", ["injected", "generator"])
def test_chunked_run_equals_one_shot_bit_for_bit(setup, tmp_path, draws):
    """4 + 3 + 3 steps with a checkpoint between chunks against one chunk of
    10; on the generator's draws with per-row training grids and a trainable
    σ_obs and alpha, whose grid and anchors ride in the state."""
    _, tmodel, _, tcfg, _, tp0, starts, goals = setup
    trainable = None
    if draws == "generator":
        tcfg = dataclasses.replace(tcfg, randomize_timesteps=True)
        trainable = dict(ts.default_trainable(), sigma_obs_u=True, alpha_u=True)
    solver = ts.make_resumable_solver(tmodel, tcfg, trainable)
    kw = {}
    if draws == "injected":
        keys = jax.random.split(jax.random.PRNGKey(7), (STEPS + 1) * B).reshape(STEPS + 1, B, 2)
        kw["noise"] = _noise(keys[:-1], keys[-1])
    gen = lambda: torch.Generator().manual_seed(3) if draws == "generator" else None
    init_state, train_chunk, extract = solver
    g = gen()
    one = init_state(tp0, g, kw.get("noise"))
    one, hist_one, _ = train_chunk(one, starts, goals, g, kw.get("noise"), n=STEPS)
    res_one = extract(one, starts, goals, g, kw.get("noise"), hist_one)
    st, hist, res = _chunked(solver, tp0, starts, goals, (4, 3, 3), tmp_path, gen(), kw.get("noise"))
    assert st.step == one.step == STEPS
    assert torch.equal(hist, hist_one) and torch.isfinite(hist).all()
    for k in LEAVES:
        for a, b in ((st.params, one.params), (st.mu, one.mu), (st.nu, one.nu)):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(st.count, one.count) and torch.equal(st.X_train, one.X_train)
    for f in ("best", "mean", "best_score", "failed", "ee_uncertainty"):
        assert torch.equal(getattr(res, f), getattr(res_one, f)), f
    if draws == "generator":
        assert st.X_train.shape == (B, tcfg.time_spacing_X) and st.anchors is not None
        for a, b in zip(st.anchors, one.anchors):
            assert torch.equal(a, b)


def test_chunked_solver_equals_make_batch_solver(setup):
    """make_batch_solver is init_state, one chunk and extract: its result on
    a generator seed equals a two-chunk run's on the same seed."""
    _, tmodel, _, tcfg, _, tp0, starts, goals = setup
    params, res = ts.make_batch_solver(tmodel, tcfg)(tp0, starts, goals, torch.Generator().manual_seed(9))
    init_state, train_chunk, extract = ts.make_resumable_solver(tmodel, tcfg)
    gen = torch.Generator().manual_seed(9)
    st = init_state(tp0, gen)
    st, h1, _ = train_chunk(st, starts, goals, gen, n=6)
    st, h2, _ = train_chunk(st, starts, goals, gen, n=STEPS - 6)
    hist = torch.cat([h1, h2], dim=1)
    got = extract(st, starts, goals, gen, elbo_history=hist)
    assert torch.equal(hist, res.elbo_history)
    for k in LEAVES:
        assert torch.equal(getattr(st.params, k), getattr(params, k)), k
    for f in ("best", "mean", "best_score", "failed", "ee_uncertainty"):
        assert torch.equal(getattr(got, f), getattr(res, f)), f
    with pytest.raises(ValueError, match="pass n"):
        train_chunk(st, starts, goals, gen)


@pytest.mark.parametrize("chunks", [(10,), (5, 5)])
def test_resumable_solver_matches_jax(setup, chunks):
    """Against JAX's make_resumable_solver on its own per-step keys, one
    problem a row; chunked on both sides the same way."""
    jmodel, tmodel, jcfg, tcfg, jp0, tp0, starts, goals = setup
    j_init, j_train, j_extract = js.make_resumable_solver(jmodel, jcfg)
    j_train = jax.jit(j_train)
    step_keys = [jax.random.split(jax.random.PRNGKey(20 + b), STEPS) for b in range(B)]
    extract_keys = [jax.random.PRNGKey(40 + b) for b in range(B)]
    jhist, jbest, jparams = [], [], []
    for b in range(B):
        st = j_init(jax.tree.map(lambda x: x[b], jp0))
        hs, done = [], 0
        for n in chunks:
            st, h = j_train(st, jnp.asarray(starts[b]), jnp.asarray(goals[b]), step_keys[b][done:done + n])
            hs.append(np.asarray(h))
            done += n
        jhist.append(np.concatenate(hs))
        jbest.append(np.asarray(j_extract(st, jnp.asarray(starts[b]), jnp.asarray(goals[b]),
                                          extract_keys[b]).best))
        jparams.append({k: np.asarray(getattr(st.params, k)) for k in LEAVES})
    noise = _noise([[sk[i] for sk in step_keys] for i in range(STEPS)], extract_keys)
    init_state, train_chunk, extract = ts.make_resumable_solver(tmodel, tcfg)
    st = init_state(tp0)
    hs, done = [], 0
    for n in chunks:
        st, h, _ = train_chunk(st, starts, goals, noise=noise._replace(steps=noise.steps[done:done + n]))
        hs.append(h)
        done += n
    res = extract(st, starts, goals, noise=noise)
    close = lambda got, want: np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-8 * max(np.abs(want).max(), 1.0))
    close(torch.cat(hs, dim=1).numpy(), np.stack(jhist))
    close(res.best.numpy(), np.stack(jbest))
    got = params_to_numpy(st.params)
    for k in LEAVES:
        close(got[k], np.stack([p[k] for p in jparams]))
    assert res.elbo_history.shape == (B, 0) and not res.failed.any()


def test_solver_state_round_trip_from_port_and_from_jax(setup, tmp_path):
    """A port PlannerParams, and JAX's params as numpy, written with problem
    ids and extras and read back onto the CPU, unchanged."""
    _, _, _, _, jp0, tp0, _, _ = setup
    ids = np.array([3, 7, 11])
    ck.save_solver_state(tmp_path / "port.pt", tp0, ids, extras={"note": "r1", "round": 2})
    params, rids, extras = ck.restore_solver_state(tmp_path / "port.pt", device="cpu")
    np.testing.assert_array_equal(rids, ids)
    assert extras == {"note": "r1", "round": 2}
    for k in LEAVES:
        assert torch.equal(getattr(params, k), getattr(tp0, k)), k
    jax_numpy = {k: np.asarray(getattr(jp0, k)) for k in LEAVES}
    ck.save_solver_state(tmp_path / "jax.pt", jax_numpy, ids)
    params, _, extras = ck.restore_solver_state(tmp_path / "jax.pt", device="cpu")
    assert extras == {}
    for k in LEAVES:
        got = getattr(params, k)
        assert got.device.type == "cpu" and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), jax_numpy[k])
    with pytest.raises(ValueError, match="train_state"):
        ck.restore_train_state(tmp_path / "jax.pt", device="cpu")


def test_restore_places_tensors_and_defaults_to_cuda(setup, tmp_path, monkeypatch):
    """``device="cpu"`` puts every tensor on the CPU; the default device is the
    CUDA device, which raises where there is none; a generator is restored
    only from a checkpoint that holds its state."""
    _, tmodel, _, tcfg, _, tp0, _, _ = setup
    state = ts.make_resumable_solver(tmodel, tcfg)[0](tp0)
    ck.save_train_state(tmp_path / "s.pt", state)
    back = ck.restore_train_state(tmp_path / "s.pt", device="cpu")
    assert back.step == 0 and back.anchors is None and torch.equal(back.X_train, state.X_train)
    assert all(t.device.type == "cpu" for t in (*back.params.leaves().values(), back.count))
    with pytest.raises(ValueError, match="no generator state"):
        ck.restore_train_state(tmp_path / "s.pt", device="cpu", generator=torch.Generator())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore_train_state(tmp_path / "s.pt")
