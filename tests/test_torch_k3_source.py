"""K3's source (``vgpmp_torch/csrc/k3_clearance.cuh``) on the CPU: the
composed instantiation (``primitives_min_near``: a primitive evaluated only
where its bounding sphere, or a box's thinnest slab, reaches below the
minimum so far), both entries, float32 and float64, held to the port's
plain versions and to JAX.

The header is compiled here by g++ against ``tests/k2_cpu/`` (a stub of what
the kernels take from CUDA: a block as 256 threads, a warp's ballot and
match through an exchange buffer, ``atomicAdd`` a host atomic) and called
through ``ctypes`` on CPU tensors. The inputs are made from a seed with
numpy. References: ``vgpmp_torch.likelihoods.collision.
min_clearance_eval_plain`` and ``vgpmp_torch.sim.probe_clearance_plain``;
JAX's ``vgpmp_tpu.likelihoods.collision.CollisionModel.
sphere_clearance_eval`` with its minimum over spheres, and the floor and
compare of ``vgpmp_tpu.engine.validator.execute_and_validate`` on JAX's
``vgpmp_tpu.sim.pd_path_configs``.

The scene: a smooth random base grid, ``_torch_support.scene_objects``' two
extra grids, sphere, two boxes and capsule; and the same scene with the
capsule of zero length, whose distance is NaN everywhere (0/0 in the
segment's parameter), as JAX's is. The configs: random tiles and a tail
tile (32 * 6 + 7), one NaN config; the probes (16 a segment): two perturbed
paths between random endpoints, a row without motion and a row that turns
NaN half way.

Tolerances: the clearance to 1e-5 m in float32 and 1e-9 m in float64; the
segment counts equal to the plain version's (a probe within the tolerance
of its floor may fall either way; the seed has none there), NaN where the
references' are.
"""

import ctypes
import shutil
import subprocess
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import scene_objects, smooth_grid
from vgpmp_tpu import robots as jrobots
from vgpmp_tpu import scene as jscene
from vgpmp_tpu import sim as jsim
from vgpmp_tpu.engine import validator as jval
from vgpmp_tpu.kinematics import dh as jdh
from vgpmp_tpu.likelihoods import collision as jcol
from vgpmp_tpu.sdf import grid as jg
from vgpmp_torch import robots as trobots
from vgpmp_torch import scene as tscene
from vgpmp_torch import sim as tsim
from vgpmp_torch.kinematics import dh as tdh
from vgpmp_torch.likelihoods import collision as tcol
from vgpmp_torch.sdf import grid as tg

CSRC = Path(__file__).resolve().parents[1] / "vgpmp_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "k2_cpu"
ORIGIN, DELTA, SHAPE, OFFSET = np.array([-1.25, -1.25, -0.625]), 0.0625, (40, 40, 36), [0.125, 0.0, -0.0625]
N, T_WP, RADIUS, SLACK = 32 * 6 + 7, 6, 0.5, 5e-3
SAMPLES = 16  # probes a segment of the PD path
TOL = {torch.float32: 1e-5, torch.float64: 1e-9}
DTYPES = [pytest.param(torch.float32, id="float32"), pytest.param(torch.float64, id="float64")]


@pytest.fixture(scope="module")
def k3cpu(tmp_path_factory):
    """The kernel's source built for the CPU (g++, C++20, threads)."""
    d = tmp_path_factory.mktemp("k3_cpu")
    launch = (CSRC / "launch.cuh").read_text()
    call = "kernel<<<grid, block, smem, st>>>(args...);"
    assert call in launch
    (d / "launch.cuh").write_text(launch.replace(call, "k2_cpu_launch(kernel, grid, block, smem, args...);"))
    for f in ("kernels.h", "fk.cuh", "scene.cuh", "k3_clearance.cuh"):
        shutil.copy(CSRC / f, d)
    so = d / "k3_cpu.so"
    cmd = ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{STUB}",
           str(STUB / "k3_cpu.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P, I64, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for f in (lib.k3_f32, lib.k3_f64):
        f.argtypes = [P] * 12 + [I64, I, I, I, I] + [P] * 9
    return lib


def k3_run(lib, model, q, probe=None, spheres=None):
    """The CPU build of K3 on ``q``, as ``collision.k3_min_clearance``
    (``q [n, L]``) or ``collision.k3_probe_clearance`` (``q [B, G, L]`` and
    ``probe``, its arguments after ``qs``) hand them to the card's: ``(out
    [n], seg_count [B, T] or None)``. ``spheres`` replaces the robot's
    sphere table ``[P, 5]``."""
    sc, fk = model.scene, model.fk
    spheres = fk.k1_spheres if spheres is None else spheres.contiguous()
    grid_f, grid_i, cells, prims, counts = model.tables.k3_args()
    dt = q.dtype
    L = q.shape[-1]
    qf = q.reshape(-1, L).contiguous()
    out = torch.empty(qf.shape[0], dtype=dt)
    keep = [torch.tensor([*model._base_offset_host, *model._grid_host], dtype=dt),
            torch.tensor(list(sc.base.shape), dtype=torch.int32),
            torch.tensor([grid_f.shape[0], *counts], dtype=torch.int32)]
    ptr = lambda t: None if t is None else t.data_ptr()
    rows, count, sizes, floor = [None] * 6, None, None, None
    if probe is not None:
        *rows, T, radius, slack = probe
        rows = [t.contiguous() for t in rows]
        count = torch.zeros(q.shape[0], T, dtype=torch.int32)
        sizes = torch.tensor([q.shape[1], T], dtype=torch.int64)
        # the division by the radius as the binding takes it
        floor = torch.stack([torch.tensor(1.0, dtype=dt) / torch.tensor(radius, dtype=dt),
                             torch.tensor(slack, dtype=dt)])
    run = lib.k3_f64 if dt == torch.float64 else lib.k3_f32
    rc = run(ptr(qf), ptr(fk.k1_robot), ptr(spheres), ptr(sc.base.data), ptr(keep[0]), ptr(keep[1]),
             ptr(grid_f), ptr(grid_i), ptr(cells), ptr(prims), ptr(keep[2]), ptr(out), qf.shape[0],
             spheres.shape[0], L, int(fk.craig), int(probe is not None), *map(ptr, rows), ptr(count),
             ptr(sizes), ptr(floor))
    assert rc == 0, f"k3: cudaError {rc}"
    return out, count


def _models(dt, zero_capsule=False):
    """The same composed franka collision model in both packages, in ``dt``."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    grids, offsets, prims = scene_objects()
    if zero_capsule:
        prims = dict(prims, capsule_b=prims["capsule_a"].copy())
    jt = jnp.float64 if dt == torch.float64 else jnp.float32
    jsc = jscene.Scene(base=jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jt), base_offset=jnp.asarray(OFFSET, jt),
                       mode="nearest",
                       extra_grids=tuple(jg.SdfGrid.from_arrays(d, o, dl, jt) for d, o, dl in grids),
                       extra_offsets=jnp.asarray(offsets, jt),
                       primitives=jscene.Primitives(**{k: jnp.asarray(v, jt) for k, v in prims.items()}))
    tsc = tscene.Scene(base=tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, dt),
                       base_offset=torch.as_tensor(OFFSET, dtype=dt), mode="nearest",
                       extra_grids=tuple(tg.SdfGrid.from_arrays(d, o, dl, dt) for d, o, dl in grids),
                       extra_offsets=torch.as_tensor(offsets, dtype=dt),
                       primitives=tscene.Primitives(**{k: torch.as_tensor(v, dtype=dt) for k, v in prims.items()}))
    jmod = jcol.CollisionModel(fk=jdh.FkModel.from_spec(jrobots.load_robot("franka"), np.eye(4), dtype=jt),
                               scene=jsc, epsilon=jnp.asarray(0.05, jt))
    tmod = tcol.CollisionModel(fk=tdh.FkModel.from_spec(trobots.load_robot("franka"), np.eye(4), dtype=dt),
                               scene=tsc, epsilon=0.05)
    return jmod, tmod


@pytest.fixture(scope="module")
def inputs():
    """``(q [N, 7], traj [4, T_WP, 7], starts, goals)`` in float64 numpy:
    random configs with config 5 NaN; two perturbed paths between random
    endpoints, a row without motion and a row that turns NaN half way."""
    spec = trobots.load_robot("franka")
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    rng = np.random.default_rng(31)
    q = rng.uniform(lo, hi, size=(N, spec.dof))
    q[5, 2] = np.nan
    ends = rng.uniform(lo, hi, size=(2, 2, spec.dof))
    w = np.linspace(0, 1, T_WP)[None, :, None]
    paths = ends[:, :1] + (ends[:, 1:] - ends[:, :1]) * w + 0.2 * np.sin(np.pi * w) * rng.normal(
        size=(2, 1, spec.dof))
    paths = np.clip(paths, lo, hi)
    still = np.repeat(paths[:1, :1], T_WP, axis=1)
    nan_row = paths[1:].copy()
    nan_row[0, T_WP // 2:] = np.nan
    traj = np.concatenate([paths, still, nan_row])
    starts = np.concatenate([ends[:, 0], still[:, 0], ends[1:, 0]])
    goals = np.concatenate([ends[:, 1], still[:, -1], ends[1:, 1]])
    return q, traj, starts, goals


def _jax_min_clearance(jmod, q):
    return np.asarray(jnp.min(jmod.sphere_clearance_eval(jnp.asarray(q)), axis=-1))


@pytest.mark.parametrize("dt", DTYPES)
def test_k3_source_min_clearance_matches_plain_and_jax(k3cpu, inputs, dt):
    """``k3_min_clearance``'s composed instantiation against
    ``min_clearance_eval_plain`` and JAX's minimum of
    ``sphere_clearance_eval``: random tiles and a tail tile, NaN for the NaN
    config; on the scene with a zero-length capsule NaN everywhere, as in
    both references."""
    q = torch.as_tensor(inputs[0], dtype=dt)
    jmod, tmod = _models(dt)
    got, _ = k3_run(k3cpu, tmod, q)
    want = tcol.min_clearance_eval_plain(tmod, q)
    jwant = torch.from_numpy(_jax_min_clearance(jmod, q.numpy()).copy())
    nan = torch.isnan(want)
    assert nan.tolist() == [i == 5 for i in range(N)]
    assert torch.equal(torch.isnan(got), nan) and torch.equal(torch.isnan(jwant), nan)
    with torch.no_grad():  # the source that attains each config's minimum
        names, ds = zip(*tmod.scene.sources(tdh.sphere_positions(tmod.fk, q[~nan]), mode_override="trilinear"))
        d = torch.stack(ds) - tmod.fk.sphere_radii
        win = d.argmin(0).gather(-1, d.amin(0).argmin(-1, keepdim=True)).squeeze(-1)
    assert len(names) == 6 and torch.bincount(win, minlength=6).min() > 0, "a source never attains the minimum"
    for ref, who in ((want, "the plain version"), (jwant, "JAX")):
        err = (got[~nan] - ref[~nan]).abs().max().item()
        assert err <= TOL[dt], f"K3 against {who}: {err:.3e} m"

    jz, tz = _models(dt, zero_capsule=True)
    got_z, _ = k3_run(k3cpu, tz, q)
    assert torch.isnan(got_z).all() and torch.isnan(tcol.min_clearance_eval_plain(tz, q)).all()
    assert np.isnan(_jax_min_clearance(jz, q.numpy())).all()


def _probe_inputs(tmod, traj, starts, goals, dt):
    """The fused entry's inputs as ``sim.execute_and_validate`` makes them."""
    tr = torch.as_tensor(traj, dtype=dt)
    qs, visited, seg_idx, *_ = tsim.pd_path_configs(tr, samples_per_segment=SAMPLES)
    q_s, q_g = (torch.as_tensor(x, dtype=dt) for x in (starts, goals))
    plain = partial(tcol.min_clearance_eval_plain, tmod)
    depth_s, depth_g = torch.clamp(-plain(torch.cat([q_s, q_g])), min=0.0).split(len(tr))
    return qs, (q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T_WP, RADIUS, SLACK), visited, seg_idx


def _jax_flags(jmod, traj, starts, goals):
    """JAX's violated segments of every row: ``execute_and_validate``'s floor
    and compare on JAX's PD path, and its ``collision_free``; the rows in one
    jitted ``vmap``, so that JAX compiles them once."""
    def row(tr, s, g):
        qs, visited, seg_idx, *_ = jsim.pd_path_configs(tr, samples_per_segment=SAMPLES)
        min_clear = lambda q: jnp.min(jmod.sphere_clearance_eval(q), axis=-1)
        clear = min_clear(qs)
        depth_s, depth_g = jnp.maximum(0.0, -min_clear(s)), jnp.maximum(0.0, -min_clear(g))
        ramp = lambda d: jnp.maximum(0.0, 1.0 - d / RADIUS)
        allowed = jnp.maximum(depth_s * ramp(jnp.max(jnp.abs(qs - s), axis=-1)),
                              depth_g * ramp(jnp.max(jnp.abs(qs - g), axis=-1)))
        violated = visited & (clear < -allowed - SLACK)
        blocked = jnp.zeros((tr.shape[0],), bool).at[seg_idx].max(violated)
        lim = jnp.full(tr.shape[-1], 10.0, tr.dtype)
        rep = jval.execute_and_validate(jmod, tr, s, g, -lim, lim, contact_slack=SLACK, taper_radius=RADIUS,
                                        samples_per_segment=SAMPLES)
        return blocked, rep.collision_free, clear

    rows = jax.jit(jax.vmap(row))(*(jnp.asarray(x) for x in (traj, starts, goals)))
    return tuple(np.asarray(x) for x in rows)


@pytest.mark.parametrize("dt", DTYPES)
def test_k3_source_probe_clearance_matches_plain_and_jax(k3cpu, inputs, dt):
    """``k3_probe_clearance``'s composed instantiation against
    ``probe_clearance_plain`` (the clearance, and the segment counts equal)
    and against JAX's floor and compare (each row's violated segments, and
    ``execute_and_validate``'s ``collision_free``), on the two paths, the
    row without motion (never counted) and the NaN row (NaN probes, never
    violated)."""
    _, traj, starts, goals = inputs
    jmod, tmod = _models(dt)
    qs, args, visited, seg_idx = _probe_inputs(tmod, traj, starts, goals, dt)
    clear, count = k3_run(k3cpu, tmod, qs, args)
    clear = clear.reshape(qs.shape[:2])
    clear_p, count_p = tsim.probe_clearance_plain(partial(tcol.min_clearance_eval_plain, tmod), qs, *args)
    nan = torch.isnan(clear_p)
    assert torch.equal(torch.isnan(clear), nan) and nan[3].any() and not nan[:3].any()
    err = (clear[~nan] - clear_p[~nan]).abs().max().item()
    assert err <= TOL[dt], f"K3 probe entry against the plain version: {err:.3e} m"
    floor = tsim._floor_from_depths(qs, *args[:4], RADIUS, SLACK)
    near = visited & ((clear_p - floor).abs() <= TOL[dt])
    assert not near.any(), "a probe lies within the tolerance of its floor: the counts may differ"
    assert torch.equal(count, count_p) and count_p[:2].sum() > 0 and count[2].sum() == 0
    blocked, free, jclear = _jax_flags(jmod, traj, starts, goals)
    ok = ~(np.isnan(jclear) | np.isnan(clear.numpy()))  # JAX's NaN row is NaN from its start
    assert ok.any(-1).tolist() == [True, True, True, False]
    assert np.abs(clear.numpy()[ok] - jclear[ok]).max() <= TOL[dt]
    np.testing.assert_array_equal(count.numpy() > 0, blocked)
    np.testing.assert_array_equal(free, count.sum(-1).numpy() == 0)

    _, tz = _models(dt, zero_capsule=True)
    clear_z, count_z = k3_run(k3cpu, tz, qs, args)
    assert torch.isnan(clear_z).all() and count_z.sum() == 0


@pytest.mark.parametrize("dt", DTYPES)
def test_k3_source_skips_no_primitive_that_attains_the_minimum(k3cpu, inputs, dt):
    """The primitives' bounds skip only what cannot attain the minimum: on a
    base grid of constant distance 0.3 m with a thin wide box (a table top,
    0.04 m thick), a small sphere and a capsule, many sphere centres lie just
    above or below the table, where the box attains the minimum within a few
    centimetres of the grid's 0.3 m (a test of its slab that skipped them
    would be off by as much). The kernel runs on one sphere of the robot at a
    time, so that each sphere's clearance is held to the plain version's, not
    only the minimum over the spheres."""
    data = np.full(SHAPE, 0.3, np.float32)
    prims = dict(sphere_centers=np.array([[0.3, 0.3, 0.8]]), sphere_radii=np.array([0.05]),
                 box_centers=np.array([[0.5, 0.0, 0.3]]), box_rotations=np.eye(3)[None],
                 box_half_extents=np.array([[0.6, 0.5, 0.02]]),
                 capsule_a=np.array([[0.3, -0.3, 0.7]]), capsule_b=np.array([[0.3, -0.3, 0.9]]),
                 capsule_radii=np.array([0.04]))
    sc = tscene.Scene(base=tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, dt),
                      base_offset=torch.as_tensor(OFFSET, dtype=dt), mode="nearest",
                      primitives=tscene.Primitives(**{k: torch.as_tensor(v, dtype=dt) for k, v in prims.items()}))
    tmod = tcol.CollisionModel(fk=tdh.FkModel.from_spec(trobots.load_robot("franka"), np.eye(4), dtype=dt),
                               scene=sc, epsilon=0.05)
    q = torch.as_tensor(inputs[0][:32 * 2 + 7], dtype=dt)
    q[5] = q[6]
    table = tmod.fk.k1_spheres
    got = torch.stack([k3_run(k3cpu, tmod, q, spheres=table[p:p + 1])[0] for p in range(table.shape[0])], -1)
    want = tmod.sphere_clearance_eval(q)
    with torch.no_grad():
        pos = tdh.sphere_positions(tmod.fk, q)
        box = dict(tmod.scene.sources(pos, mode_override="trilinear"))["boxes"]
    band = ((box > 0.25) & (box < 0.3)).float().mean().item()
    assert band > 0.02, f"too few sphere centres where the box barely attains the minimum ({band:.3f})"
    torch.testing.assert_close(got, want, rtol=0, atol=TOL[dt])


def test_k3_bound_counts_the_primitives_the_culled_kernel_evaluates(inputs):
    """``chip_smoke.py:k3_primitive_work``, the primitive work that K3's
    bound counts: its minimum over the grids and the primitives it evaluates
    is the composed minimum at every sphere centre (it skips none that
    attains it), it tests every primitive at every centre, a box's slab only
    where its bounding sphere passes, and it evaluates fewer than it tests."""
    import chip_smoke

    dt = torch.float64
    _, tmod = _models(dt)
    q = torch.as_tensor(inputs[0], dtype=dt)
    q = q[~torch.isnan(q).any(-1)]
    with torch.no_grad():
        pos = tdh.sphere_positions(tmod.fk, q)
        tests, slabs, evals, d = chip_smoke.k3_primitive_work(torch, tmod, pos)
        want = tmod.scene.distance(pos, mode_override="trilinear")
    Ks, Kb, Kc = tmod.tables.counts
    n = pos.shape[0] * pos.shape[1]
    assert tests == n * (Ks + Kb + Kc) and evals[1] <= slabs <= n * Kb
    assert 0 < sum(evals) < tests and all(0 < e for e in evals)
    torch.testing.assert_close(d, want, rtol=0, atol=1e-12)
