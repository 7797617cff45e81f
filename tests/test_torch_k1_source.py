"""K1's source (``vgpmp_torch/csrc/k1_collision.cuh``) on the CPU: the
split design of the composed packed lookup and of the nearest-cell lookup
(base grid alone and composed), and the packed lookup in float64 (base grid
alone, its phase 1 spread over the block and its cell found by
``scene.cuh:div_by``, and composed), held to the port's plain version and to
JAX.

The header is compiled here by g++ against ``tests/k2_cpu/`` (a stub of what
the kernels take from CUDA: a block as 256 threads, ``__ldg`` a plain load)
and called through ``ctypes`` on CPU tensors, float32 and float64. The
inputs are made from a seed with numpy and go through the kernel, through
``vgpmp_torch.likelihoods.collision.log_prob_plain`` with autograd, and
through ``vgpmp_tpu.likelihoods.collision.CollisionModel.log_prob`` with
``jax.grad`` (``vgpmp_tpu.scene.Scene.distance``; nearest mode through
``vgpmp_tpu.sdf.grid.nearest_distance``), all in the kernel's dtype.

The scene: a smooth random base grid, one extra grid (or two, where the
split design gathers the second one grid at a time), a sphere, a box and a
capsule (``_torch_support.scene_objects``' kinds), the box centred on a
sphere centre of one config, so that its d/dq is NaN on every side. The
configs: a tile of 32 with no hinge-active pair, random tiles, a tail tile
(T = 32 * 40 + 13), three σ rows; and the same configs with ε = 5 m, where
every pair is hinge-active.

Tolerances (float32): values 1e-5 relative + 1e-3 absolute (sums of 37
float32 terms in another order); d/dq 1e-3 of the largest; the share of
configs that differ (a sphere centre within a rounding of a cell face lands
in the neighbouring cell on one side) at most 1e-3; the NaN pattern of d/dq
equal. The σ-gradient forward's lik and d/dq equal the frozen forward's bit
for bit, and its h² is the plain hinge squared (1e-4 relative + 1e-7).
Float64: values 1e-12 relative + 1e-12 of the largest |lik| (the packed
words' values are exact; a primitive's moves with the sphere centre by an
ulp, and a barely active pair's h² then by more than 1e-12 of itself); d/dq
1e-10 of the largest; h² 1e-12 relative. The cell of the float64 lookup is
the one JAX's division picks at points within an ulp of a voxel face.
"""

import ctypes
import re
import shutil
import subprocess
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import scene_objects, smooth_grid
from vgpmp_tpu import robots as jrobots
from vgpmp_tpu import scene as jscene
from vgpmp_tpu.kinematics import dh as jdh
from vgpmp_tpu.likelihoods import collision as jcol
from vgpmp_tpu.sdf import grid as jg
from vgpmp_torch import robots as trobots
from vgpmp_torch import scene as tscene
from vgpmp_torch.kinematics import dh as tdh
from vgpmp_torch.likelihoods import collision as tcol
from vgpmp_torch.sdf import grid as tg

CSRC = Path(__file__).resolve().parents[1] / "vgpmp_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "k2_cpu"
ORIGIN, DELTA, SHAPE, OFFSET = np.array([-1.25, -1.25, -0.625]), 0.0625, (40, 40, 36), [0.125, 0.0, -0.0625]
T, R = 32 * 40 + 13, 3
T64 = 32 * 12 + 9  # the float64 cases' configs (a tail tile; config 40 and tile 0 among them)
RTOL, ATOL, GTOL, SHARE = 1e-5, 1e-3, 1e-3, 1e-3
RTOL64, GTOL64 = 1e-12, 1e-10
F32 = dict(dtype=torch.float32)


def _cpu_source(text):
    """``k1_collision.cuh`` for the stub: ``k1_dsigma``'s ``<<<>>>`` dropped
    (compiled, never run here)."""
    return re.sub(r"<<<[^>]*>>>", "", text)


@pytest.fixture(scope="module")
def k1cpu(tmp_path_factory):
    """The kernel's source built for the CPU (g++, C++20, threads)."""
    d = tmp_path_factory.mktemp("k1_cpu")
    (d / "k1_collision.cuh").write_text(_cpu_source((CSRC / "k1_collision.cuh").read_text()))
    launch = (CSRC / "launch.cuh").read_text()
    call = "kernel<<<grid, block, smem, st>>>(args...);"
    assert call in launch
    (d / "launch.cuh").write_text(launch.replace(call, "k2_cpu_launch(kernel, grid, block, smem, args...);"))
    for f in ("kernels.h", "fk.cuh", "scene.cuh"):
        shutil.copy(CSRC / f, d)
    so = d / "k1_cpu.so"
    cmd = ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{STUB}",
           str(STUB / "k1_cpu.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P, I64, I, F, D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.k1_f32.argtypes = [I] + [P] * 15 + [I64, I64, I, I, I, I, F]
    lib.k1_f64.argtypes = [I] + [P] * 15 + [I64, I64, I, I, I, I, D]
    lib.k1_split_design.argtypes = [I, I, I]
    lib.k1_nearest_cells_f64.argtypes = [P, I64, P, P, P]
    return lib


def k1_run(lib, model, q, sigma, grad, h2=False):
    """The CPU build of K1 on ``q [T, dof]``, ``sigma [R, P]`` (float32 or
    float64, the model's dtype), as ``collision.k1_loglik`` hands them to
    the card's: ``(lik, d/dq or None, h² or None)``."""
    sc, fk = model.scene, model.fk
    packed = sc.mode == "packed"
    table = sc.base_packed.words if packed else sc.base.data.contiguous()
    grid_f, grid_i, cells, prims, counts = model.tables.k1_args(packed)
    Tn, dof = q.shape
    P = sigma.shape[1]
    dt = dict(dtype=q.dtype)
    lik = torch.empty(Tn, **dt)
    dlik = torch.empty(Tn, dof, **dt) if grad else None
    sq = torch.empty(P, Tn, **dt) if h2 else None
    keep = [torch.tensor([*model._base_offset_host, *model._grid_host], **dt),
            torch.tensor(list(sc.base.shape), dtype=torch.int32),
            torch.tensor([grid_f.shape[0], *counts], dtype=torch.int32)]
    ptr = lambda t: None if t is None else t.data_ptr()
    run = lib.k1_f64 if q.dtype == torch.float64 else lib.k1_f32
    rc = run(tcol.K1_MODES[sc.mode], ptr(q), ptr(sigma), ptr(fk.k1_robot), ptr(fk.k1_spheres),
                    ptr(table), ptr(keep[0]), ptr(keep[1]), ptr(grid_f), ptr(grid_i), ptr(cells),
                    ptr(prims), ptr(keep[2]), ptr(lik), ptr(dlik), ptr(sq), Tn, Tn // sigma.shape[0], P,
                    dof, int(fk.craig), int(grad), model.epsilon)
    assert rc == 0, f"k1: cudaError {rc}"
    return lik, dlik, sq


def _numpy_scene(extra_grids, box_at):
    """The scene in numpy: the base grid and ``extra_grids`` of
    ``scene_objects``' grids, its sphere and capsule, and one box centred at
    ``box_at``."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    grids, offsets, prims = scene_objects()
    prims = dict(sphere_centers=prims["sphere_centers"], sphere_radii=prims["sphere_radii"],
                 box_centers=np.asarray(box_at if extra_grids else np.zeros(3))[None], box_rotations=prims["box_rotations"][1:],
                 box_half_extents=np.array([[0.06, 0.05, 0.07]]),
                 capsule_a=prims["capsule_a"], capsule_b=prims["capsule_b"],
                 capsule_radii=prims["capsule_radii"])
    return data, grids[:extra_grids], offsets[:extra_grids], prims


def _models(mode, extra_grids, box_at, eps, f64=False):
    """The same franka collision model in both packages, float32 (or float64
    with ``f64``); ``mode`` ``packed`` or ``nearest``; ``extra_grids`` 0 for
    the base grid alone."""
    data, grids, offsets, prims = _numpy_scene(extra_grids, box_at)
    jt, tt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    jkw, tkw = {}, {}
    if extra_grids:
        jkw = dict(extra_grids=tuple(jg.SdfGrid.from_arrays(d, o, dl, jt) for d, o, dl in grids),
                   extra_offsets=jnp.asarray(offsets, jt),
                   primitives=jscene.Primitives(**{k: jnp.asarray(v, jt) for k, v in prims.items()}))
        tkw = dict(extra_grids=tuple(tg.SdfGrid.from_arrays(d, o, dl, tt) for d, o, dl in grids),
                   extra_offsets=torch.as_tensor(offsets, dtype=tt),
                   primitives=tscene.Primitives(**{k: torch.as_tensor(v, dtype=tt) for k, v in prims.items()}))
    jsc = jscene.Scene(base=jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jt),
                       base_offset=jnp.asarray(OFFSET, jt), mode="nearest", **jkw)
    tsc = tscene.Scene(base=tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, tt),
                       base_offset=torch.as_tensor(OFFSET, dtype=tt), mode="nearest", **tkw)
    if mode == "packed":
        jsc, tsc = jsc.packed(), tsc.packed()
    spec = jrobots.load_robot("franka")
    jmod = jcol.CollisionModel(fk=jdh.FkModel.from_spec(spec, np.eye(4), dtype=jt), scene=jsc,
                               epsilon=jnp.asarray(eps, jt))
    tmod = tcol.CollisionModel(fk=tdh.FkModel.from_spec(trobots.load_robot("franka"), np.eye(4),
                                                        dtype=tt), scene=tsc, epsilon=eps)
    return spec, jmod, tmod


@pytest.fixture(scope="module")
def inputs():
    """``(q [T, 7], sigma [R, 37], box_at)``: random configs, T not a
    multiple of 32; config 40's sphere 20 centre is where the box goes; tile
    0 then takes 32 configs that are 2 cm clear of the base grid (so that no
    pair of that tile is hinge-active on the base grid alone, in either
    mode)."""
    spec = trobots.load_robot("franka")
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    rng = np.random.default_rng(23)
    q = rng.uniform(lo, hi, size=(T, spec.dof)).astype(np.float32)
    sigma = rng.uniform(0.003, 0.008, size=(R, spec.num_spheres)).astype(np.float32)
    pool = rng.uniform(lo, hi, size=(6000, spec.dof)).astype(np.float32)
    _, _, probe = _models("nearest", 0, None, 0.07)
    with torch.no_grad():
        box_at = tdh.sphere_positions(probe.fk, torch.as_tensor(q[40]))[20].numpy().astype(np.float64)
        free = (probe.hinge_cost(torch.as_tensor(pool)) == 0).all(-1).numpy()
    assert free.sum() >= 32, "too few configs of the pool are clear of the base grid"
    q[:32] = pool[free][:32]
    return q, sigma, box_at


def _plain(tmod, q, sigma):
    x = torch.as_tensor(q).requires_grad_()
    lik = tcol.log_prob_plain(tmod, x.reshape(R, -1, q.shape[-1]), torch.as_tensor(sigma)).reshape(-1)
    lik.sum().backward()
    return lik.detach(), x.grad


def _jax(jmod, q, sigma):
    f = jax.vmap(lambda qb, sb: jmod.log_prob(qb, sb))
    qr, s = jnp.asarray(q.reshape(R, -1, q.shape[-1])), jnp.asarray(sigma)
    lik = np.asarray(f(qr, s)).reshape(-1)
    g = np.asarray(jax.grad(lambda x: jnp.sum(f(x, s)))(qr)).reshape(q.shape)
    return torch.from_numpy(lik.copy()), torch.from_numpy(g.copy())


def _agree(lik_k, g_k, lik_r, g_r, what):
    """The kernel's (lik, d/dq) against a reference's, at the tolerances
    above for the kernel's dtype; returns the configs that agree."""
    nan_k, nan_r = torch.isnan(g_k), torch.isnan(g_r)
    assert torch.equal(nan_k, nan_r), f"{what}: the NaN pattern of d/dq differs"
    finite = ~nan_r.any(-1)
    scale = g_r[finite].abs().max().item()
    if lik_k.dtype == torch.float64:
        rtol, atol, gtol = RTOL64, RTOL64 * lik_r.abs().max().item(), GTOL64
    else:
        rtol, atol, gtol = RTOL, ATOL, GTOL
    close = torch.isclose(lik_k, lik_r, rtol=rtol, atol=atol) & (
        ((g_k - g_r).abs() <= gtol * scale).all(-1) | ~finite)
    share = (~close).float().mean().item()
    assert share <= SHARE, f"{what}: {share:.2e} of the configs differ"
    ok = close & finite
    torch.testing.assert_close(g_k[ok], g_r[ok], rtol=0, atol=gtol * scale)
    return close


CASES = [pytest.param(m, x, False, id=f"{m}-{x}") for m, x in (("packed", 1), ("packed", 2), ("nearest", 0),
                                                                ("nearest", 1))]
CASES += [pytest.param("packed", x, True, id=f"packed-{x}-float64") for x in (0, 1)]


def _f64_inputs(inputs, f64):
    """The inputs, or in float64 their first T64 configs."""
    q, sigma, box_at = inputs
    return (q[:T64].astype(np.float64), sigma.astype(np.float64), box_at) if f64 else inputs


def test_the_split_design_takes_these_instantiations(k1cpu):
    """The composed packed lookup and the nearest-cell lookup (alone and
    composed) run the split design; the base-only packed lookup (the main
    path) keeps the one-pass loop."""
    got = {(m, x): bool(k1cpu.k1_split_design(tcol.K1_MODES[m], x, 0)) for m in ("packed", "nearest")
           for x in (0, 1)}
    assert got == {("packed", 0): False, ("packed", 1): True, ("nearest", 0): True, ("nearest", 1): True}


def test_the_split_design_takes_these_float64_instantiations(k1cpu):
    """In float64 the same: the split design for the composed packed lookup
    and the nearest cell, the one-pass loop for the base-only packed lookup
    and the trilinear lookup."""
    got = {(m, x): bool(k1cpu.k1_split_design(tcol.K1_MODES[m], x, 1))
           for m in ("packed", "nearest", "trilinear") for x in (0, 1)}
    assert got == {("packed", 0): False, ("packed", 1): True, ("nearest", 0): True, ("nearest", 1): True,
                   ("trilinear", 0): False, ("trilinear", 1): False}


def _mode_model(mode, extra_grids, box_at, f64):
    _, _, tmod = _models("nearest" if mode == "trilinear" else mode, extra_grids, box_at, 0.05, f64)
    if mode == "trilinear":
        tmod = tcol.CollisionModel(fk=tmod.fk, scene=replace(tmod.scene, mode="trilinear"), epsilon=0.05)
    return tmod


@pytest.mark.parametrize("extra_grids", [0, 1], ids=["base", "composed"])
@pytest.mark.parametrize("mode", ["packed", "nearest", "trilinear"])
def test_smoke_names_the_design_the_source_picks(k1cpu, inputs, mode, extra_grids):
    """``chip_smoke.py:k1_design``, the label of K1's rows in the smoke's
    kernels line and in the design timer's, is the design that
    ``k1_collision.cuh:k1_split`` picks for the model's lookup."""
    import chip_smoke

    tmod = _mode_model(mode, extra_grids, inputs[2], False)
    split = bool(k1cpu.k1_split_design(tcol.K1_MODES[mode], extra_grids, 0))
    assert chip_smoke.k1_design(tmod) == ("split" if split else "one-pass")


@pytest.mark.parametrize("extra_grids", [0, 1], ids=["base", "composed"])
@pytest.mark.parametrize("mode", ["packed", "nearest", "trilinear"])
def test_smoke_names_the_float64_design_the_source_picks(k1cpu, inputs, mode, extra_grids):
    """The same for a float64 model: ``chip_smoke.py:k1_design`` names the
    design ``k1_split`` picks for (mode, extras, float64)."""
    import chip_smoke

    tmod = _mode_model(mode, extra_grids, inputs[2], True)
    assert tmod.scene.base.data.dtype == torch.float64
    split = bool(k1cpu.k1_split_design(tcol.K1_MODES[mode], extra_grids, 1))
    assert chip_smoke.k1_design(tmod) == ("split" if split else "one-pass")


@pytest.mark.parametrize("eps", [-5.0, 0.05, 5.0], ids=["none_active", "some_active", "all_active"])
@pytest.mark.parametrize("mode,extra_grids,f64", CASES)
def test_k1_source_matches_plain_and_jax(k1cpu, inputs, mode, extra_grids, f64, eps):
    """lik and d/dq of the kernel's source against ``log_prob_plain`` and
    against JAX, random tiles and a tail tile, with ε = 5 cm (on the base
    grid alone tile 0 has no hinge-active pair), with ε = -5 m (no pair is
    hinge-active: the gradient pass never runs) and with ε = 5 m (every pair
    is). Where the scene has its box, the config whose sphere centre it
    holds has a NaN d/dq in the joints that move that sphere, on every
    side, where that sphere is hinge-active. Float64 (``f64``): the packed
    lookup, alone and composed, against both in float64."""
    q, sigma, box_at = _f64_inputs(inputs, f64)
    spec, jmod, tmod = _models(mode, extra_grids, box_at, eps, f64)
    qt, st = torch.as_tensor(q), torch.as_tensor(sigma)
    lik_k, g_k, _ = k1_run(k1cpu, tmod, qt, st, True)
    lik_p, g_p = _plain(tmod, q, sigma)
    lik_j, g_j = _jax(jmod, q, sigma)
    with torch.no_grad():
        active = tmod.hinge_cost(qt) > 0
    if eps != 0.05:
        assert bool(active.all()) == (eps > 0) and bool(active.any()) == (eps > 0)
    else:
        assert 0.02 < active.float().mean() < 0.9
        assert extra_grids or not active[:32].any()
    keep = torch.ones(len(q), dtype=torch.bool)
    if extra_grids:
        assert torch.isnan(g_p[40]).any() and not torch.isnan(g_p[41]).any()
    if extra_grids and eps < 0:
        # a sphere centre in the box (config 40's and others') with its hinge
        # inactive: the references' autodiff multiplies the maximum's zero by
        # the norm's NaN, the kernel takes no gradient of an inactive pair
        # (ROADMAP.md Queue 3); those configs are held to lik alone
        keep = ~torch.isnan(g_p).any(-1)
        assert not keep[40]
        assert torch.equal(torch.isnan(g_j).any(-1), ~keep) and torch.isfinite(g_k).all()
        assert torch.equal(lik_k, lik_p) and (lik_k == 0).all()
    for lik_r, g_r, who in ((lik_p, g_p, "the plain version"), (lik_j, g_j, "JAX")):
        _agree(lik_k[keep], g_k[keep], lik_r[keep], g_r[keep], f"{mode}/{extra_grids} against {who}")


@pytest.mark.parametrize("mode,extra_grids,f64", CASES)
def test_k1_source_forward_and_h2(k1cpu, inputs, mode, extra_grids, f64):
    """The forward without d/dq gives the same lik; the σ-gradient forward
    gives lik and d/dq bit-equal to the frozen forward's and h² equal to the
    plain hinge squared."""
    q, sigma, box_at = _f64_inputs(inputs, f64)
    _, _, tmod = _models(mode, extra_grids, box_at, 0.05, f64)
    qt, st = torch.as_tensor(q), torch.as_tensor(sigma)
    lik_f, dq_f, _ = k1_run(k1cpu, tmod, qt, st, True)
    lik_0, none, _ = k1_run(k1cpu, tmod, qt, st, False)
    lik_h, dq_h, h2 = k1_run(k1cpu, tmod, qt, st, True, True)
    assert none is None
    assert torch.equal(lik_0, lik_f) and torch.equal(lik_h, lik_f)
    torch.testing.assert_close(dq_h, dq_f, rtol=0, atol=0, equal_nan=True)
    with torch.no_grad():
        h = tmod.hinge_cost(qt)
    lik_p = _plain(tmod, q, sigma)[0]
    if f64:
        ok = torch.isclose(lik_f, lik_p, rtol=RTOL64, atol=RTOL64 * lik_p.abs().max().item())
        tol = dict(rtol=RTOL64, atol=RTOL64 * (h * h).max().item())
    else:
        ok = torch.isclose(lik_f, lik_p, rtol=RTOL, atol=ATOL)
        tol = dict(rtol=1e-4, atol=1e-7)
    assert (~ok).float().mean().item() <= SHARE
    torch.testing.assert_close(h2.T[ok], (h * h)[ok], **tol)


def test_float64_cell_is_jax_cell_at_voxel_faces(k1cpu):
    """The float64 lookup's cell (``scene.cuh:nearest_cell``: the position in
    cells by ``div_by``, a product by the reciprocal and one fused
    correction) is the cell JAX's division picks
    (``vgpmp_tpu.sdf.grid._cell_index``), at points within an ulp or two of
    a voxel face on every axis, on a grid whose edge is not a power of two
    (so that the division rounds), outside the grid too (clamped)."""
    rng = np.random.default_rng(41)
    origin, delta, shape = np.array([-1.2345678, -0.87654321, -0.3141592]), 0.0123456789, (150, 170, 90)
    n = 20000
    idx = rng.integers(-3, np.array(shape) + 3, size=(n, 3))
    face = origin + idx * delta  # a voxel face on each axis, rounded
    step = rng.integers(-2, 3, size=(n, 3))
    pts = face.copy()
    for k in (1, 2):  # move each coordinate by up to two ulps either way
        pts = np.where(np.abs(step) >= k, np.nextafter(pts, np.where(step > 0, np.inf, -np.inf)), pts)
    pts = np.ascontiguousarray(pts)
    grid = np.array([*origin, delta])
    sh = np.array(shape, dtype=np.int32)
    got = np.empty(n, dtype=np.int64)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    k1cpu.k1_nearest_cells_f64(ptr(pts), n, ptr(grid), ptr(sh), ptr(got))
    jgrid = jg.SdfGrid.from_arrays(np.zeros(shape, np.float32), origin, delta, jnp.float64)
    ji = np.asarray(jg._cell_index(jgrid, jnp.asarray(pts)))
    want = (ji[:, 0].astype(np.int64) * shape[1] + ji[:, 1]) * shape[2] + ji[:, 2]
    floor = np.floor((pts - origin) / delta)
    assert (floor != idx).any() and (floor == idx).any(), "the points do not straddle the faces"
    np.testing.assert_array_equal(got, want)
