"""K1's source (``vgpmp_torch/csrc/k1_collision.cuh``) on the CPU: the
split design of the composed packed lookup and of the nearest-cell lookup
(base grid alone and composed), the packed lookup in float64 (base grid
alone, its phase 1 spread over the block and its cell found by
``scene.cuh:div_by``, and composed), and the trilinear lookup (the base
grid alone in the one-pass loop with its phase 1 over the block, and the
composed scene in the split design, float32 and float64), held to the
port's plain version and to JAX; the trilinear lookup's value and gradient
alone at points outside the grid and exactly on its border; and
``k1_dsigma``, held to ``dsigma_plain`` and to ``jax.grad`` with respect to
σ_obs.

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
every pair is hinge-active. The trilinear cases shift the base grid by
``OFFSET_TRILINEAR`` so that some sphere centres lie outside it (the
composed scene's first extra grid is smaller than the arm's reach, so
centres leave it on every side).

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
the one JAX's division picks at points within an ulp of a voxel face. In
trilinear mode the value is continuous across a cell face but its gradient
is not, so a config whose d/dq differs counts in the same share as a config
whose value differs (``chip_smoke.py:k1_agreement``'s trilinear rule; ``_agree``
applies it to every mode).

``k1_dsigma`` reduces ½ Σ g h² / σ² over each row's K configs: against the
float64 sum of the same terms to 1e-5 of Σ|g|h²/(2σ²) in float32 (sums of
~1 000 terms of either sign in another order) and 1e-12 in float64; against
``jax.grad`` of JAX's ``log_prob`` on the same configs to 1e-4 of the same
scale in float32 (h from float32 FK on each side) and 1e-10 in float64,
configs whose value differs weighted 0.
"""

import ctypes
import shutil
import subprocess
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
OFFSET_TRILINEAR = [0.625, -0.3125, 0.1875]  # the base grid shifted (dyadic) so that centres leave it
RTOL, ATOL, GTOL, SHARE = 1e-5, 1e-3, 1e-3, 1e-3
RTOL64, GTOL64 = 1e-12, 1e-10
F32 = dict(dtype=torch.float32)


@pytest.fixture(scope="module")
def k1cpu(tmp_path_factory):
    """The kernel's source built for the CPU (g++, C++20, threads)."""
    d = tmp_path_factory.mktemp("k1_cpu")
    launch = (CSRC / "launch.cuh").read_text()
    call = "kernel<<<grid, block, smem, st>>>(args...);"
    assert call in launch
    (d / "launch.cuh").write_text(launch.replace(call, "k2_cpu_launch(kernel, grid, block, smem, args...);"))
    for f in ("k1_collision.cuh", "kernels.h", "fk.cuh", "scene.cuh"):
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
    for tag in ("f32", "f64"):
        getattr(lib, f"k1_dsigma_{tag}").argtypes = [P] * 4 + [I64, I64, I]
        getattr(lib, f"k1_trilinear_at_{tag}").argtypes = [P, I64, P, P, P, P, P]
    lib.k1_dsigma_parts.argtypes = [I64, I]
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
    with ``f64``); ``mode`` ``packed``, ``nearest`` or ``trilinear`` (the base
    grid at ``OFFSET_TRILINEAR``); ``extra_grids`` 0 for the base grid
    alone."""
    data, grids, offsets, prims = _numpy_scene(extra_grids, box_at)
    offset = OFFSET_TRILINEAR if mode == "trilinear" else OFFSET
    jt, tt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    jkw, tkw = {}, {}
    if extra_grids:
        jkw = dict(extra_grids=tuple(jg.SdfGrid.from_arrays(d, o, dl, jt) for d, o, dl in grids),
                   extra_offsets=jnp.asarray(offsets, jt),
                   primitives=jscene.Primitives(**{k: jnp.asarray(v, jt) for k, v in prims.items()}))
        tkw = dict(extra_grids=tuple(tg.SdfGrid.from_arrays(d, o, dl, tt) for d, o, dl in grids),
                   extra_offsets=torch.as_tensor(offsets, dtype=tt),
                   primitives=tscene.Primitives(**{k: torch.as_tensor(v, dtype=tt) for k, v in prims.items()}))
    lookup = "trilinear" if mode == "trilinear" else "nearest"
    jsc = jscene.Scene(base=jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jt),
                       base_offset=jnp.asarray(offset, jt), mode=lookup, **jkw)
    tsc = tscene.Scene(base=tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, tt),
                       base_offset=torch.as_tensor(offset, dtype=tt), mode=lookup, **tkw)
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
                                                                ("nearest", 1), ("trilinear", 0),
                                                                ("trilinear", 1))]
CASES += [pytest.param(m, x, True, id=f"{m}-{x}-float64") for m, x in (("packed", 0), ("packed", 1),
                                                                       ("trilinear", 1))]


def _f64_inputs(inputs, f64):
    """The inputs, or in float64 their first T64 configs."""
    q, sigma, box_at = inputs
    return (q[:T64].astype(np.float64), sigma.astype(np.float64), box_at) if f64 else inputs


def test_the_split_design_takes_these_instantiations(k1cpu):
    """Every composed lookup and the nearest-cell lookup alone run the split
    design; the base-only packed lookup (the main path) and the base-only
    trilinear lookup keep the one-pass loop."""
    got = {(m, x): bool(k1cpu.k1_split_design(tcol.K1_MODES[m], x, 0))
           for m in ("packed", "nearest", "trilinear") for x in (0, 1)}
    assert got == {("packed", 0): False, ("packed", 1): True, ("nearest", 0): True, ("nearest", 1): True,
                   ("trilinear", 0): False, ("trilinear", 1): True}


def test_the_split_design_takes_these_float64_instantiations(k1cpu):
    """In float64 the same: the split design for every composed lookup and
    the nearest cell, the one-pass loop for the base-only packed and
    trilinear lookups."""
    got = {(m, x): bool(k1cpu.k1_split_design(tcol.K1_MODES[m], x, 1))
           for m in ("packed", "nearest", "trilinear") for x in (0, 1)}
    assert got == {("packed", 0): False, ("packed", 1): True, ("nearest", 0): True, ("nearest", 1): True,
                   ("trilinear", 0): False, ("trilinear", 1): True}


def _mode_model(mode, extra_grids, box_at, f64):
    return _models(mode, extra_grids, box_at, 0.05, f64)[2]


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
        assert extra_grids or mode == "trilinear" or not active[:32].any()
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


def _edge_points(rng, offset):
    """World points for the trilinear lookup: uniform over a box larger than
    the grid (outside on every side), on cell faces, and exactly on the
    grid's lower and upper border (the dyadic origin and edge make them
    exact; there the clip passes half the gradient, outside none)."""
    top = ORIGIN + DELTA * (np.array(SHAPE) - 1)
    box = rng.uniform(ORIGIN - 0.3, top + 0.3, size=(120, 3))
    cells = rng.integers(1, np.array(SHAPE) - 1, size=(30, 3))
    faces = ORIGIN + DELTA * (cells + rng.uniform(0.1, 0.9, size=(30, 3)))
    for a in range(3):
        faces[10 * a:10 * (a + 1), a] = ORIGIN[a] + DELTA * cells[10 * a:10 * (a + 1), a]
    border = ORIGIN + DELTA * (rng.integers(1, np.array(SHAPE) - 1, size=(24, 3)) + 0.5)
    for a in range(3):
        border[8 * a:8 * a + 4, a] = ORIGIN[a]
        border[8 * a + 4:8 * a + 8, a] = top[a]
    return np.concatenate([box, faces, border]) + np.asarray(offset)


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_trilinear_lookup_matches_jax_at_the_edges(k1cpu, f64):
    """The trilinear lookup that the split design's passes call
    (``GridLookup<S, K1_TRILINEAR>::value_at`` and ``gradient_at``) against
    ``vgpmp_tpu.scene.Scene.distance`` in trilinear mode and its ``jax.grad``
    at points outside the grid, on cell faces and exactly on its lower and
    upper border, where the gradient along the clamped axis is 0 outside and
    half inside (``jnp.clip``'s tie). Float32: values 1e-6, gradients 1e-5 of
    the largest; float64: 1e-12 both."""
    data, _, _, _ = _numpy_scene(0, None)
    jt, nt, tol = (jnp.float64, np.float64, 1e-12) if f64 else (jnp.float32, np.float32, 1e-6)
    p = _edge_points(np.random.default_rng(43), OFFSET_TRILINEAR).astype(nt)
    jsc = jscene.Scene(base=jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jt),
                       base_offset=jnp.asarray(OFFSET_TRILINEAR, jt), mode="trilinear")
    want = np.asarray(jsc.distance(jnp.asarray(p)))
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jsc.distance(x)))(jnp.asarray(p)))
    grid = np.array([*OFFSET_TRILINEAR, *ORIGIN, DELTA], dtype=nt)
    vals = np.ascontiguousarray(data.astype(nt))
    value, grad = np.empty(len(p), dtype=nt), np.empty_like(p)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    run = k1cpu.k1_trilinear_at_f64 if f64 else k1cpu.k1_trilinear_at_f32
    run(ptr(p), len(p), ptr(grid), ptr(np.array(SHAPE, dtype=np.int32)), ptr(vals), ptr(value), ptr(grad))
    np.testing.assert_allclose(value, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(grad, gwant, rtol=0, atol=(tol if f64 else 1e-5) * np.abs(gwant).max())
    rel = (p - np.asarray(OFFSET_TRILINEAR) - ORIGIN) / DELTA
    on_border = (rel == 0) | (rel == np.array(SHAPE) - 1)
    outside = (rel < 0) | (rel > np.array(SHAPE) - 1)
    assert on_border.sum() == 24 and outside.any()
    assert (grad[outside] == 0).all() and (grad[on_border] != 0).any()


def dsigma_run(lib, g, h2, sigma, misalign=False):
    """``k1_dsigma``'s source on the stub: ``g [T]``, ``h2 [P, T]``,
    ``sigma [R, P]`` -> ``[R, P]``; with ``misalign``, g and h² are read from
    buffers one element past a 16-byte boundary."""
    if misalign:
        gb, hb = torch.empty(g.numel() + 1, dtype=g.dtype), torch.empty(h2.numel() + 1, dtype=h2.dtype)
        gb[1:] = g
        hb[1:] = h2.reshape(-1)
        g, h2 = gb[1:], hb[1:].view(h2.shape)
        assert g.data_ptr() % 16 != 0 and h2.data_ptr() % 16 != 0
    R, P = sigma.shape
    out = torch.empty_like(sigma)
    run = lib.k1_dsigma_f64 if g.dtype == torch.float64 else lib.k1_dsigma_f32
    rc = run(g.data_ptr(), h2.data_ptr(), sigma.data_ptr(), out.data_ptr(), g.numel(), g.numel() // R, P)
    assert rc == 0, f"k1_dsigma: cudaError {rc}"
    return out


@pytest.mark.parametrize("f64,K,misalign", [(False, 431, False), (False, 1100, True), (True, 431, True),
                                             (True, 1100, False)],
                         ids=["float32-431", "float32-1100-misaligned", "float64-431-misaligned", "float64-1100"])
def test_k1_dsigma_source_matches_plain(k1cpu, f64, K, misalign):
    """``k1_dsigma`` on random h² (a third of it 0, as where no sphere
    touches) against the float64 sum of the same terms, with K = 431 (no
    multiple of 4: segments start off a 16-byte boundary, h²'s and g's in
    different places) and K = 1 100 (a segment in several warps' parts),
    from buffers aligned and off a 16-byte boundary; a NaN in g makes its
    row NaN in every sphere, as the plain sum does, and no other row."""
    dt = torch.float64 if f64 else torch.float32
    rng = np.random.default_rng(K + 2 * misalign + f64)
    R, P = 3, 37
    g = torch.as_tensor(rng.normal(size=R * K), dtype=dt)
    h2 = torch.as_tensor(rng.uniform(0, 4e-4, size=(P, R * K)) * (rng.uniform(size=(P, R * K)) > 0.33), dtype=dt)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(R, P)), dtype=dt)
    assert K < 1100 or k1cpu.k1_dsigma_parts(K, int(f64)) > 1
    got = dsigma_run(k1cpu, g, h2, sigma, misalign)
    ref = tcol.dsigma_plain(g.double(), h2.double(), sigma.double())
    scale = tcol.dsigma_plain(g.abs().double(), h2.double(), sigma.double())
    assert ((got.double() - ref).abs() <= (1e-12 if f64 else 1e-5) * scale).all()
    gn = g.clone()
    gn[K + 7] = float("nan")
    out = dsigma_run(k1cpu, gn, h2, sigma, misalign)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_k1_dsigma_source_matches_jax_grad(k1cpu, inputs, f64):
    """K1's d/dσ from the kernels' sources, the σ-gradient forward's h² then
    ``k1_dsigma`` (rows of K = 431 configs in float32, 131 in float64, both
    odd), against ``jax.grad`` of JAX's ``CollisionModel.log_prob`` with
    respect to σ_obs, and against ``dsigma_plain`` of the plain hinge
    squared; configs whose value differs (a centre in the neighbouring
    cell) weighted 0. On the composed packed scene, a box around a sphere
    centre included."""
    q, sigma, box_at = _f64_inputs(inputs, f64)
    _, jmod, tmod = _models("packed", 1, box_at, 0.05, f64)
    qt, st = torch.as_tensor(q), torch.as_tensor(sigma)
    g = torch.as_tensor(np.random.default_rng(47).normal(size=len(q)), dtype=qt.dtype)
    lik_k, _, h2 = k1_run(k1cpu, tmod, qt, st, True, True)
    lik_j, _ = _jax(jmod, q, sigma)
    w = g * torch.isclose(lik_k, lik_j, rtol=RTOL64 if f64 else RTOL, atol=RTOL64 if f64 else ATOL)
    assert (w != 0).float().mean() > 0.99
    got = dsigma_run(k1cpu, w, h2, st)
    f = jax.vmap(lambda qb, sb: jmod.log_prob(qb, sb))
    qr, wr = jnp.asarray(q.reshape(R, -1, q.shape[-1])), jnp.asarray(w.numpy().reshape(R, -1))
    want = torch.from_numpy(np.asarray(jax.grad(lambda s: jnp.sum(wr * f(qr, s)))(jnp.asarray(sigma))).copy())
    scale = tcol.dsigma_plain(w.abs().double(), h2.double(), st.double())
    assert (scale > 0).any()
    assert ((got.double() - want.double()).abs() <= (1e-10 if f64 else 1e-4) * scale + 1e-300).all()
    with torch.no_grad():
        hh = tmod.hinge_cost(qt)
    plain = tcol.dsigma_plain(w.double(), (hh * hh).T.double(), st.double())
    assert ((got.double() - plain).abs() <= (1e-10 if f64 else 1e-4) * scale + 1e-300).all()
