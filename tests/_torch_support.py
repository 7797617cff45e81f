"""Shared helpers for the ``test_torch_*`` parity tests (not a test module)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device; the test skips where there is none (decided at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def smooth_grid(rng, shape, scale=0.3):
    """A random smooth signed-distance-like field with exact zeros and bf16
    rounding ties planted in it."""
    axes = [np.linspace(0, 1, s) for s in shape]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    data = np.zeros(shape)
    for _ in range(4):
        c = rng.uniform(0, 1, 3)
        r = rng.uniform(0.1, 0.3)
        data = np.minimum(data if _ else np.full(shape, np.inf),
                          np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - r)
    data = (data * scale).astype(np.float32)
    data[2:5, 2:5, 2:5] = 0.0                     # flat plateau: zero gradients
    data[-3:, :, :] = data[-4:-3, :, :]           # flat border slab
    tie = np.uint32(0x3F808000)                   # 1.00390625: exactly half a bf16 ulp
    data.reshape(-1)[::97] = tie.view(np.float32)
    data.reshape(-1)[1::97] = np.uint32(0x3F818000).view(np.float32)  # odd tie
    return data


def jax_path_noise(keys, L, Mc, num_samples, num_bases, dtype=np.float64):
    """The draws ``vgpmp_tpu.gp.pathwise.draw_paths`` makes from each key (in
    the model's bulk ``dtype``, no antithetic pairing), stacked over the keys
    as a port ``PathNoise``."""
    import jax

    from vgpmp_tpu.gp import pathwise as jpath
    from vgpmp_torch.gp.pathwise import PathNoise

    rows = []
    for key in keys:
        k_omega, k_phase, k_w, k_eps = jax.random.split(key, 4)
        rows.append((
            jpath.student_t(k_omega, 5.0, (L, num_bases), dtype),
            jax.random.uniform(k_phase, (L, num_bases), dtype=dtype, maxval=jpath.TWO_PI),
            jax.random.normal(k_w, (num_samples, L, num_bases), dtype=dtype),
            jax.random.normal(k_eps, (num_samples, L, Mc), dtype=dtype),
        ))
    return PathNoise(*(torch.as_tensor(np.stack([np.asarray(r[i]) for r in rows]))
                       for i in range(4)))


def _planner_grid():
    shape, origin, delta = (40, 40, 36), np.array([-1.2, -1.2, -0.6]), 0.06
    data = smooth_grid(np.random.default_rng(5), shape, scale=1.0) - np.float32(0.1)
    return data, origin, delta, np.array([0.1, 0.0, -0.05])


def torch_planner_model(num_samples=3, num_bases=64, num_inducing=4, jitter=1e-6, escalations=0,
                        dtype=torch.float64, solve_dtype=None):
    """The port's half of :func:`planner_models`, with no JAX imported (for
    rank processes)."""
    from vgpmp_torch import robots as trobots
    from vgpmp_torch import scene as tscene
    from vgpmp_torch.kinematics import dh as tdh
    from vgpmp_torch.likelihoods import collision as tcol
    from vgpmp_torch.models import vgpmp as tm
    from vgpmp_torch.sdf import grid as tg

    data, origin, delta, off = _planner_grid()
    tspec = trobots.load_robot("franka")
    tsc = tscene.Scene(base=tg.SdfGrid.from_arrays(data, origin, delta, dtype),
                       base_offset=torch.as_tensor(off, dtype=dtype)).packed()
    return tm.PlannerModel(
        collision=tcol.CollisionModel(fk=tdh.FkModel.from_spec(tspec, np.eye(4), dtype=dtype),
                                      scene=tsc, epsilon=0.05),
        ny=torch.tensor([0.0, 1.0], dtype=dtype),
        limits_low=torch.as_tensor(tspec.limits_low, dtype=dtype),
        limits_high=torch.as_tensor(tspec.limits_high, dtype=dtype),
        num_samples=num_samples, num_bases=num_bases, num_inducing=num_inducing, jitter=jitter,
        jitter_escalations=escalations, variance_lower=0.1, solve_dtype=solve_dtype)


def planner_models(num_samples=3, num_bases=64, num_inducing=4, jitter=1e-6, escalations=0,
                   dtype=np.float64, solve_dtype=None):
    """The same small franka planner in both packages (packed scene, bulk
    ``dtype``, the Gram island in ``solve_dtype``: the bulk's unless given;
    both numpy dtypes)."""
    import jax.numpy as jnp

    from vgpmp_tpu import robots as jrobots
    from vgpmp_tpu import scene as jscene
    from vgpmp_tpu.kinematics import dh as jdh
    from vgpmp_tpu.likelihoods import collision as jcol
    from vgpmp_tpu.models import vgpmp as jm
    from vgpmp_tpu.sdf import grid as jg

    data, origin, delta, off = _planner_grid()
    jspec = jrobots.load_robot("franka")
    jsc = jscene.Scene(base=jg.SdfGrid.from_arrays(data, origin, delta, dtype),
                       base_offset=jnp.asarray(off, dtype)).packed()
    jmodel = jm.PlannerModel(
        collision=jcol.CollisionModel(fk=jdh.FkModel.from_spec(jspec, np.eye(4), dtype=dtype),
                                      scene=jsc, epsilon=jnp.asarray(0.05, dtype)),
        ny=jnp.asarray([0.0, 1.0], dtype), limits_low=jnp.asarray(jspec.limits_low, dtype),
        limits_high=jnp.asarray(jspec.limits_high, dtype), num_samples=num_samples,
        num_bases=num_bases, num_inducing=num_inducing, jitter=jitter,
        jitter_escalations=escalations, variance_lower=0.1, solve_dtype=solve_dtype)
    as_torch = lambda d: None if d is None else getattr(torch, np.dtype(d).name)
    tmodel = torch_planner_model(num_samples, num_bases, num_inducing, jitter, escalations,
                                 as_torch(dtype), as_torch(solve_dtype))
    return jspec, jmodel, tmodel


def metric_trajectories(rng, lo, hi, T=16):
    """Named ``[T, L]`` joint trajectories that exercise the PD-path metric:
    smooth, wiggly, with repeated waypoints, without motion, and two with more
    travel than the probe budget certifies (random jumps, a periodic zigzag)."""
    L = len(lo)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    w = np.linspace(0, 1, T)[:, None]
    a = mid + 0.25 * half * rng.uniform(-1, 1, L)
    b = mid + 0.25 * half * rng.uniform(-1, 1, L)
    smooth = a * (1 - w) + b * w
    wiggly = smooth + 0.03 * rng.normal(size=(T, L))
    repeated = np.repeat(smooth[: T // 2], 2, axis=0)
    still = np.repeat(a[None], T, axis=0)
    jumps = mid + 0.9 * half * rng.uniform(-1, 1, (T, L))
    # a periodic zigzag settles where every segment's step count is an exact
    # integer quotient: the rounding of the division decides the count
    zigzag = np.where((np.arange(T) % 2 == 0)[:, None], mid - 0.9 * half, mid + 0.9 * half)
    out = {"smooth": smooth, "wiggly": wiggly, "repeated": repeated, "still": still,
           "over_budget": jumps, "zigzag": zigzag}
    assert all(v.shape == (T, L) for v in out.values())
    return out


def jax_report_rows(fn, *batched):
    """Run the single-trajectory JAX function ``fn`` under ``jax.vmap`` over the
    leading axis of ``batched`` and return its output tree as numpy arrays."""
    import jax
    import jax.numpy as jnp

    out = jax.jit(jax.vmap(fn))(*(jnp.asarray(x) for x in batched))
    return jax.tree.map(np.asarray, out)


def scene_objects():
    """The extra sources of a composed test scene, in numpy (float64), placed
    in the reach of an arm based at the origin: two extra grids at their world
    offsets (the first smaller than the reach, so that sphere centres leave it
    on every side and its index clamps), and primitives of every kind, the
    second box rotated about a general axis. Returns ``(grids, offsets,
    prims)``: grids as ``(data, origin, delta)``, prims as the keyword
    arguments of ``Primitives``."""
    rng = np.random.default_rng(17)
    grids = [(smooth_grid(rng, (20, 24, 18), scale=0.5) - np.float32(0.02), np.array([-0.2, -0.25, -0.18]), 0.02),
             (smooth_grid(rng, (16, 16, 16), scale=0.8) - np.float32(0.03), np.array([-0.4, -0.4, -0.4]), 0.05)]
    offsets = np.array([[0.35, 0.05, 0.45], [-0.35, 0.3, 0.55]])
    a, b = 0.5, 0.3
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    prims = dict(
        sphere_centers=np.array([[0.45, -0.2, 0.55]]), sphere_radii=np.array([0.1]),
        box_centers=np.array([[0.0, 0.45, 0.3], [0.35, -0.35, 0.75]]),
        box_rotations=np.stack([np.eye(3), rz @ rx]),
        box_half_extents=np.array([[0.15, 0.1, 0.2], [0.2, 0.05, 0.1]]),
        capsule_a=np.array([[-0.3, -0.3, 0.2]]), capsule_b=np.array([[-0.3, -0.3, 0.7]]),
        capsule_radii=np.array([0.08]))
    return grids, offsets, prims


def torch_scene_with_objects(base_data, origin, delta, base_offset, dtype, device, packed=True):
    """A port ``Scene`` of the given base grid with :func:`scene_objects`' extras."""
    from vgpmp_torch import scene
    from vgpmp_torch.sdf import grid as sg

    grids, offsets, prims = scene_objects()
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    sc = scene.Scene(base=sg.SdfGrid.from_arrays(base_data, origin, delta, dtype, device),
                     base_offset=t(base_offset),
                     extra_grids=tuple(sg.SdfGrid.from_arrays(d, o, dl, dtype, device) for d, o, dl in grids),
                     extra_offsets=t(offsets), primitives=scene.Primitives(**{k: t(v) for k, v in prims.items()}))
    return sc.packed() if packed else sc


def source_wins(scene, points, active=None, mode_override=None):
    """How often each source of ``scene`` attains the composed minimum at
    ``points [..., 3]`` (where ``active``, a bool mask of the points' shape,
    holds): ``{source: count}``."""
    names, ds = zip(*scene.sources(points.detach(), mode_override))
    win = torch.stack(ds).argmin(dim=0)
    if active is not None:
        win = win[active]
    return {n: int((win == i).sum()) for i, n in enumerate(names)}


def mc40_grams():
    """The real conditioned Grams of a franka/industrial session with
    ``num_inducing = 38`` (Mc = 40, K2's block design), as a float64 CPU
    tensor ``[252, 40, 40]``: the session's 36 queries x 7 joints at the
    tuned init, jitter 1e-9; their condition number is ~8e9."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as tm
    from vgpmp_torch.session import PlanningSession

    s = PlanningSession("franka", "industrial", device="cpu", overrides={"num_inducing": 38})
    starts, goals = s.queries()
    params = solver.init_batch(s.model, starts, goals, s.planner_params)
    with torch.no_grad():
        K = tm._kuu(s.model, tm.constrain(params, s.model.variance_lower))
    return K.reshape(-1, *K.shape[-2:]).contiguous()
