"""Simulator-free kinematic executor: the physical success metric.

Port of the kinematic part of ``vgpmp_tpu/sim.py`` (see that module's comment
for the model: per-joint velocity-capped PD approach to each waypoint, blocked
where the worst sphere clearance falls below a penetration floor; the floor
tolerates the query states' own phantom penetration, globally or tapered with
joint distance from the endpoints). The PyBullet ``PhysicsExecutor`` is not
ported.

Where the JAX functions take one trajectory and are vmapped, these take a
leading row axis: a trajectory is ``[B, T, L]`` and every output carries
``B`` first. A single ``[T, L]`` trajectory runs as ``B = 1`` and comes back
without the axis. Only the segment recurrence loops (over the ``T`` waypoints,
never over rows). On CUDA the clearance runs kernel K3: the probes with the
tapered floor's compare and the per-segment count through
``CollisionModel.probe_clearance`` (its fused entry), the endpoints through
``CollisionModel.min_clearance_eval``.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["pd_path_configs", "tapered_floor", "probe_clearance_plain",
           "kinematic_execute_trajectory", "kinematic_execute_trajectory_stepped"]


def _eval_clearance_fn(collision):
    """``[..., L] -> [...]`` worst sphere clearance for the metric: the model's
    ``min_clearance_eval`` (trilinear, K3 on CUDA), else the minimum of its
    ``sphere_clearance_eval``, else of ``sphere_clearance`` for models and
    stubs that provide nothing more."""
    fused = getattr(collision, "min_clearance_eval", None)
    if fused is not None:
        return fused
    per_sphere = getattr(collision, "sphere_clearance_eval", None) or collision.sphere_clearance
    return lambda q: per_sphere(q).min(dim=-1).values


def _probe_clearance_fn(collision):
    """The metric's pass over the probes, with the signature of
    :func:`probe_clearance_plain` less its first argument: the model's
    ``probe_clearance`` (K3's fused entry on CUDA), else the plain composition
    over :func:`_eval_clearance_fn`."""
    fused = getattr(collision, "probe_clearance", None)
    if fused is not None:
        return fused
    return functools.partial(probe_clearance_plain, _eval_clearance_fn(collision))


def _segment_count(seg_idx: torch.Tensor, violated: torch.Tensor, T: int) -> torch.Tensor:
    """``[B, G]`` probe flags -> ``[B, T]`` int32: how many probes of each
    segment are set. A count by ``scatter_add_`` on integers: the same on
    every device and run, which a bool scatter-reduce is not."""
    count = torch.zeros((seg_idx.shape[0], T), dtype=torch.int32, device=seg_idx.device)
    return count.scatter_add_(1, seg_idx, violated.to(torch.int32))


def _floor_from_depths(qs, q_s, q_g, depth_s, depth_g, radius: float, slack: float):
    """The tapered floor ``[B, G]`` at the probes ``qs [B, G, L]`` from the
    endpoints' penetration depths ``[B]``."""
    dist_s = (qs - q_s[:, None]).abs().amax(dim=-1)
    dist_g = (qs - q_g[:, None]).abs().amax(dim=-1)
    ramp = lambda d: torch.clamp(1.0 - d / radius, min=0.0)
    allowed = torch.maximum(depth_s[:, None] * ramp(dist_s), depth_g[:, None] * ramp(dist_g))
    return -allowed - slack


def tapered_floor(min_clear, qs: torch.Tensor, q_s: torch.Tensor, q_g: torch.Tensor,
                  radius: float, slack: float) -> torch.Tensor:
    """Blocking floor ``[B, G]`` at the probes ``qs [B, G, L]``: each query
    endpoint's phantom depth, falling off linearly to zero over ``radius`` rad
    of L_inf joint distance from that endpoint, plus ``slack``."""
    depth_s = torch.clamp(-min_clear(q_s), min=0.0)
    depth_g = torch.clamp(-min_clear(q_g), min=0.0)
    return _floor_from_depths(qs, q_s, q_g, depth_s, depth_g, radius, slack)


def probe_clearance_plain(min_clear, qs: torch.Tensor, q_s: torch.Tensor, q_g: torch.Tensor,
                          depth_s: torch.Tensor, depth_g: torch.Tensor, visited: torch.Tensor,
                          seg_idx: torch.Tensor, T: int, radius: float, slack: float):
    """Plain version of K3's fused entry (``k3_probe_clearance``): the worst
    clearance of every probe and how many probes of each segment lie below
    the tapered floor.

    ``qs [B, G, L]`` are the probes of :func:`pd_path_configs`, ``q_s``/``q_g
    [B, L]`` the query endpoints and ``depth_s``/``depth_g [B]`` their
    penetration depths (``clamp(-clearance, min=0)``), ``visited [B]`` whether
    the row's path moves, ``seg_idx [B, G]`` each probe's segment. A probe is
    violated when its row is visited and its clearance lies below the floor
    of :func:`tapered_floor`. Returns ``(clear [B, G], seg_count [B, T]
    int32)``."""
    clear = min_clear(qs)
    floor = _floor_from_depths(qs, q_s, q_g, depth_s, depth_g, radius, slack)
    violated = visited[:, None] & (clear < floor)
    return clear, _segment_count(seg_idx, violated, T)


def _rows(x, like: torch.Tensor) -> torch.Tensor:
    """``[L]`` or ``[B, L]`` -> ``[B, L]`` in ``like``'s dtype and device."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.expand(like.shape[0], -1) if x.ndim == 1 else x


def pd_path_configs(trajectory, dt: float = 1.0 / 240.0, vmax: float = 0.5, tol: float = 0.05,
                    samples_per_segment: int = 64):
    """Closed-form PD controller path (joint-space math only).

    The config after ``n`` controller steps of a segment with entry ``q0`` and
    target ``t`` is ``q(n) = t - sign(t - q0) * max(|t - q0| - n vmax dt, 0)``
    and the segment exits at ``n_stop = ceil((max_j |t-q0|_j - tol) / (vmax dt))``.
    The probe budget ``G = T * samples_per_segment`` is spread over the whole
    path by cumulative step count (equal-arc sampling); ``certified`` holds
    iff the spacing is at most one controller step (``total <= G``).

    Returns ``(qs [B, G, L], visited [B, G], seg_idx [B, G] int64, n_stops
    [B, T], entries [B, T, L], q_last [B, L], certified [B])``, without ``B``
    for a single trajectory.
    """
    traj = torch.as_tensor(trajectory)
    single = traj.ndim == 2
    if single:
        traj = traj[None]
    B, T, L = traj.shape
    step_cap = vmax * dt
    # the step count multiplies by the reciprocal where the formula divides:
    # that is what XLA compiles the JAX function's division by a constant to,
    # and what PyTorch's CUDA division by a scalar does, so every device and
    # both packages round a quotient that sits on an integer the same way
    inv_cap = 1.0 / step_cap

    # the recurrence: each segment's entry is the previous segment's exit
    q = traj[:, 0]
    entries, n_stops = [], []
    for t in range(T):
        target = traj[:, t]
        delta = target - q
        dist = delta.abs()
        n_stop = torch.ceil(torch.clamp(dist.amax(dim=-1) - tol, min=0.0) * inv_cap)
        entries.append(q)
        n_stops.append(n_stop)
        q = target - torch.sign(delta) * torch.clamp(dist - n_stop[:, None] * step_cap, min=0.0)
    q_last = q
    entries = torch.stack(entries, dim=1)          # [B, T, L]
    n_stops = torch.stack(n_stops, dim=1)          # [B, T]

    G = T * samples_per_segment
    cum = torch.cumsum(n_stops, dim=1)             # [B, T]
    total = cum[:, -1]
    # sample positions in (0, total] controller steps, equal spacing
    u = (torch.arange(1, G + 1, dtype=traj.dtype, device=traj.device) / G) * total[:, None]
    # the first segment whose cumulative count reaches u: a segment without
    # motion (equal neighbours in cum) is never picked before a moving one
    seg_idx = torch.searchsorted(cum, u, right=False).clamp(0, T - 1)       # [B, G]
    base = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    n_in = u - base.gather(1, seg_idx)                                      # (0, n_stop]
    pick = seg_idx[:, :, None].expand(B, G, L)
    dlt = (traj - entries).gather(1, pick)                                  # [B, G, L]
    resid = torch.clamp(dlt.abs() - n_in[:, :, None] * step_cap, min=0.0)
    qs = traj.gather(1, pick) - torch.sign(dlt) * resid
    visited = (total > 0)[:, None].expand(B, G)
    certified = total <= G
    out = (qs, visited, seg_idx, n_stops, entries, q_last, certified)
    return tuple(x[0] for x in out) if single else out


def kinematic_execute_trajectory_stepped(collision, trajectory, dt: float = 1.0 / 240.0,
                                         vmax: float = 0.5, tol: float = 0.05,
                                         max_iters: int = 2000, contact_slack: float = 5e-3,
                                         penetration_floor=None):
    """Step-by-step executor, the literal transcription of the PD mechanism and
    the equivalence twin of :func:`kinematic_execute_trajectory`: one
    clearance evaluation per controller step, in plain Python loops (over
    rows too). For tests only.

    The blocking floor is ``min(0, clearance(traj[0]), penetration_floor) -
    contact_slack``. Returns ``(success [B] bool, reached [B, T] bool,
    q_final [B, L])``, without ``B`` for a single trajectory.
    """
    traj = torch.as_tensor(trajectory)
    if traj.ndim == 3:
        floors = [None] * len(traj) if penetration_floor is None else \
            torch.as_tensor(penetration_floor).expand(len(traj))
        rows = [kinematic_execute_trajectory_stepped(collision, r, dt, vmax, tol, max_iters,
                                                     contact_slack, f)
                for r, f in zip(traj, floors)]
        return tuple(torch.stack(x) for x in zip(*rows))
    step_cap = vmax * dt
    clearance = _eval_clearance_fn(collision)
    q = traj[0]
    floor = torch.clamp(clearance(q), max=0.0)
    if penetration_floor is not None:
        floor = torch.minimum(floor, torch.as_tensor(penetration_floor, dtype=floor.dtype))
    floor = floor - contact_slack

    reached_all = []
    for target in traj:
        reached = bool((q - target).abs().max() <= tol)
        stuck, it = False, 0
        while not (reached or stuck) and it < max_iters:
            q_new = q + torch.clamp(target - q, -step_cap, step_cap)
            # contact rule: one clearance evaluation per controller step
            if bool(clearance(q_new) >= floor):
                q = q_new
            else:
                stuck = True
            reached = bool((q - target).abs().max() <= tol)
            it += 1
        reached_all.append(reached)
    reached_t = torch.tensor(reached_all, device=traj.device)
    # every waypoint after an unreached one is tried from where the arm
    # stands, as the scan over waypoints does; success needs them all
    return reached_t.all(), reached_t, q


def kinematic_execute_trajectory(collision, trajectory, dt: float = 1.0 / 240.0,
                                 vmax: float = 0.5, tol: float = 0.05, max_iters: int = 2000,
                                 contact_slack: float = 5e-3, penetration_floor=None, taper=None,
                                 samples_per_segment: int = 64):
    """Closed-form contact-blocking PD executor (the production metric).

    Success is (every segment reaches within ``max_iters`` controller steps
    and within the sampling guard) and (no visited config of this or an
    earlier segment violates the floor): one batched clearance evaluation
    over the ``[B, T * samples_per_segment]`` probes of
    :func:`pd_path_configs`.

    ``taper``: optional ``(q_start, q_goal, radius)`` with ``[B, L]`` or
    ``[L]`` endpoints; tolerate each query endpoint's phantom penetration
    with a linear falloff over L_inf joint distance ``radius``. Without it the
    floor is global: ``min(0, clearance(traj[0]), penetration_floor)``, with
    ``penetration_floor`` a scalar or ``[B]``. Both less ``contact_slack``.

    Returns ``(success [B] bool, reached [B, T] bool, q_final [B, L])``,
    without ``B`` for a single trajectory.
    """
    traj = torch.as_tensor(trajectory)
    single = traj.ndim == 2
    if single:
        traj = traj[None]
    B, T, L = traj.shape
    min_clear = _eval_clearance_fn(collision)

    qs, visited, seg_idx, n_stops, entries, q_last, certified = pd_path_configs(
        traj, dt=dt, vmax=vmax, tol=tol, samples_per_segment=samples_per_segment)
    # a non-finite segment never reaches (comparisons with NaN are False);
    # an undersampled path is conservatively unreached
    reached_seg = (n_stops <= max_iters) & certified[:, None]

    if taper is not None:
        q_s, q_g, radius = taper
        q_s, q_g = _rows(q_s, traj), _rows(q_g, traj)
        # both endpoints' clearances in one call
        depth_s, depth_g = torch.clamp(-min_clear(torch.cat([q_s, q_g])), min=0.0).split(B)
        _, seg_count = _probe_clearance_fn(collision)(qs, q_s, q_g, depth_s, depth_g,
                                                      visited[:, 0], seg_idx, T, radius,
                                                      contact_slack)  # [B, T]
    else:
        clear = min_clear(qs)                                        # [B, G]
        floor0 = torch.clamp(min_clear(traj[:, 0]), max=0.0)
        if penetration_floor is not None:
            floor0 = torch.minimum(floor0, torch.as_tensor(penetration_floor, dtype=traj.dtype,
                                                           device=traj.device))
        floor = (floor0 - contact_slack)[:, None]                    # [B, 1]
        seg_count = _segment_count(seg_idx, visited & (clear < floor), T)

    blocked_upto = torch.cumsum((seg_count > 0).to(torch.int32), dim=1) > 0
    reached = reached_seg & ~blocked_upto
    success = reached.all(dim=1)
    first_bad = torch.argmax((~reached).to(torch.int32), dim=1)      # first unreached segment
    stop = entries.gather(1, first_bad[:, None, None].expand(B, 1, L))[:, 0]
    q_final = torch.where(success[:, None], q_last, stop)
    out = (success, reached, q_final)
    return tuple(x[0] for x in out) if single else out
