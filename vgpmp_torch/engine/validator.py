"""Trajectory validator and the fused metric of a solved row.

Port of ``vgpmp_tpu/engine/validator.py``. A trajectory *succeeds*
geometrically when its endpoints match the query within a joint tolerance,
every collision sphere stays clear of the scene along the probed path (up to
the query endpoints' own phantom penetration), and the joint limits hold. It is
*executed* when the contact-blocking PD executor (``vgpmp_torch/sim.py``) also
reaches every waypoint.

Where the JAX functions take one trajectory and are vmapped, these take a
leading row axis: ``traj [B, T, L]``, ``start``/``goal [B, L]``, and every
report field is ``[B]``. A single ``[T, L]`` trajectory with ``[L]`` endpoints
runs as ``B = 1`` and its report fields come back as scalars.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vgpmp_torch.sim import (
    _eval_clearance_fn, _probe_clearance_fn, _rows, kinematic_execute_trajectory, pd_path_configs,
    tapered_floor,
)

__all__ = ["ValidationReport", "validate_trajectory", "execution_success",
           "execute_and_validate", "densify"]


class ValidationReport(NamedTuple):
    success: torch.Tensor           # [B] bool, the geometric verdict
    collision_free: torch.Tensor    # [B] bool
    endpoints_ok: torch.Tensor      # [B] bool
    limits_ok: torch.Tensor         # [B] bool
    min_clearance: torch.Tensor     # [B] metres, worst sphere clearance anywhere
    max_endpoint_err: torch.Tensor  # [B] radians
    velocity_ok: Optional[torch.Tensor] = None  # [B] bool (checked when a duration is given)
    # [B] bool, the physical verdict: the contact-blocking PD executor
    # traverses every waypoint and the endpoints match the query. Filled by
    # execute_and_validate; None where only the geometric check ran.
    executed: Optional[torch.Tensor] = None


def _batched(traj, start, goal):
    traj = torch.as_tensor(traj)
    single = traj.ndim == 2
    if single:
        traj = traj[None]
    return traj, _rows(start, traj[:, 0]), _rows(goal, traj[:, 0]), single


def _report(single: bool, **fields) -> ValidationReport:
    if single:
        fields = {k: None if v is None else v[0] for k, v in fields.items()}
    return ValidationReport(**fields)


def _min_sphere_clearance(collision):
    """``[..., L] -> [...]`` worst clearance by the training path's lookup."""
    return lambda q: collision.sphere_clearance(q).min(dim=-1).values


def _endpoint_err(traj, start, goal):
    return torch.maximum((traj[:, 0] - start).abs().amax(dim=-1),
                         (traj[:, -1] - goal).abs().amax(dim=-1))


def densify(traj: torch.Tensor, factor: int) -> torch.Tensor:
    """Linear upsampling between waypoints: ``[..., T, L] -> [..., (T-1)*factor+1, L]``."""
    a, b = traj[..., :-1, :], traj[..., 1:, :]
    w = torch.arange(factor, dtype=traj.dtype, device=traj.device) / factor
    dense = a[..., :, None, :] + (b - a)[..., :, None, :] * w[:, None]
    return torch.cat([dense.flatten(-3, -2), traj[..., -1:, :]], dim=-2)


def validate_trajectory(collision, traj, start, goal, limits_low, limits_high,
                        clearance_margin: Optional[float] = None, endpoint_tol: float = 0.05,
                        densify_factor: int = 8, endpoint_slack: float = 0.005,
                        velocity_limits=None, duration: Optional[float] = None,
                        taper_radius: Optional[float] = 0.5) -> ValidationReport:
    """Validate trajectories along a straight-line densification, with the
    training path's clearance (``collision.sphere_clearance``).

    ``clearance_margin=None`` uses an endpoint-relative margin: a trajectory
    is collision-free when it never penetrates deeper than the query endpoints
    require, less ``endpoint_slack``. With ``taper_radius`` the allowance
    falls off linearly with L_inf joint distance from each endpoint; with
    ``taper_radius=None`` it is global. An explicit float is a strict absolute
    margin. ``velocity_limits`` (``[L]``, or ``[L, 2]`` whose second column
    counts) with ``duration`` gate success on per-joint ``|dq/dt|`` at uniform
    waypoint spacing.
    """
    traj, start, goal, single = _batched(traj, start, goal)
    min_of = _min_sphere_clearance(collision)
    dense = densify(traj, densify_factor)                            # [B, Td, L]
    clear = min_of(dense)                                            # [B, Td]
    min_clear = clear.amin(dim=1)
    if clearance_margin is None:
        if taper_radius is not None:
            margin_t = tapered_floor(min_of, dense, start, goal, taper_radius, endpoint_slack)
            collision_free = (clear >= margin_t).all(dim=1)
        else:
            end_clear = torch.minimum(min_of(start), min_of(goal))
            collision_free = min_clear >= torch.clamp(end_clear, max=0.0) - endpoint_slack
    else:
        collision_free = min_clear >= clearance_margin

    end_err = _endpoint_err(traj, start, goal)
    endpoints_ok = end_err <= endpoint_tol
    limits_ok = ((dense >= limits_low) & (dense <= limits_high)).flatten(1).all(dim=1)

    velocity_ok = torch.ones_like(endpoints_ok)
    if velocity_limits is not None and duration is not None:
        dt = duration / (traj.shape[1] - 1)
        qd = torch.diff(traj, dim=1).abs() / dt                      # [B, T-1, L]
        vmax = torch.as_tensor(velocity_limits, dtype=traj.dtype, device=traj.device)
        vmax = (vmax[:, 1] if vmax.ndim == 2 else vmax).abs()
        velocity_ok = (qd <= vmax).flatten(1).all(dim=1)

    return _report(single, success=collision_free & endpoints_ok & limits_ok & velocity_ok,
                   collision_free=collision_free, endpoints_ok=endpoints_ok, limits_ok=limits_ok,
                   min_clearance=min_clear, max_endpoint_err=end_err, velocity_ok=velocity_ok)


def execute_and_validate(collision, traj, start, goal, limits_low, limits_high,
                         endpoint_tol: float = 0.05, contact_slack: float = 5e-3,
                         taper_radius: float = 0.5, samples_per_segment: int = 64,
                         max_iters: int = 2000) -> ValidationReport:
    """Both metric verdicts from one clearance evaluation over the PD path
    (:func:`vgpmp_torch.sim.pd_path_configs`), with trilinear clearance.

    - ``executed``: every segment reached within the controller budget and
      the sampling guard, no visited config below the tapered phantom floor
      in this or an earlier segment, and endpoints matching the query;
    - ``success``: no visited config below the tapered floor, endpoints ok,
      and joint limits hold along the path (a reaching-budget violation does
      not fail it).
    """
    traj, start, goal, single = _batched(traj, start, goal)
    B, T = traj.shape[:2]

    qs, visited, seg_idx, n_stops, _, _, certified = pd_path_configs(
        traj, samples_per_segment=samples_per_segment)
    # one clearance call for the query's start and goal, whose depths set the
    # tapered floor, and the trajectory's first config
    end_clear = _eval_clearance_fn(collision)(torch.cat([start, goal, traj[:, 0]]))  # [3B]
    depth_s, depth_g = torch.clamp(-end_clear[:2 * B], min=0.0).split(B)
    # the probes' clearance, and how many probes of each segment lie below
    # the floor
    clear, seg_count = _probe_clearance_fn(collision)(
        qs, start, goal, depth_s, depth_g, visited[:, 0], seg_idx, T, taper_radius,
        contact_slack)                                               # [B, G], [B, T]

    blocked_upto = torch.cumsum((seg_count > 0).to(torch.int32), dim=1) > 0
    reached_seg = (n_stops <= max_iters) & certified[:, None]
    reached_all = (reached_seg & ~blocked_upto).all(dim=1)

    end_err = _endpoint_err(traj, start, goal)
    endpoints_ok = end_err <= endpoint_tol
    collision_free = seg_count.sum(dim=1) == 0

    # worst clearance over the visited configs and the trajectory's first
    # config, which stands in for the probes of a path without motion
    inf = torch.full_like(clear, float("inf"))
    min_clear = torch.minimum(torch.where(visited, clear, inf).amin(dim=1), end_clear[2 * B:])
    q_eval = torch.where(visited[:, :, None], qs, traj[:, :1])
    inside = lambda q: ((q >= limits_low) & (q <= limits_high)).flatten(1).all(dim=1)
    limits_ok = inside(q_eval) & inside(traj)

    return _report(single, success=collision_free & endpoints_ok & limits_ok,
                   collision_free=collision_free, endpoints_ok=endpoints_ok, limits_ok=limits_ok,
                   min_clearance=min_clear, max_endpoint_err=end_err,
                   velocity_ok=torch.ones_like(endpoints_ok), executed=reached_all & endpoints_ok)


def execution_success(collision, traj, start, goal, endpoint_tol: float = 0.05,
                      taper_radius: Optional[float] = 0.5) -> torch.Tensor:
    """The physical success metric, ``[B]`` bool: the contact-blocking executor
    traverses every waypoint and the endpoints match the query. The floor
    comes from the query states, never from the candidate's own endpoints;
    ``taper_radius=None`` makes it global (the deeper of the two endpoints'
    training-path clearances)."""
    traj, start, goal, single = _batched(traj, start, goal)
    if taper_radius is not None:
        reached_all, _, _ = kinematic_execute_trajectory(collision, traj,
                                                         taper=(start, goal, taper_radius))
    else:
        min_of = _min_sphere_clearance(collision)
        end_clear = torch.minimum(min_of(start), min_of(goal))
        reached_all, _, _ = kinematic_execute_trajectory(
            collision, traj, penetration_floor=torch.clamp(end_clear, max=0.0))
    ok = reached_all & (_endpoint_err(traj, start, goal) <= endpoint_tol)
    return ok[0] if single else ok
