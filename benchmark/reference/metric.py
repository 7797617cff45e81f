"""Plain reference of the execution metric: the closed-form path of a
velocity-capped PD controller through a trajectory's waypoints, probed at
equal steps, each probe's worst sphere clearance by trilinear lookup, and
the tapered floor below which a probe blocks the arm.

The path's geometry is computed in the trajectory's own precision (the
configuration's float32): the controller's step counts round up
(``ceil``), and a count that sits on an integer would otherwise move every
later probe by a step. Clearances and floors are float64. A probe within
:data:`DECISIVE_M` of its floor cannot decide a verdict either way at float32
accuracy; :func:`judge` says which rows such a probe could turn.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import F64, Problem, min_clearance

DT, VMAX, TOL, MAX_ITERS = 1.0 / 240.0, 0.5, 0.05, 2000
SAMPLES_PER_SEGMENT, TAPER, SLACK, ENDPOINT_TOL = 64, 0.5, 5e-3, 0.05
# a float32 clearance is good to ~3e-7 m; a probe nearer its floor than this
# decides nothing
DECISIVE_M = 1e-5


def pd_path(traj: torch.Tensor):
    """``traj [B, T, L]`` -> probes ``[B, G, L]``, their segments ``[B, G]``,
    the steps each segment takes ``[B, T]`` and whether the probes are dense
    enough (``[B]``)."""
    B, T, L = traj.shape
    step, inv = VMAX * DT, 1.0 / (VMAX * DT)
    q = traj[:, 0]
    entries, n_stops = [], []
    for t in range(T):
        delta = traj[:, t] - q
        dist = delta.abs()
        n = torch.ceil(torch.clamp(dist.amax(dim=-1) - TOL, min=0.0) * inv)
        entries.append(q)
        n_stops.append(n)
        q = traj[:, t] - torch.sign(delta) * torch.clamp(dist - n[:, None] * step, min=0.0)
    entries, n_stops = torch.stack(entries, 1), torch.stack(n_stops, 1)
    G = T * SAMPLES_PER_SEGMENT
    cum = torch.cumsum(n_stops, dim=1)
    total = cum[:, -1]
    u = (torch.arange(1, G + 1, dtype=traj.dtype, device=traj.device) / G) * total[:, None]
    seg = torch.searchsorted(cum, u, right=False).clamp(0, T - 1)
    base = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    n_in = u - base.gather(1, seg)
    pick = seg[:, :, None].expand(B, G, L)
    dlt = (traj - entries).gather(1, pick)
    qs = traj.gather(1, pick) - torch.sign(dlt) * torch.clamp(dlt.abs() - n_in[:, :, None] * step, min=0.0)
    return qs, seg, n_stops, total > 0, total <= G


def judge(pb: Problem, traj: torch.Tensor, starts: torch.Tensor, goals: torch.Tensor,
          block: int = 32) -> Dict[str, torch.Tensor]:
    """Verdicts of trajectories ``[B, T, L]`` (float32) for queries ``[B, L]``:
    ``executed``, ``success`` and ``min_clearance`` (metres, float64), and
    ``undecided``: a verdict that moving every floor by :data:`DECISIVE_M`
    up or down would change."""
    out = {k: [] for k in ("executed", "success", "min_clearance", "undecided")}
    for r0 in range(0, traj.shape[0], block):
        sl = slice(r0, min(traj.shape[0], r0 + block))
        for k, v in _judge(pb, traj[sl], starts[sl].to(traj.dtype), goals[sl].to(traj.dtype)).items():
            out[k].append(v)
    return {k: torch.cat(v) for k, v in out.items()}


def _judge(pb: Problem, traj, start, goal):
    B, T, L = traj.shape
    qs, seg, n_stops, visited, certified = pd_path(traj)
    ends = min_clearance(pb, torch.cat([start, goal, traj[:, 0]]).to(F64))
    depth_s, depth_g = torch.clamp(-ends[:2 * B], min=0.0).split(B)
    clear = min_clearance(pb, qs.to(F64))                                     # [B, G]
    ramp = lambda q0: torch.clamp(1.0 - (qs - q0[:, None]).abs().amax(dim=-1).to(F64) / TAPER, min=0.0)
    floor = -torch.maximum(depth_s[:, None] * ramp(start), depth_g[:, None] * ramp(goal)) - SLACK
    err = torch.maximum((traj[:, 0] - start).abs().amax(dim=-1), (traj[:, -1] - goal).abs().amax(dim=-1))
    ends_ok = err <= ENDPOINT_TOL
    q_eval = torch.where(visited[:, None, None], qs, traj[:, :1])
    inside = lambda q: ((q >= pb.lo.to(q.dtype)) & (q <= pb.hi.to(q.dtype))).flatten(1).all(dim=1)
    in_box = inside(q_eval) & inside(traj)
    reachable = ((n_stops <= MAX_ITERS) & certified[:, None])

    def verdicts(lift: float):
        below = visited[:, None] & (clear < floor + lift)
        count = torch.zeros((B, T), dtype=torch.int32, device=traj.device).scatter_add_(
            1, seg, below.to(torch.int32))
        blocked = torch.cumsum((count > 0).to(torch.int32), dim=1) > 0
        return ((reachable & ~blocked).all(dim=1) & ends_ok, (count.sum(dim=1) == 0) & ends_ok & in_box)

    executed, success = verdicts(0.0)
    lo, hi = verdicts(-DECISIVE_M), verdicts(DECISIVE_M)
    inf = torch.full_like(clear, float("inf"))
    return {"executed": executed, "success": success,
            "min_clearance": torch.minimum(torch.where(visited[:, None], clear, inf).amin(dim=1), ends[2 * B:]),
            "undecided": (lo[0] != hi[0]) | (lo[1] != hi[1])}
