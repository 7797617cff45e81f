"""Receding-horizon replanning with warm-started variational state (port of
``vgpmp_tpu/engine/replan.py``).

After executing a prefix of the current best trajectory, re-solve from the
reached configuration with the previous variational state as a warm start,
at a smaller step budget, batched over problems. The start is a constant of
the conditioned model, not a parameter, so a warm start is the same
``PlannerParams`` with a new ``starts`` argument; the time grid stays the
unit interval, so the shorter remaining horizon compresses onto [0, 1].

Execution is kinematic (follow the trajectory), optionally disturbed by
``noise_scale·N(0, 1)`` per joint after each cycle but the last, clipped to
the joint limits. Everything stays on the model's device; nothing is copied
to the host inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from vgpmp_torch.engine import solver
from vgpmp_torch.models import vgpmp as planner

__all__ = ["ReplanResult", "make_replanner", "run_receding_horizon"]


class ReplanResult(NamedTuple):
    executed: torch.Tensor      # [B, T, L] stitched path (T = 1 + the executed waypoints)
    reached_goal: torch.Tensor  # [B] bool: the final configuration within goal_tol of the goal
    final_error: torch.Tensor   # [B] largest joint error to the goal at the end
    elbo_last: torch.Tensor     # [B, cycles] the final ELBO of each cycle


def make_replanner(model: planner.PlannerModel, cfg: solver.TrainConfig,
                   trainable: Optional[dict] = None):
    """``replan_cycle(params, current, goals, generator=None, noise=None) ->
    (params, SolveResult)``: one warm-started batched re-solve of
    ``cfg.num_steps`` steps (:func:`solver.make_batch_solver`)."""
    return solver.make_batch_solver(model, cfg, trainable)


def run_receding_horizon(model: planner.PlannerModel, full_cfg: solver.TrainConfig,
                         replan_cfg: solver.TrainConfig, params_b: planner.PlannerParams, starts,
                         goals, generator: Optional[torch.Generator] = None, cycles: int = 5,
                         advance: int = 20, goal_tol: float = 0.05, noise_scale: float = 0.0,
                         noise: Optional[Sequence[solver.SolveNoise]] = None,
                         disturbances: Optional[torch.Tensor] = None) -> ReplanResult:
    """Closed-loop plan, execute, replan over a problem batch.

    Cycle 0 runs ``full_cfg``; each later cycle runs ``replan_cfg`` from the
    configuration reached after executing ``advance`` waypoints of the
    previous plan, warm-started from its parameters. The last cycle executes
    its whole remaining plan. ``noise`` (one :class:`solver.SolveNoise` a
    cycle) and ``disturbances`` (``[cycles - 1, B, L]`` standard normal
    draws) replace the draws from ``generator``.
    """
    dt, dev = model.dtype, model.device
    current = torch.as_tensor(starts, dtype=dt, device=dev)
    goals = torch.as_tensor(goals, dtype=dt, device=dev)
    first, later = make_replanner(model, full_cfg), make_replanner(model, replan_cfg)
    executed, elbos = [current[:, None, :]], []
    params = params_b
    for c in range(cycles):
        params, res = (first if c == 0 else later)(params, current, goals, generator,
                                                   None if noise is None else noise[c])
        elbos.append(res.elbo_history[:, -1])
        upto = res.best.shape[1] if c == cycles - 1 else advance + 1
        steps = res.best[:, 1:upto, :]
        executed.append(steps)
        current = steps[:, -1, :]
        if noise_scale > 0.0 and c < cycles - 1:
            if disturbances is None:
                d = torch.randn(current.shape, dtype=dt, device=dev, generator=generator)
            else:
                d = torch.as_tensor(disturbances[c], dtype=dt, device=dev)
            current = torch.clamp(current + noise_scale * d, model.limits_low, model.limits_high)
            executed.append(current[:, None, :])
    err = (current - goals).abs().max(dim=-1).values
    return ReplanResult(executed=torch.cat(executed, dim=1), reached_goal=err <= goal_tol,
                        final_error=err, elbo_last=torch.stack(elbos, dim=1))
