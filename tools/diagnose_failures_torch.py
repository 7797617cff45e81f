#!/usr/bin/env python3
"""Per-problem failure diagnosis of the execution metric, on the card (the
port's ``tools/diagnose_failures.py``).

    python tools/diagnose_failures_torch.py --robot wam --env industrial \\
        [--seed 0] [--adaptive-rounds 3] [--taper-radius 0.5] [--json-out PATH] [--device cpu]

Runs one adaptive solve of the combo (the benchmark's engine, float32
session, ``max_rounds = len(inits) + --adaptive-rounds``) and, for every
problem that still does not execute, reports where and by how much its best
trajectory falls below the tapered penetration floor: the worst violation,
the clearance there, its place along the trajectory, its L_inf joint
distances to both query endpoints, the endpoints' phantom depths and the
endpoint error, classed ``endpoint-miss`` (error over 0.05 rad),
``graze<1cm``, ``shallow<3cm`` or ``deep-sweep``.

The profile reads the session's training lookup
(``CollisionModel.sphere_clearance``: the packed nearest cell on a packed
session), as the JAX tool does, not the trilinear clearance that decides the
verdict; a failed row can therefore show a negative worst violation.

Prints one JSON line per failure and writes the JAX tool's keys plus
``card``, ``seed``, ``allow_tf32`` (``torch.backends.cuda.matmul.allow_tf32``),
``tf32_override_env`` (the environment's ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE``,
which makes cuBLAS's float32 products TF32) and ``matmul_probe_err`` (see
:func:`matmul_probe`: whether that override took effect) to ``--json-out``,
by default
``chiprun_out/diag_<robot>_<env>.json``. Runs on the CUDA device and raises
without one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CLASSES = ("endpoint-miss", "graze<1cm", "shallow<3cm", "deep-sweep")
SLACK = 5e-3


def matmul_probe(device) -> float:
    """Largest difference of one float32 product of two 512 x 512 standard
    normal matrices from the same product in float64: about 1e-5 in float32,
    about 1e-2 where cuBLAS computes it in TF32."""
    gen = torch.Generator(device=device).manual_seed(0)
    a, b = (torch.randn((512, 512), generator=gen, device=device) for _ in range(2))
    return float((a @ b - a.double() @ b.double()).abs().max())


def failure_profile(collision, traj: torch.Tensor, start: torch.Tensor, goal: torch.Tensor,
                    radius: float, slack: float = SLACK):
    """The tapered floor along one trajectory ``traj [T, L]`` densified 8x,
    by the training lookup: ``(viol [Td], clear [Td], dist_s [Td], dist_g
    [Td], d_s, d_g, end_err)`` with ``viol = floor - clear`` (> 0 where the
    floor blocks), the L_inf joint distances to ``start`` and ``goal``, their
    phantom depths and the endpoint error. NaN propagates as in JAX."""
    from vgpmp_torch.engine.validator import densify

    with torch.no_grad():
        dense = densify(traj, 8)
        clear = collision.sphere_clearance(dense).min(dim=-1).values
        d_s = torch.clamp(-collision.sphere_clearance(start).min(), min=0.0)
        d_g = torch.clamp(-collision.sphere_clearance(goal).min(), min=0.0)
        dist_s = (dense - start).abs().amax(dim=-1)
        dist_g = (dense - goal).abs().amax(dim=-1)
        ramp = lambda d: torch.clamp(1.0 - d / radius, min=0.0)
        allowed = torch.maximum(d_s * ramp(dist_s), d_g * ramp(dist_g))
        viol = -allowed - slack - clear
        end_err = torch.maximum((traj[0] - start).abs().amax(), (traj[-1] - goal).abs().amax())
    return viol, clear, dist_s, dist_g, d_s, d_g, end_err


def failure_row(problem: int, profile) -> dict:
    """One failure's row from :func:`failure_profile`'s tensors, with the JAX
    tool's keys, rounding and class (``np.argmax`` takes the first NaN, and a
    NaN violation is classed ``deep-sweep``)."""
    viol, clear, dist_s, dist_g, d_s, d_g, end_err = (v.detach().cpu().numpy() for v in profile)
    j = int(np.argmax(viol))
    return {
        "problem": int(problem),
        "worst_violation_m": round(float(viol[j]), 4),
        "clearance_there_m": round(float(clear[j]), 4),
        "frac_along_traj": round(j / (len(viol) - 1), 3),
        "dist_to_start_rad": round(float(dist_s[j]), 3),
        "dist_to_goal_rad": round(float(dist_g[j]), 3),
        "start_phantom_depth_m": round(float(d_s), 4),
        "goal_phantom_depth_m": round(float(d_g), 4),
        "endpoint_err_rad": round(float(end_err), 4),
        "class": (
            "endpoint-miss" if end_err > 0.05 else
            "graze<1cm" if viol[j] < 0.01 else
            "shallow<3cm" if viol[j] < 0.03 else "deep-sweep"
        ),
    }


def run(robot: str, env: str, seed: int = 0, adaptive_rounds: int = 3, taper_radius: float = 0.5,
        device=None):
    """The solve and one row per failure. Returns ``(result, best [B, T, L]
    np.ndarray, session)``; ``result`` is what ``main`` writes."""
    from vgpmp_torch import _build, resolve_device
    from vgpmp_torch.engine import solver
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import card

    device = resolve_device(device)
    if device.type == "cuda":
        _build.build()
    sess = PlanningSession(robot, env, dtype=torch.float32, device=device)
    starts, goals = sess.queries()
    inits = tuple(sess.planner_params.get("q_mu_inits", ["linear"]))
    t0 = time.time()
    best, reps, info = solver.solve_adaptive(
        sess.model, sess.train_config, starts, goals, sess.planner_params,
        inits=inits, max_rounds=len(inits) + adaptive_rounds, seed=seed)
    ex = np.asarray(reps.executed)
    print(f"{robot}/{env}: {int(ex.sum())}/{len(ex)} executed (k_eff {info['k_eff']:.2f}, "
          f"{time.time() - t0:.0f}s); diagnosing {int((~ex).sum())} failures", flush=True)

    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    rows = []
    for i in np.nonzero(~ex)[0]:
        row = failure_row(i, failure_profile(sess.model.collision, as_t(best[i]), as_t(starts[i]),
                                             as_t(goals[i]), taper_radius))
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"robot": robot, "env": env, "executed": int(ex.sum()), "problems": len(ex),
              "k_eff": info["k_eff"], "failures": rows, "seed": seed, "card": card(device),
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "tf32_override_env": os.environ.get("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE"),
              "matmul_probe_err": matmul_probe(device)}
    return result, best, sess


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--env", default="bookshelves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaptive-rounds", type=int, default=3)
    ap.add_argument("--taper-radius", type=float, default=0.5)
    ap.add_argument("--json-out", default=None,
                    help="default: chiprun_out/diag_<robot>_<env>.json")
    ap.add_argument("--device", default=None, help="'cpu' for the plain path; default: CUDA")
    args = ap.parse_args(argv)
    result, _, _ = run(args.robot, args.env, args.seed, args.adaptive_rounds, args.taper_radius,
                       args.device)
    out = Path(args.json_out or ROOT / "chiprun_out" / f"diag_{args.robot}_{args.env}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print("wrote", out)
    return result


if __name__ == "__main__":
    main()
