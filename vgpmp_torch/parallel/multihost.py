"""Multi-process solve runtime (port of ``vgpmp_tpu/parallel/multihost.py``).

Every process runs the same program: it joins the process group
(:func:`vgpmp_torch.parallel.mesh.init_distributed`), builds the same
float32 session on its own device, and solves its dp slab of the problemset
(:func:`vgpmp_torch.parallel.sharded.make_sharded_solver`). Problems are
independent, so the only traffic is the gather of the results and the
all-reduce of the metric sums (plus, with ``sp > 1``, the sample group's
collectives every step).

Entry points:

- :func:`worker_main`, the per-process program, runnable as
  ``python -m vgpmp_torch.parallel.multihost``; ``tools/launch_multihost_torch.py``
  starts one per rank. Rank 0 prints one JSON metrics line.
- :func:`run_sharded`, the library call behind it, for a caller that has
  initialised the process group itself.

Two processes over gloo on the CPU exercise the whole path (TCP rendezvous,
groups, broadcasts, all-reduces) and must give the one-process result
(``tests/test_torch_multihost.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["run_sharded", "worker_main", "card"]


def card(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or ``None`` on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sharded(robot: str, problemset: str, num_sample_shards: int = 1,
                overrides: Optional[Dict[str, Any]] = None, seed: int = 0,
                max_problems: Optional[int] = None, use_tuned: bool = True,
                device=None) -> Tuple[Dict[str, Any], float]:
    """Solve one problemset sharded over the ranks' mesh.

    Every rank of an initialised process group must call it (in a world of
    one it runs alone). A float32 session on this rank's device
    (:func:`vgpmp_torch.parallel.mesh.local_device`); the queries padded to a
    multiple of dp; linear inits; a first and a steady call of the sharded
    solver from one generator seed, each ended by a synchronise. Returns
    (metrics, steady seconds), the metrics the same on every rank: JAX's keys
    plus ``card``, the card's name and power limit (``None`` on the CPU).
    """
    from vgpmp_torch.engine import solver
    from vgpmp_torch.parallel.mesh import make_mesh
    from vgpmp_torch.parallel.sharded import make_sharded_solver, pad_problems
    from vgpmp_torch.session import PlanningSession

    mesh = make_mesh(num_sample_shards, device=device)
    sess = PlanningSession(robot, problemset, dtype=torch.float32, overrides=overrides or {},
                           use_tuned=use_tuned, device=mesh.device)
    starts, goals = sess.queries()
    if max_problems is not None:
        starts, goals = starts[:max_problems], goals[:max_problems]
    starts, goals, mask = pad_problems(starts, goals, mesh.dp)
    params_b = solver.init_batch(sess.model, starts, goals, sess.planner_params)
    solve = make_sharded_solver(sess.model, sess.train_config, mesh)

    def timed():
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        _sync(mesh.device)
        t0 = time.perf_counter()
        _, metrics = solve(params_b, starts, goals, gen, mask)
        _sync(mesh.device)
        return time.perf_counter() - t0, metrics

    first, _ = timed()
    steady, metrics = timed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = [str(mesh.device)]
    if dist.is_initialized():
        devices = [None] * world
        dist.all_gather_object(devices, str(mesh.device))
    out = {
        "success_rate": float(metrics["success_rate"]),
        "num_problems": float(metrics["num_problems"]),
        "mean_min_clearance": float(metrics["mean_min_clearance"]),
        "compile_plus_first_seconds": first,
        "steady_batch_seconds": steady,
        "solves_per_sec": float(np.sum(mask)) / steady,
        "num_processes": world,
        "num_devices": len(set(devices)),
        "mesh": mesh.shape,
        "card": card(mesh.device),
    }
    return out, steady


def worker_main(argv: Optional[list] = None) -> Dict[str, Any]:
    """Per-process entry: join the process group, solve, report (rank 0)."""
    ap = argparse.ArgumentParser()
    env = os.environ
    default_coord = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                     if "MASTER_ADDR" in env and "MASTER_PORT" in env else None)
    ap.add_argument("--coordinator", default=default_coord, help="host:port of rank 0's rendezvous")
    ap.add_argument("--num-processes", type=int, default=int(env.get("WORLD_SIZE", "1")))
    ap.add_argument("--process-id", type=int, default=int(env.get("RANK", "0")))
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--problemset", default="industrial")
    ap.add_argument("--sample-shards", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-problems", type=int, default=None)
    ap.add_argument("--overrides", default=None, help="JSON planner-param overrides")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: from the device)")
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)

    from vgpmp_torch.parallel.mesh import init_distributed

    if args.num_processes > 1:
        init_distributed(args.coordinator, args.num_processes, args.process_id, args.backend,
                         args.device)
    try:
        overrides = json.loads(args.overrides) if args.overrides else None
        metrics, _ = run_sharded(args.robot, args.problemset, args.sample_shards, overrides,
                                 seed=args.seed, max_problems=args.max_problems, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.process_id == 0:
        line = json.dumps(metrics)
        print(line, flush=True)
        if args.json_out:
            with open(args.json_out, "w") as f:
                f.write(line)
    return metrics


if __name__ == "__main__":
    worker_main()
