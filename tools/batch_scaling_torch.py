#!/usr/bin/env python3
"""Batch-size sweep of the batched solve on the card (the port's
``tools/batch_scaling.py``): where do more rows stop being free?

    python tools/batch_scaling_torch.py [--robot franka --env industrial] \\
        [--sizes 36 64 128 192 256 512] [--reps 3] [--json-out PATH] [--device cpu]

Each size replicates the problemset's queries across ``B`` rows
(``np.arange(B) % Q``) and runs ``make_batch_solver`` on the tuned float32
session: one first call, then ``--reps`` steady calls, each drawing from its
own generator (seeded ``r + 1``) and ending in ``torch.cuda.synchronize()``.
A row holds the JAX tool's keys (``batch``, ``steady_seconds`` (the fastest
steady call), ``solves_per_sec``, ``ms_per_problem``,
``compile_plus_first_seconds``) and ``peak_memory_bytes`` with
``peak_bytes_per_row`` (``torch.cuda.max_memory_allocated``), the executed
share of the last call's best trajectories (``execute_and_validate``), so
that a faster size that executes fewer rows shows it, and the kernel
launches of the child.

Each size runs in a subprocess of its own: on the card an out-of-memory
error or a device fault can poison the process's context. A child that exits
non-zero is recorded as a row with ``failed``, ``rc`` and the tail of its
stderr, and the sweep goes on. Rows are flushed to ``--json-out`` (default
``chiprun_out/scaling_torch.json``) as they come. Runs on the CUDA device and
raises without one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEFAULT_SIZES = (36, 64, 128, 192, 256, 512)


def run_one(robot: str, env: str, B: int, reps: int, device=None, overrides=None) -> dict:
    """One size's row (see the module docstring)."""
    import torch

    from vgpmp_torch import _build, resolve_device
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.session import PlanningSession

    if B < 1 or reps < 1:
        raise ValueError(f"batch {B} and reps {reps} must be at least 1")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        _build.build()
    sess = PlanningSession(robot, env, dtype=torch.float32, use_tuned=True,
                           overrides=dict(overrides or {}), device=device)
    model = sess.model
    starts0, goals0 = sess.queries()
    idx = np.arange(B) % len(starts0)
    starts, goals = starts0[idx], goals0[idx]
    solve_b = solver.make_batch_solver(model, sess.train_config)
    params_b = solver.init_batch(model, starts, goals, sess.planner_params)
    sb = torch.as_tensor(starts, dtype=torch.float32, device=device)
    gb = torch.as_tensor(goals, dtype=torch.float32, device=device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = (k1_loglik, la.k2_factor_solve, la.k2_factor_solve_bwd, la.k2_trsm, la.k2_chol,
                k3_min_clearance, k3_probe_clearance)
    for c in counters:
        c.launches = 0
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()

    def call(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        _, res = solve_b(params_b, sb, gb, gen)
        sync()
        return time.perf_counter() - t0, res

    first, _ = call(0)
    times = []
    for r in range(reps):
        dt, res = call(r + 1)
        times.append(dt)
    with torch.no_grad():
        rep = execute_and_validate(model.collision, res.best, sb, gb, model.limits_low, model.limits_high)
    executed = float(rep.executed.float().mean())
    peak = torch.cuda.max_memory_allocated() if cuda else None
    steady = min(times)
    return {
        "batch": B,
        "steady_seconds": steady,
        "solves_per_sec": B / steady,
        "ms_per_problem": 1e3 * steady / B,
        "compile_plus_first_seconds": first,
        "steady_runs_seconds": times,
        "peak_memory_bytes": peak,
        "peak_bytes_per_row": None if peak is None else peak / B,
        "executed_share": executed,
        "launches": {c.__name__: c.launches for c in counters},
    }


def sweep(robot: str, env: str, sizes, reps: int, json_out: Path, device=None, overrides=None) -> dict:
    """Every size in a child process; returns the written record."""
    from vgpmp_torch import resolve_device
    from vgpmp_torch.timing import card

    dev = resolve_device(device)
    head = {"robot": robot, "env": env, "reps": reps, "card": card(dev),
            "isolation": "one subprocess per batch size (a device fault poisons the process)"}
    rows = []
    json_out.parent.mkdir(parents=True, exist_ok=True)
    for B in sizes:
        cmd = [sys.executable, __file__, "--robot", robot, "--env", env, "--one", str(B),
               "--reps", str(reps)]
        if device is not None:
            cmd += ["--device", str(device)]
        if overrides:
            cmd += ["--overrides", json.dumps(overrides)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
        row = next((json.loads(line[4:]) for line in proc.stdout.splitlines()
                    if line.startswith("ROW ")), None)
        if proc.returncode != 0 or row is None:
            tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
            row = {"batch": B, "failed": True, "rc": proc.returncode, "tail": "\n".join(tail)[-600:]}
            print(f"B={B:5d}: FAILED rc={proc.returncode} ({row['tail'][-200:]})", flush=True)
        else:
            print(f"B={B:5d}: {row['steady_seconds']:8.3f} s steady -> {row['solves_per_sec']:8.2f} "
                  f"solves/s ({row['ms_per_problem']:7.2f} ms/problem), first "
                  f"{row['compile_plus_first_seconds']:.1f} s, peak {row['peak_memory_bytes']} B, "
                  f"executed {row['executed_share']:.4f}", flush=True)
        rows.append(row)
        # flushed as it goes: a cut run keeps the sizes it finished
        json_out.write_text(json.dumps({**head, "partial": True, "rows": rows}, indent=1))
    out = {**head, "rows": rows}
    json_out.write_text(json.dumps(out, indent=1))
    print("wrote", json_out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--env", default="industrial")
    ap.add_argument("--sizes", type=int, nargs="*", default=list(DEFAULT_SIZES))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--one", type=int, default=None,
                    help="internal: run a single batch size and print its JSON row")
    ap.add_argument("--json-out", default=str(ROOT / "chiprun_out" / "scaling_torch.json"))
    ap.add_argument("--device", default=None, help="'cpu' for the plain path; default: CUDA")
    ap.add_argument("--overrides", default=None, help="JSON dict onto the tuned planner parameters")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None
    if args.one is not None:
        print("ROW " + json.dumps(run_one(args.robot, args.env, args.one, args.reps, args.device,
                                          overrides)), flush=True)
        return None
    return sweep(args.robot, args.env, args.sizes, args.reps, Path(args.json_out), args.device,
                 overrides)


if __name__ == "__main__":
    main()
