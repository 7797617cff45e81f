#!/usr/bin/env python3
"""Benchmark matrix driver of the PyTorch/CUDA port (counterpart of
``benchmarking.py``): every robot x environment problemset solved as one batch
per run, scored by the physical execution metric.

    python3 benchmarking_torch.py --all --runs 2 [--adaptive-rounds 3]
    python3 benchmarking_torch.py --robot wam --problemset lab --runs 2
    python3 benchmarking_torch.py --all --runs 2 --parity

Tuned mode (the default) runs the problemset's tuned schedule and inits
through the adaptive restart engine (``solve_adaptive``, one bucket of ``B``
slots, ``max_rounds = len(q_mu_inits) + --adaptive-rounds``) on the packed
SDF, so training goes through kernel K1. ``--parity`` runs the reference's own
hyperparameters (no tuned overlay, ``jitter`` 1e-6) on the exact
nearest-cell SDF with ``make_batch_solver`` from linear init, then
``execute_and_validate``: on the card its Adam steps run K1's nearest-cell
instantiation (the unpacked float32 grid and its central difference).

Each combo's record has ``benchmarking.py``'s keys plus ``card`` (the card's
name and power limit as ``nvidia-smi`` gives them, or ``"cpu"``), the SDF mode,
the jitter and the executed rows by round of every run. The records go to
``chiprun_out/benchmarking_torch.json`` (``..._parity.json`` under
``--parity``), rewritten after each combo. There is no retry and no
``except``: a fault in one combo ends the run with a non-zero exit. Runs on
the CUDA device and raises without one (``run_combo(..., device="cpu")``
runs the plain path, for a rehearsal at a small budget).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent

ALL_COMBOS = [
    ("franka", "industrial"),
    ("franka", "bookshelves"),
    ("kuka", "industrial"),
    ("kuka", "bookshelves"),
    ("wam", "industrial"),
    ("wam", "bookshelves"),
    ("wam", "lab"),
    ("ur10", "industrial"),
    ("ur10", "bookshelves"),
]

METRIC = ("execution_success (contact-blocking PD executor + endpoints, tapered phantom floor "
          "r=0.5, trilinear clearance, undersampling guard)")


def engine_commit() -> Optional[str]:
    """The checkout's short commit, or ``None`` where there is no git history."""
    git = shutil.which("git")
    if git is None:
        return None
    out = subprocess.run([git, "-C", str(ROOT), "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True, timeout=10)
    return out.stdout.strip() or None


def run_combo(robot: str, problemset: str, runs: int, sdf_mode: str, seed: int,
              use_tuned: bool = True, adaptive_rounds: int = 0, device=None,
              overrides: Optional[dict] = None) -> dict:
    """Solve one robot x environment problemset ``runs`` times (seeds ``seed``,
    ``seed + 1``, ...) and return its record.

    With more than one configured init or ``adaptive_rounds > 0`` the adaptive
    restart engine runs; otherwise one batched solve from linear init and the
    metric (the ``--parity`` path). ``overrides`` go on top of the planner
    parameters (a small budget for a rehearsal).
    """
    import torch

    from vgpmp_torch import resolve_device
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import card

    device = resolve_device(device)
    ov = {} if use_tuned else {"jitter": 1e-6}
    ov.update(overrides or {})
    sess = PlanningSession(robot, problemset, dtype=torch.float32, sdf_mode=sdf_mode,
                           use_tuned=use_tuned, overrides=ov, device=device)
    starts, goals = sess.queries()
    B = len(starts)
    inits = tuple(sess.planner_params.get("q_mu_inits", ["linear"]))
    K = len(inits)
    adaptive_used, k_effs, by_round = [], [], []

    if K > 1 or adaptive_rounds > 0:
        round_solve = solver.make_round_solver(sess.model, sess.train_config)

        def run_once(run_seed):
            executed = []

            def solve(params, s, g, generator):
                best, rep = round_solve(params, s, g, generator)
                executed.append(rep.executed)  # read after the call: no sync inside a round
                return best, rep

            _, reps, info = solver.solve_adaptive(
                sess.model, sess.train_config, starts, goals, sess.planner_params, inits=inits,
                max_rounds=K + adaptive_rounds, seed=run_seed, solve=solve, round_sizes=(B,))
            adaptive_used.append(info["rounds"] - 1)
            k_effs.append(info["k_eff"])
            by_round.append([int(e.sum()) for e in executed])
            return reps
    else:
        params0 = solver.init_batch(sess.model, starts, goals, sess.planner_params)
        solve_b = solver.make_batch_solver(sess.model, sess.train_config)
        m = sess.model
        sb = torch.as_tensor(starts, dtype=torch.float32, device=device)
        gb = torch.as_tensor(goals, dtype=torch.float32, device=device)

        def run_once(run_seed):
            _, res = solve_b(params0, sb, gb, torch.Generator(device=device).manual_seed(run_seed))
            with torch.no_grad():
                rep = execute_and_validate(m.collision, res.best, sb, gb, m.limits_low, m.limits_high)
            reps = {k: v.cpu().numpy() for k, v in rep._asdict().items()}
            by_round.append([int(reps["executed"].sum())])
            return type(rep)(**reps)

    per_run, per_run_validator, times, failed = [], [], [], []
    for r in range(runs):
        t0 = time.perf_counter()
        reps = run_once(seed + r)
        ex = np.asarray(reps.executed)
        times.append(time.perf_counter() - t0)
        per_run.append(int(ex.sum()))
        per_run_validator.append(int(np.asarray(reps.success).sum()))
        failed.append(np.nonzero(~ex)[0].tolist())

    steady = min(times[1:]) if len(times) > 1 else times[0]
    avg = float(np.mean(per_run))
    out = {
        "robot": robot,
        "problemset": problemset,
        "engine_commit": engine_commit(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "problems": B,
        "restarts": K,
        "adaptive_rounds_used": adaptive_used or None,
        "tuned": use_tuned,
        "budget": {k: sess.planner_params[k]
                   for k in ("num_steps", "num_samples", "num_inducing", "learning_rate")},
        "metric": METRIC,
        "k_eff": round(float(np.mean(k_effs)), 2) if k_effs else 1.0,
        "avg_solved": avg,
        "success_rate": avg / B,
        "per_run_solved": per_run,
        "per_run_validator_solved": per_run_validator,
        "failed_indices_last_run": failed[-1],
        "compile_plus_first_seconds": round(times[0] - steady, 1),
        "steady_batch_seconds": round(steady, 3),
        "solves_per_sec": round(B / steady, 2),
        "card": card(device),
        "sdf_mode": sdf_mode,
        "jitter": sess.model.jitter,
        "executed_by_round": by_round,
    }
    print(f"{robot}/{problemset}: average solved {avg:.1f} / {B} ({100 * avg / B:.1f}%), K={K}, "
          f"batch {out['steady_batch_seconds']}s = {out['solves_per_sec']} solves/s, first run "
          f"+{out['compile_plus_first_seconds']}s, executed by round {by_round}", flush=True)
    return out


def main(argv=None, device=None) -> int:
    """Run the command line ``argv``; ``device`` as :func:`run_combo` takes it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--problemset", default="industrial")
    ap.add_argument("--all", action="store_true", help="run every robot x environment combo")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sdf-mode", default=None, choices=["nearest", "trilinear", "packed"],
                    help="default: 'packed' (kernel K1 on the card) tuned, 'nearest' under --parity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaptive-rounds", type=int, default=0,
                    help="extra restart rounds spent only while problems remain unsolved")
    ap.add_argument("--parity", action="store_true",
                    help="the reference's hyperparameters (no tuned overlay, jitter 1e-6)")
    args = ap.parse_args(argv)

    import torch

    from vgpmp_torch import _build, resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        print(f"kernel build: {_build.build():.1f}s", flush=True)
    sdf_mode = args.sdf_mode or ("nearest" if args.parity else "packed")
    combos = ALL_COMBOS if args.all else [(args.robot, args.problemset)]
    path = ROOT / "chiprun_out" / f"benchmarking_torch{'_parity' if args.parity else ''}.json"
    path.parent.mkdir(exist_ok=True)
    results = []
    for r, p in combos:
        results.append(run_combo(r, p, args.runs, sdf_mode, args.seed, use_tuned=not args.parity,
                                 adaptive_rounds=0 if args.parity else args.adaptive_rounds,
                                 device=device))
        path.write_text(json.dumps(results, indent=1))
    total_b = sum(r["problems"] for r in results)
    total_s = sum(r["avg_solved"] for r in results)
    print(f"TOTAL: {total_s:.1f} / {total_b} ({100 * total_s / total_b:.1f}%) on {results[0]['card']}"
          + (f", peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
             if device.type == "cuda" else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
