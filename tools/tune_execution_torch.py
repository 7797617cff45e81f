#!/usr/bin/env python
"""Tune overlays against the physical execution metric, on the PyTorch port
(the port's ``tools/tune_execution.py``).

For each candidate (epsilon, sigma_anneal) setting, one K-member ensemble run
with ``keep_member_reports`` (``make_ensemble_solver``) measures the executed
success of every restart init alone and of their union, so that the best
small init subset is chosen on the host without re-running
(:func:`greedy_subsets`). Problems that no restart solves get a diagnostic
line: the endpoint clearance and the best member's worst clearance, which
separate "needs more restarts" from "needs a different objective".

Each chunk of inits draws from a generator seeded ``seed * 1000 + offset``.
Results go to ``chiprun_out/tune_exec_<robot>_<env>.json`` (or
``--json-out``). Runs on the CUDA device unless ``--device cpu``:

    python tools/tune_execution_torch.py --robot franka --env industrial \\
        --epsilon 0.05 0.08 --sigma-anneal 1 10
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT_INITS = [
    "linear", "zeros", "waypoint",
    "rand0", "rand1", "rand2",
    "frand0", "frand1", "frand2", "frand3", "frand4", "frand5",
]


def greedy_subsets(executed_kb: np.ndarray, inits: list) -> list:
    """Greedy forward selection of inits by marginal union-executed gain."""
    K, B = executed_kb.shape
    chosen, covered, out = [], np.zeros(B, bool), []
    for _ in range(K):
        gains = [
            (np.sum(covered | executed_kb[k]), k)
            for k in range(K) if k not in chosen
        ]
        best_gain, k = max(gains)
        if best_gain == covered.sum() and chosen:
            break
        chosen.append(k)
        covered |= executed_kb[k]
        out.append((inits[k], int(covered.sum())))
    return out


def run_config(robot, env, inits, overrides, seed, chunk=1, device=None):
    """One setting: ``(session, executed [K, B], members' worst clearance
    [K, B], endpoint clearance [B], seconds)``."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.session import PlanningSession

    sess = PlanningSession(robot, env, dtype=torch.float32, use_tuned=True, overrides=overrides,
                           device=device)
    starts, goals = sess.queries()
    solve = solver.make_ensemble_solver(sess.model, sess.train_config, keep_member_reports=True)
    executed, stuck_clear = [], []
    t0 = time.perf_counter()
    for off in range(0, len(inits), chunk):
        ch = tuple(inits[off: off + chunk])
        params = solver.init_ensemble(sess.model, starts, goals, sess.planner_params, inits=ch)
        gen = torch.Generator(device=sess.device).manual_seed(seed * 1000 + off)
        _, _, _, reps_kb = solve(params, starts, goals, gen)
        executed.append(reps_kb.executed.cpu().numpy())
        stuck_clear.append(reps_kb.min_clearance.cpu().numpy())
    executed = np.concatenate(executed, 0)  # [K, B]
    mc = np.concatenate(stuck_clear, 0)
    elapsed = time.perf_counter() - t0

    col = sess.model.collision
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=sess.device)
    with torch.no_grad():
        end_clear = torch.minimum(col.sphere_clearance(as_t(starts)).min(dim=-1).values,
                                  col.sphere_clearance(as_t(goals)).min(dim=-1).values)
    return sess, executed, mc, end_clear.cpu().numpy(), elapsed


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--env", default="industrial")
    ap.add_argument("--epsilon", type=float, nargs="*", default=[None],
                    help="hinge epsilon candidates (default: problemset value)")
    ap.add_argument("--sigma-anneal", type=float, nargs="*", default=[None])
    ap.add_argument("--inits", nargs="*", default=DEFAULT_INITS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", dest="sets", nargs="*", default=[], metavar="KEY=JSONVAL",
                    help="extra planner-param overrides applied to every candidate, "
                    "e.g. --set randomize_timesteps=true")
    ap.add_argument("--chunk", type=int, default=1, help="restarts per ensemble solve")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json-out", default=None,
                    help="default: chiprun_out/tune_exec_<robot>_<env>.json")
    args = ap.parse_args(argv)

    base_overrides = {}
    for kv in args.sets:
        k, _, v = kv.partition("=")
        base_overrides[k] = json.loads(v)

    results = []
    for eps, sa in itertools.product(args.epsilon, args.sigma_anneal):
        overrides = dict(base_overrides)
        if eps is not None:
            overrides["epsilon"] = eps
        if sa is not None:
            overrides["sigma_anneal"] = sa
        sess, executed, mc, end_clear, elapsed = run_config(
            args.robot, args.env, args.inits, overrides, args.seed, chunk=args.chunk,
            device=args.device)
        union = executed.any(0)
        per_init = {name: float(executed[k].mean()) for k, name in enumerate(args.inits)}
        row = {
            "overrides": overrides,
            "union_executed": float(union.mean()),
            "per_init_executed": per_init,
            "greedy_subset": greedy_subsets(executed, args.inits),
            "unsolved": np.nonzero(~union)[0].tolist(),
            "seconds": elapsed,
            "device": str(sess.device),
        }
        print(json.dumps(row), flush=True)
        for b in np.nonzero(~union)[0]:
            print(f"  problem {b}: end_clear {end_clear[b]:+.4f}, best member "
                  f"min_clear {mc[:, b].max():+.4f}", flush=True)
        results.append(row)

    results.sort(key=lambda r: -r["union_executed"])
    out = Path(args.json_out or ROOT / "chiprun_out" / f"tune_exec_{args.robot}_{args.env}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print("BEST:", json.dumps(results[0]))
    return results


if __name__ == "__main__":
    main()
