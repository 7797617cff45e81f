#!/usr/bin/env python3
"""Benchmark driver of the PyTorch/CUDA port: adaptive solves/s on one card
and the success rate of the same program (counterpart of ``bench.py``).

    python3 bench_torch.py [--batch 128] [--adaptive-rounds 2]

Prints ONE JSON line on stdout with ``bench.py``'s keys plus ``card`` (the
card's name and power limit as ``nvidia-smi`` gives them, or ``"cpu"``);
progress goes to stderr.

Workload: franka/industrial with its tuned schedule and inits (round 0 from
``frand5``), run by the adaptive restart engine
(``vgpmp_torch.engine.solver.solve_adaptive``) with
``max_rounds = len(inits) + --adaptive-rounds``:

- the real 36-problem set twice (seeds 0 and 1, one bucket of 36 slots);
- ``--batch`` rows replicating the set twice (seeds 2 and 3, buckets
  ``B, max(16, B // 4), max(16, B // 8)``): the headline ``value``.

The first call of each phase is the warm-up; the second is timed as the
steady figure. The kernels are built before the first call. Unlike
``bench.py`` there is no batch-size fallback: a failure at ``--batch`` raises
and exits non-zero. The real-set result is written to
``chiprun_out/bench_torch_partial.json`` before the batch phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FALLBACK_REFERENCE_SOLVES_PER_SEC = 1.0 / 30.0  # documented estimate (BASELINE.md)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def reference_baseline() -> dict:
    """The reference's measured solves/s (``BASELINE_MEASURED.json``), else
    the documented estimate."""
    path = ROOT / "BASELINE_MEASURED.json"
    if path.exists():
        d = json.loads(path.read_text())
        v = d.get("reference_solves_per_sec")
        if v:
            return {"solves_per_sec": float(v), "kind": "measured (tools/baseline_tf_retime.py)",
                    "cpu_count": d.get("cpu_count")}
    return {"solves_per_sec": FALLBACK_REFERENCE_SOLVES_PER_SEC, "kind": "documented estimate",
            "cpu_count": None}


def run(device=None, overrides=None, batch: int = 128, adaptive_rounds: int = 2,
        seeds=(0, 1, 2, 3)) -> dict:
    """Run both phases and print the result line; returns it as a dict.

    ``device=None`` runs on CUDA and raises without it; ``"cpu"`` runs the
    plain path. ``overrides`` go onto the problemset's tuned parameters (a
    small budget for a rehearsal, or ``q_mu_inits``). ``seeds``: the real
    set's warm-up and steady runs, then the batch's.
    """
    import torch

    from vgpmp_torch import _build, resolve_device
    from vgpmp_torch.engine import solver
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import card

    device = resolve_device(device)
    if device.type == "cuda":
        log(f"kernel build: {_build.build():.1f}s")
        torch.cuda.reset_peak_memory_stats()
    sess = PlanningSession("franka", "industrial", dtype=torch.float32, overrides=dict(overrides or {}),
                           device=device)
    starts, goals = sess.queries()
    Q = len(starts)
    inits = tuple(sess.planner_params.get("q_mu_inits", ["linear", "zeros"]))
    max_rounds = len(inits) + adaptive_rounds
    solve = solver.make_round_solver(sess.model, sess.train_config)

    def adaptive(s, g, seed, round_sizes):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, reps, info = solver.solve_adaptive(
            sess.model, sess.train_config, s, g, sess.planner_params, inits=inits,
            max_rounds=max_rounds, seed=seed, solve=solve, round_sizes=round_sizes)
        dt = time.perf_counter() - t0
        log(f"  seed {seed}, B={len(s)}: {info['rounds']} rounds, {info['spent']} restarts in {dt:.2f}s")
        return dt, float(np.mean(reps.executed)), float(np.mean(reps.success)), info

    # the real problemset, one bucket of Q slots
    t_first, _, _, _ = adaptive(starts, goals, seeds[0], (Q,))
    log(f"real set first call in {t_first:.1f}s")
    steady_real, success, validator_success, info = adaptive(starts, goals, seeds[1], (Q,))
    log(f"real set: {success:.4f} executed ({validator_success:.4f} validator) in {steady_real:.2f}s, "
        f"k_eff {info['k_eff']:.2f}")

    baseline = reference_baseline()
    cfg, model = sess.train_config, sess.model

    def pack(value_bs, steady, succ, val_succ, k_eff, rows):
        return {
            "metric": "batched_planner_solves_per_sec_per_chip",
            "value": round(value_bs, 3),
            "unit": "solves/s",
            "vs_baseline": round(value_bs / baseline["solves_per_sec"], 1),
            "baseline_kind": baseline["kind"],
            "baseline_cpu_count": baseline["cpu_count"],
            "success_rate": round(succ, 4),
            "success_metric": "execution (contact-blocking PD + endpoints, tapered phantom floor "
                              "r=0.5, trilinear clearance, undersampling guard)",
            "validator_success_rate": round(val_succ, 4),
            "adaptive": {"inits": list(inits), "max_rounds": max_rounds, "k_eff": round(k_eff, 2)},
            "throughput_batch": rows,
            "steady_batch_seconds": round(steady, 3),
            "real_problemset_seconds": round(steady_real, 3),
            "real_problemset_success": round(success, 4),
            "compile_plus_first_seconds": round(t_first, 1),
            "budget": f"{cfg.num_steps} steps, S={model.num_samples}, B_rff={model.num_bases}, "
                      f"M={model.num_inducing} per restart, franka industrial, tuned schedule, "
                      "adaptive restarts",
            "note": "throughput and success are the SAME adaptive program "
                    "(solves/s includes all restart rounds)",
            "card": card(device),
        }

    result = pack(Q / steady_real, steady_real, success, validator_success, info["k_eff"], Q)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_torch_partial.json").write_text(json.dumps(result))

    # the replicated batch: tail rounds re-attack a handful of rows in a
    # bucket down to B // 8
    idx = np.arange(batch) % Q
    sB, gB = starts[idx], goals[idx]
    rs = (batch, max(16, batch // 4), max(16, batch // 8))
    t_warm, _, _, _ = adaptive(sB, gB, seeds[2], rs)
    steady, succ_b, val_b, info_b = adaptive(sB, gB, seeds[3], rs)
    result = pack(batch / steady, steady, succ_b, val_b, info_b["k_eff"], batch)
    result["saturated_warm_seconds"] = round(t_warm, 1)
    log(f"saturated: B={batch} in {steady:.2f}s = {batch / steady:.2f} solves/s at {succ_b:.4f} "
        f"executed, k_eff {info_b['k_eff']:.2f}")
    if device.type == "cuda":
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128, help="replicated rows of the saturated phase")
    ap.add_argument("--adaptive-rounds", type=int, default=2,
                    help="extra restart rounds beyond the configured inits")
    args = ap.parse_args()
    run(batch=args.batch, adaptive_rounds=args.adaptive_rounds)


if __name__ == "__main__":
    main()
