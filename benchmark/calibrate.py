#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, in one process.

    python benchmark/calibrate.py --workload <name> --seeds 11 12 ... \\
        [--controls tf32 f32_island] [--control-seeds 3] [--out chiprun_out/calibrate.jsonl]

For each seed, the run's model comparison (:mod:`benchmark.harness.check`:
the round solver and its step body against the reference) on the cell's
first pool batch, one JSON line a seed; the window's answers are judged in
the runs themselves. Then the controls, the program put one precision step
below what the configuration states, read by the same comparison on the
first ``--control-seeds`` seeds:

- ``tf32``: float32 products on the tensor cores in TF32
  (``torch.backends.cuda.matmul.allow_tf32``), where the configuration
  states float32 with TF32 off;
- ``f32_island``: the Gram's factor and solves in float32 (the program's
  own ``solve_dtype`` path), where the configuration states float64.

One-card cells only; the benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(system, pb, seed: int) -> dict:
    """The model comparison of the run (:func:`check.model_numbers`) on the
    cell's pool batch 0, its draws from ``seed``."""
    from benchmark.harness import check, traffic

    t = time.perf_counter()
    starts, goals = traffic.batch(system.starts, system.goals, system.rows, 0)
    nums = check.model_numbers(system, pb, starts, goals, seed)
    v, quantiles = nums.pop("_verdicts"), nums.pop("_quantiles")
    return {"seed": seed, **nums, "quantiles": quantiles, "verdict_rows": v["rows"],
            "verdict_mismatch": v["mismatch"], "undecided": v["undecided"], "check_s": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=["tf32", "f32_island"])
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "calibrate.jsonl"))
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import manifest, program
    from benchmark.reference import model as ref

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    cfg = cell["config"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(d):
        print(json.dumps(d), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(d) + "\n")

    system = program.System(cell, "cuda:0")
    system.warm_up()
    pb = ref.Problem.load(ROOT / cfg["assets"], cfg["robot"], cfg["problemset"], system.pp, system.device)
    for s in args.seeds:
        emit({"workload": args.workload, "side": "program", **readings(system, pb, s)})
    for c in args.controls:
        if c == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            ctl = system
        elif c == "f32_island":
            ctl = program.System(cell, "cuda:0", overrides={"solve_dtype": torch.float32})
        else:
            raise SystemExit(f"unknown control {c!r}")
        for s in args.seeds[:args.control_seeds]:
            emit({"workload": args.workload, "side": c, **readings(ctl, pb, s)})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
