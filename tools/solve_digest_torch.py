#!/usr/bin/env python3
"""Digest of one batched solve on the CUDA device, to show whether two
checkouts of the port solve alike, bit for bit.

    python tools/solve_digest_torch.py [--root PATH]

Runs franka/industrial at the bench's tuned configuration (B = 36, 200
steps): ``make_batch_solver`` from linear init with generator seed 0, and
prints one JSON line with the SHA-256 of the ELBO history's bytes and of the
best trajectories' bytes, the first and last mean ELBO, the solve's seconds
and the card. ``--root`` imports ``vgpmp_torch`` from another checkout, such
as the parent commit unpacked with ``git archive``; each checkout builds its
own kernels. Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose vgpmp_torch is imported")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vgpmp_torch.engine import solver
    from vgpmp_torch.session import PlanningSession

    sess = PlanningSession("franka", "industrial")  # raises without CUDA
    starts, goals = sess.queries()
    params = solver.init_batch(sess.model, starts, goals, sess.planner_params)
    solve = solver.make_batch_solver(sess.model, sess.train_config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    digest = lambda t: hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"root": str(Path(args.root).resolve()), "elbo_sha256": digest(res.elbo_history),
           "best_sha256": digest(res.best), "elbo_first_mean": res.elbo_history[:, 0].mean().item(),
           "elbo_last_mean": res.elbo_history[:, -1].mean().item(), "solve_s": seconds, "card": card}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
