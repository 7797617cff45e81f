#!/usr/bin/env python
"""One combo of the tuned matrix through the JAX package's own adaptive engine
on the CPU, for holding the port's card runs (``benchmarking_torch.py``)
against JAX on a float32 platform with exact float32 products.

    JAX_PLATFORMS=cpu python tools/matrix_jax_cpu.py ur10 industrial --seeds 0,1
    JAX_PLATFORMS=cpu python tools/matrix_jax_cpu.py ur10 industrial --round0 --seeds 0,1,2

It runs what ``benchmarking.py`` runs for a tuned combo (float32 session,
``solve_adaptive`` with one bucket of ``B`` slots and ``max_rounds =
len(q_mu_inits) + --adaptive-rounds``), one run per seed, and prints one line
per run: executed of ``B``, the executed slots by round and k_eff.
``--round0`` runs only the first round (``make_round_solver`` from the first
tuned init on every row, the keys split from the seed). A run of a combo
takes minutes on a few cores: it is a tool, not a test.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vgpmp_tpu.engine import solver  # noqa: E402
from vgpmp_tpu.session import PlanningSession  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("robot")
    ap.add_argument("problemset")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--adaptive-rounds", type=int, default=3)
    ap.add_argument("--round0", action="store_true", help="only the first round")
    args = ap.parse_args(argv)

    sess = PlanningSession(args.robot, args.problemset, dtype=jnp.float32)
    starts, goals = sess.queries()
    B = len(starts)
    inits = tuple(sess.planner_params["q_mu_inits"])
    round_solve = solver.make_round_solver(sess.model, sess.train_config)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.round0:
            params = solver.init_slots(sess.model, starts, goals, sess.planner_params, [inits[0]] * B)
            _, rep = round_solve(params, jnp.asarray(starts, jnp.float32), jnp.asarray(goals, jnp.float32),
                                 jax.random.split(jax.random.PRNGKey(seed), B))
            print(f"{args.robot}/{args.problemset} round 0 from {inits[0]}, seed {seed}: executed "
                  f"{int(np.asarray(rep.executed).sum())} of {B}, success {int(np.asarray(rep.success).sum())} "
                  f"({time.time() - t0:.0f} s)", flush=True)
            continue
        by_round = []

        def solve(params, s, g, keys):
            best, rep = round_solve(params, s, g, keys)
            by_round.append(int(np.asarray(rep.executed).sum()))
            return best, rep

        _, reps, info = solver.solve_adaptive(
            sess.model, sess.train_config, starts, goals, sess.planner_params, inits=inits,
            max_rounds=len(inits) + args.adaptive_rounds, seed=seed, solve=solve, round_sizes=(B,))
        print(f"{args.robot}/{args.problemset} seed {seed}: executed {int(np.asarray(reps.executed).sum())} "
              f"of {B}, by round {by_round}, k_eff {info['k_eff']:.2f} ({time.time() - t0:.0f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
