#!/usr/bin/env python3
"""Repeat the ``execute_and_validate`` parity comparison in fresh processes.

    JAX_PLATFORMS=cpu python tools/repeat_min_clearance.py --runs 30 [--torch-only]

Not a test (pytest does not collect it): a tool for the rare difference in
``min_clearance`` between the packages that ``ROADMAP.md`` (Queue 3) describes.
Each run builds the inputs of
``tests/test_torch_validator.py::test_execute_and_validate_matches_jax`` in a
new process, puts them through both packages (or, with ``--torch-only``,
through the port alone) and prints the port's ``min_clearance`` per row, the
same values made from their pieces (PD-path configs, sphere centres,
per-sphere clearance: the port's first computation in the process, all
kept), the difference from the JAX value, and a hash of each piece. A run
whose values are not the usual ones saves the pieces to
``build/min_clearance/odd_<pid>.npz``; the first run saves ``usual.npz``
beside them to compare with. The last line tallies the distinct results.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE.parent / "build" / "min_clearance"
# min_clearance of the four finite rows (float64, franka) in almost every process
USUAL = [-0.0286769366378678, -0.07310224283994196, 0.08084870542139219, 0.08280211383137215]


def one(torch_only: bool, save_usual: bool) -> None:
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "tests")]
    import numpy as np
    import torch

    from _torch_support import metric_trajectories, smooth_grid
    from vgpmp_torch import sim
    from vgpmp_torch.engine import validator as tv

    if torch_only:  # the port's half of planner_models, so that JAX is never imported
        from types import SimpleNamespace

        from vgpmp_torch import robots, scene
        from vgpmp_torch.kinematics import dh
        from vgpmp_torch.likelihoods import collision as col
        from vgpmp_torch.sdf import grid as sg

        data = smooth_grid(np.random.default_rng(5), (40, 40, 36), scale=1.0) - np.float32(0.1)
        spec = robots.load_robot("franka")
        sc = scene.Scene(base=sg.SdfGrid.from_arrays(data, np.array([-1.2, -1.2, -0.6]), 0.06, torch.float64),
                         base_offset=torch.as_tensor(np.array([0.1, 0.0, -0.05]))).packed()
        tmodel = SimpleNamespace(
            collision=col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=torch.float64),
                                         scene=sc, epsilon=0.05),
            limits_low=torch.as_tensor(spec.limits_low), limits_high=torch.as_tensor(spec.limits_high))
        lo, hi = spec.limits_low, spec.limits_high
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from _torch_support import planner_models

        jspec, jmodel, tmodel = planner_models()
        lo, hi = jspec.limits_low, jspec.limits_high
    tr = metric_trajectories(np.random.default_rng(0), lo, hi)
    out_of_box = tr["still"].copy()
    out_of_box[:, 6] = np.linspace(hi[6] - 0.5, hi[6] + 0.1, len(out_of_box))
    nan = tr["wiggly"].copy()
    nan[5:] = np.nan
    trajs = np.stack([tr["repeated"], tr["smooth"], tr["still"], out_of_box, nan])
    starts, goals = trajs[:, 0].copy(), trajs[:, -1].copy()
    goals[2, 3] += 0.08
    goals[4] = tr["wiggly"][-1]

    diff = None
    if not torch_only:
        from _torch_support import jax_report_rows
        from vgpmp_tpu.engine import validator as jv

        want = jax_report_rows(
            lambda t, s, g: jv.execute_and_validate(jmodel.collision, t, s, g, jmodel.limits_low,
                                                    jmodel.limits_high), trajs, starts, goals)
    # the port's first computation in the process is the instrumented one: the
    # pieces execute_and_validate's min_clearance is made of, all kept
    from vgpmp_torch.kinematics.dh import sphere_positions

    col_model = tmodel.collision
    outs = sim.pd_path_configs(torch.as_tensor(trajs))
    qs = outs[0]                                                   # [B, G, L]
    centres = sphere_positions(col_model.fk, qs)                   # [B, G, P, 3]
    per_sphere = col_model.scene.distance(centres, mode_override="trilinear") - col_model.fk.sphere_radii
    clear = per_sphere.min(dim=-1).values                          # [B, G]
    first = torch.minimum(clear.amin(dim=1), col_model.min_clearance_eval(torch.as_tensor(trajs[:, 0])))
    got = tv.execute_and_validate(col_model, torch.as_tensor(trajs), torch.as_tensor(starts),
                                  torch.as_tensor(goals), tmodel.limits_low, tmodel.limits_high)
    mine = got.min_clearance.numpy()
    if not torch_only:
        diff = mine - np.asarray(want.min_clearance)

    digest = lambda t: hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()[:8]
    print("RESULT", " ".join(repr(float(v)) for v in mine[:4]),
          "pieces", " ".join(repr(float(v)) for v in first[:4]),
          "diff", "-" if diff is None else " ".join(f"{v:.3e}" for v in diff[:4]),
          "hashes", digest(qs[:4]), digest(centres[:4]), digest(per_sphere[:4]), flush=True)
    arrays = dict(min_clearance=mine, pieces=first.numpy(), qs=qs.numpy(), centres=centres.numpy(),
                  per_sphere=per_sphere.numpy())
    odd = [float(v) for v in mine[:4]] != USUAL or [float(v) for v in first[:4]] != USUAL
    if not odd and not save_usual and (OUT / "usual.npz").exists():  # a piece may move and the minimum not
        with np.load(OUT / "usual.npz") as usual:
            odd = any(not np.array_equal(usual[k], v, equal_nan=True) for k, v in arrays.items())
    if odd or save_usual:
        OUT.mkdir(parents=True, exist_ok=True)
        np.savez(OUT / (f"odd_{os.getpid()}.npz" if odd else "usual.npz"), **arrays)
        print("SAVED", "odd" if odd else "usual", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--torch-only", action="store_true",
                    help="run the port alone, in processes that never import JAX")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save-usual", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.torch_only, args.save_usual)
        return 0
    tally = collections.Counter()
    for i in range(args.runs):
        cmd = [sys.executable, __file__, "--one"] + (["--torch-only"] if args.torch_only else []) \
            + (["--save-usual"] if i == 0 else [])
        res = subprocess.run(cmd, capture_output=True, text=True,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        line = next((ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")), None)
        if line is None:
            print(res.stdout[-2000:], res.stderr[-2000:], file=sys.stderr)
            return 1
        print(i, line, flush=True)
        tally[line] += 1
    print(f"{len(tally)} distinct result(s) in {args.runs} runs: {sorted(tally.values(), reverse=True)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
