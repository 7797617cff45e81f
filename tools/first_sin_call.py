#!/usr/bin/env python3
"""The first ``torch.sin`` call of a process, against numpy, in fresh processes.

    python tools/first_sin_call.py --runs 200 [--lanes 6]

Not a test (pytest does not collect it), and nothing of the port is imported:
it shows the PyTorch behaviour behind the rare ``min_clearance`` difference
that ``ROADMAP.md`` (Queue 3) describes. Each process takes the sine and
cosine of 35 840 float64 angles in [-3, 3] (the size of the validator test's
FK input; PyTorch's OpenMP pool splits it into eight chunks), twice, and
prints the largest error of each chunk of the first calls against numpy.
In a few processes of a hundred, more when several run side by side, one or
more chunks of the very first call, never the calling thread's, are off by up
to 7e-9 where the rest is exact to 1e-16; the second call is always exact.
The last line tallies the odd processes.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHUNKS = 8


def one() -> None:
    import numpy as np
    import torch

    x = np.random.default_rng(0).uniform(-3, 3, size=(5, 1024, 7))
    t = torch.as_tensor(x)
    first = torch.sin(t).numpy(), torch.cos(t).numpy()     # the first calls of the process
    again = torch.sin(t).numpy(), torch.cos(t).numpy()
    errs = [np.abs(got - ref(x)).reshape(CHUNKS, -1).max(axis=1)
            for got, ref in zip(first, (np.sin, np.cos))]
    errs_again = max(np.abs(got - ref(x)).max() for got, ref in zip(again, (np.sin, np.cos)))
    odd = max(e.max() for e in errs) > 1e-13
    print("ODD" if odd else "ok", "sin", " ".join(f"{v:.1e}" for v in errs[0]),
          "cos", " ".join(f"{v:.1e}" for v in errs[1]), f"again {errs_again:.1e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=6, help="processes side by side")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one()
        return 0

    def run(_):
        return subprocess.run([sys.executable, __file__, "--one"], capture_output=True, text=True,
                              check=True).stdout.strip()

    with ThreadPoolExecutor(args.lanes) as pool:
        lines = list(pool.map(run, range(args.runs)))
    for line in lines:
        if line.startswith("ODD"):
            print(line)
    print(f"{sum(ln.startswith('ODD') for ln in lines)} odd of {len(lines)} processes, {args.lanes} side by side")
    return 0


if __name__ == "__main__":
    sys.exit(main())
