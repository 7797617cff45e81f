#!/usr/bin/env python3
"""Does ``torch.profiler`` see every kernel launch? Counts the kernel records
of repeated profiler windows on the card, before and after a child process
has profiled on the same card.

    python tools/profiler_drops_torch.py [--windows 15] [--reps 20]

Each window launches ``k2_chol`` at [251, 12, 12] ``--reps`` times (the L2
flushed before each, as ``chip_smoke.py``'s device-only phase does) and
``torch.exp`` as a library kernel beside it, and counts the records three
ways: ``key_averages()``, ``events()`` and the raw kineto events. Then a
child process opens a profiler window of its own on the card, and the
``k2_chol`` windows run again, in turns with windows opened with
``acc_events=True`` (which ``torch.profiler`` reads only when one profiler
object is started again; each window here is a new object). Records the
warnings the first window raises. Prints the counts and writes them to
``chiprun_out/profiler_drops.json``. Runs on the CUDA device only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHILD = ("import torch\nfrom torch.profiler import ProfilerActivity, profile\n"
         "a = torch.randn(1000, device='cuda')\n"
         "with profile(activities=[ProfilerActivity.CUDA]):\n"
         "    [torch.exp(a) for _ in range(100)]\n    torch.cuda.synchronize()\n")


def window(fn, name: str, reps: int, flush: torch.Tensor, acc_events: bool = False):
    """``(key_averages, events, kineto)`` counts of ``name``'s device records
    in one window of ``reps`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=acc_events) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ka = sum(e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation and name in e.key)
    ev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name)
    kin = sum(1 for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and name in e.name())
    return ka, ev, kin


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    from vgpmp_torch import _build, resolve_device
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.timing import card, l2_flush_buffer

    dev = resolve_device(None)
    _build.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    G = torch.randn((251, 12, 12), generator=gen, device=dev, dtype=torch.float64)
    K = G @ G.mT + 12 * torch.eye(12, device=dev, dtype=torch.float64)
    a = torch.randn(1000, generator=gen, device=dev)
    flush = l2_flush_buffer(dev)
    chol = lambda acc=False: window(lambda: la.k2_chol(K), "chol_kernel", args.reps, flush, acc)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = chol()
    out = {"card": card(dev), "torch": torch.__version__, "reps": args.reps,
           "first_window_warnings": [str(w.message) for w in caught],
           "k2_chol": [first] + [chol() for _ in range(args.windows - 1)],
           "exp": [window(lambda: torch.exp(a), "exp", args.reps, flush) for _ in range(args.windows)]}
    subprocess.run([sys.executable, "-c", CHILD], check=True)
    plain, acc = [], []
    for _ in range(args.windows):  # in turns, so that both meet the same state
        plain.append(chol())
        acc.append(chol(True))
    out["k2_chol_after_a_profiling_child"] = plain
    out["k2_chol_after_a_profiling_child_acc_events"] = acc
    for k, v in out.items():
        print(k, v, flush=True)
    path = ROOT / "chiprun_out" / "profiler_drops.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
