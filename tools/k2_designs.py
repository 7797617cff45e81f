#!/usr/bin/env python3
"""Time designs of K2's lone kernels (``k2_chol``, ``k2_trsm``) against each
other in one process on the card.

    python tools/k2_designs.py [NAME=SOURCE.cu ...] [--reps 100]

Each source is a version of ``vgpmp_torch/csrc/k2_linalg.cu``, the float64
instantiation (since the float32 and block designs were added, its kernels
live in ``k2_linalg.cuh`` beside it; with no argument: the checkout's, as
``current``). Every source is compiled with
``nvcc`` for ``sm_90a`` beside a small C shim into a shared library of its own
(seconds a build; the headers come from ``vgpmp_torch/csrc``) and loaded with
``ctypes``. Each case is first checked against the plain versions
(``vgpmp_torch/ops/linalg.py``), then timed in turns (A, B, B, A, ...) with
the 50 MB L2 flushed before every launch: one launch between two CUDA events,
as ``chip_smoke.py`` times the kernels. The cases are the main path's widths
(T = 251 matrices of n = 12: the factorisation, and the solves at k = 1, 12,
50 and 100 columns, lower and transposed) and the widest problemset's
n = 26. Prints one line per case and writes ``chiprun_out/k2_designs.json``.
Needs a CUDA device and ``nvcc``.

To time an earlier design, pass its source, e.g. from git:
``git show <commit>:vgpmp_torch/csrc/k2_linalg.cu > .proof/old/k2_linalg.cu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vgpmp_torch.ops import linalg as la  # noqa: E402
from vgpmp_torch.timing import l2_flush_buffer  # noqa: E402

CSRC = ROOT / "vgpmp_torch" / "csrc"
OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "k2_designs"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

SHIM = r"""
#include "kernels.h"
extern "C" int k2d_chol(const double* A, double* L, long long T, int n, void* st) {
  return (int)k2_chol_launch(A, L, T, n, (cudaStream_t)st);
}
extern "C" int k2d_trsm(const double* L, const double* B, double* X, long long T, int n, int k,
                        int upper_t, void* st) {
  return (int)k2_trsm_launch(L, B, X, T, n, k, upper_t != 0, (cudaStream_t)st);
}
"""

# (kind, T, n, k, upper_t); k is None for the factorisation
CASES = [("chol", 251, 12, None, False), ("chol", 251, 26, None, False)] + [
    ("trsm", 251, n, k, up) for n, ks in ((12, (1, 12, 50, 100)), (26, (1, 100))) for k in ks
    for up in (False, True)]


def build(name: str, source: Path) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    d = BUILD / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "shim.cu").write_text(SHIM)
    lib = d / "libk2.so"
    subprocess.run([nvcc, *FLAGS, f"-I{CSRC}", "-o", str(lib), str(source), str(d / "shim.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.k2d_chol.argtypes = [vp, vp, i64, i32, vp]
    so.k2d_trsm.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
    return so


def launcher(so, case, inputs):
    """A call that launches ``so``'s kernel for ``case`` on fresh outputs."""
    kind, T, n, k, up = case
    st = torch.cuda.current_stream().cuda_stream

    def run():
        if kind == "chol":
            (K,) = inputs
            out = torch.empty_like(K)
            rc = so.k2d_chol(K.data_ptr(), out.data_ptr(), T, n, st)
        else:
            Lf, Bm = inputs
            out = torch.empty_like(Bm)
            rc = so.k2d_trsm(Lf.data_ptr(), Bm.data_ptr(), out.data_ptr(), T, n, k, int(up), st)
        if rc != 0:
            raise RuntimeError(f"launch failed with cudaError {rc} for {case}")
        return out

    return run


def inputs_for(case, gen, dev):
    kind, T, n, k, _ = case
    G = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64)
    K = G @ G.mT + n * torch.eye(n, device=dev, dtype=torch.float64)
    if kind == "chol":
        return (K,), la.cholesky_unrolled(K)
    Lf = la.cholesky_unrolled(K)
    Bm = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64)
    plain = la.solve_upper_T_unrolled if case[4] else la.solve_lower_unrolled
    return (Lf, Bm), plain(Lf, Bm)


def time_turns(runs: dict, reps: int, flush) -> dict:
    """Per design, the CUDA-event times (ms) of ``reps`` launches taken in
    turns A, B, B, A, ... after a warm-up launch each; the L2 flushed before
    every launch."""
    names = list(runs)
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    times = {nm: [] for nm in names}
    for r in range(reps):
        for nm in (names if r % 2 == 0 else names[::-1]):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            runs[nm]()
            e.record()
            e.synchronize()
            times[nm].append(s.elapsed_time(e))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="NAME=PATH of a k2_linalg.cu version")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_designs: no CUDA device", file=sys.stderr)
        return 1
    sources = dict(s.split("=", 1) for s in args.sources) or {"current": str(CSRC / "k2_linalg.cu")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a source, all at once
        futs = {nm: pool.submit(build, nm, Path(p).resolve()) for nm, p in sources.items()}
        libs = {nm: f.result() for nm, f in futs.items()}
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"k2_designs: built {list(sources)} in {build_s:.1f} s on {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = l2_flush_buffer(dev)
    rows = []
    for case in CASES:
        inputs, want = inputs_for(case, gen, dev)
        runs = {nm: launcher(so, case, inputs) for nm, so in libs.items()}
        # float64 on well-conditioned input: 1e-9 of the largest entry
        errs = {nm: ((fn() - want).abs().max() / want.abs().max()).item() for nm, fn in runs.items()}
        assert all(e <= 1e-9 for e in errs.values()), (case, errs)
        times = time_turns(runs, args.reps, flush)
        kind, T, n, k, up = case
        shape = [T, n, n] if kind == "chol" else [T, n, k]
        row = {"kernel": f"k2_{kind}", "shape": shape, "upper_t": up, "max_rel_err": errs,
               "mean_ms": {nm: statistics.fmean(v) for nm, v in times.items()},
               "median_ms": {nm: statistics.median(v) for nm, v in times.items()},
               "min_ms": {nm: min(v) for nm, v in times.items()}}
        rows.append(row)
        print(f"{row['kernel']} {shape}{' upper_t' if up else ''}: "
              + ", ".join(f"{nm} mean {row['mean_ms'][nm]:.4f} median {row['median_ms'][nm]:.4f} "
                          f"min {row['min_ms'][nm]:.4f} ms (err {errs[nm]:.1e})" for nm in libs),
              flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "k2_designs.json").write_text(json.dumps(
        {"card": card, "reps": args.reps, "sources": sources, "build_s": build_s, "cases": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
