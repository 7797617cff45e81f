#!/usr/bin/env python3
"""Time designs of kernel K2 against each other and against ``torch.linalg``
in one process on the card.

    python tools/k2_designs.py [NAME=SOURCE ...] [--reps 30]

Each SOURCE is a version of ``vgpmp_torch/csrc/k2_linalg.cuh`` (its four
entries, ``k2_chol``, ``k2_trsm``, the fused pair ``k2_factor_solve`` and its
backward, instantiated in float64 and float32 beside a small C shim) or of
``vgpmp_torch/csrc/k2_linalg.cu`` from before the header existed (float64
only). With no argument: the checkout's header, as ``current``. Every source
is compiled with ``nvcc`` for ``sm_90a`` into a shared library of its own, all
at once (seconds a build; the headers it includes come from its own
directory first, then from ``vgpmp_torch/csrc``) and loaded with ``ctypes``.

The cases: T = 252 matrices at n = 33, 40, 64, 100 and 128 (the block
design's sizes: 33 and 100 have ragged last panels), the factorisation and,
at k = 1, 71 and 100 columns, both solves (lower and transposed), the fused
pair and its backward, in float64 and float32; and the warp design's n = 12 and 26
(the factorisation and the solves at k = 1 and 100, float64), to show it
unchanged. Each case is first checked against the plain versions
(``vgpmp_torch/ops/linalg.py``; relative to the largest entry: 1e-9 in
float64, gradients 1e-8; 1e-4 in float32), then timed in turns (A, B, C,
C, B, A, ...) with the 50 MB L2 flushed before every launch, one launch
between two CUDA events, beside the library call that computes the same
function (``torch.linalg.cholesky``; ``solve_triangular``; both for the pair;
the backward has none) and the bound (the lower triangle of each triangular
input and every other input read once, each output written once, at 3.35
TB/s, or the operations at the float64 matrix unit's or float32's 67
TFLOP/s, whichever is longer). Prints one line per case and writes
``chiprun_out/k2_designs.json``. Needs a CUDA device and ``nvcc``.

To time an earlier design, pass its source, e.g. from git:
``git show <commit>:vgpmp_torch/csrc/k2_linalg.cuh > .proof/old/k2_linalg.cuh``.
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
from vgpmp_torch.timing import card, l2_flush_buffer  # noqa: E402

CSRC = ROOT / "vgpmp_torch" / "csrc"
OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "k2_designs"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
HBM_BYTES_PER_S = 3.35e12
# NVIDIA's H100 SXM data sheet: float64 on the tensor cores, float32 outside them
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
T = 252

SHIM = r"""
#include "kernels.h"
#define K2D_ENTRIES(S, tag)                                                                        \
  extern "C" int k2d_chol_##tag(const S* A, S* L, long long T, int n, void* st) {                \
    return (int)k2_chol_launch<S>(A, L, T, n, (cudaStream_t)st);                                  \
  }                                                                                              \
  extern "C" int k2d_trsm_##tag(const S* L, const S* B, S* X, long long T, int n, int k, int up,  \
                                void* st) {                                                      \
    return (int)k2_trsm_launch<S>(L, B, X, T, n, k, up != 0, (cudaStream_t)st);                  \
  }                                                                                              \
  extern "C" int k2d_pair_##tag(const S* K, const S* B, S* L, S* X, long long T, int n, int k,    \
                                void* st) {                                                      \
    return (int)k2_factor_solve_launch<S>(K, B, L, X, T, n, k, (cudaStream_t)st);                \
  }                                                                                              \
  extern "C" int k2d_bwd_##tag(const S* L, const S* X, const S* gL, const S* gX, S* gK, S* gB,    \
                               long long T, int n, int k, void* st) {                            \
    return (int)k2_factor_solve_bwd_launch<S>(L, X, gL, gX, gK, gB, T, n, k, (cudaStream_t)st);  \
  }
K2D_ENTRIES(double, f64)
#ifdef K2D_HEADER
K2D_ENTRIES(float, f32)
#endif
"""

TAGS = {torch.float64: "f64", torch.float32: "f32"}


def build(name: str, source: Path) -> tuple:
    """``name``'s library and the dtypes it takes."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    d = BUILD / name
    d.mkdir(parents=True, exist_ok=True)
    header = source.suffix == ".cuh"
    shim = d / "shim.cu"
    if header:  # the shim includes the version and instantiates it in both types
        shim.write_text(f'#include "{source}"\nK2_INSTANTIATE(double)\nK2_INSTANTIATE(float)\n'
                        "#define K2D_HEADER\n" + SHIM)
        srcs = [str(shim)]
    else:
        shim.write_text(SHIM)
        srcs = [str(source), str(shim)]
    lib = d / "libk2.so"
    res = subprocess.run([nvcc, *FLAGS, f"-I{source.parent}", f"-I{CSRC}", "-o", str(lib), *srcs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"k2_designs: nvcc failed on {source}:\n{res.stderr}")
    so = ctypes.CDLL(str(lib))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dtypes = (torch.float64, torch.float32) if header else (torch.float64,)
    for tag in (TAGS[dt] for dt in dtypes):
        getattr(so, f"k2d_chol_{tag}").argtypes = [vp, vp, i64, i32, vp]
        getattr(so, f"k2d_trsm_{tag}").argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
        getattr(so, f"k2d_pair_{tag}").argtypes = [vp, vp, vp, vp, i64, i32, i32, vp]
        getattr(so, f"k2d_bwd_{tag}").argtypes = [vp, vp, vp, vp, vp, vp, i64, i32, i32, vp]
    return so, dtypes


def cases():
    """(entry, dtype, n, k, upper_t); k is None for the factorisation."""
    out = []
    for dt in (torch.float64, torch.float32):
        for n in (33, 40, 64, 100, 128):
            out.append(("chol", dt, n, None, False))
            for k in (1, 71, 100):
                out += [("trsm", dt, n, k, False), ("trsm", dt, n, k, True), ("pair", dt, n, k, False),
                        ("bwd", dt, n, k, False)]
    for n in (12, 26):  # the warp design
        out.append(("chol", torch.float64, n, None, False))
        out += [("trsm", torch.float64, n, k, up) for k in (1, 100) for up in (False, True)]
    return out


def inputs_for(case, gen, dev):
    """The case's inputs and its plain versions' outputs."""
    entry, dt, n, k, up = case
    G = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64)
    K = (G @ G.mT + n * torch.eye(n, device=dev, dtype=torch.float64)).to(dt)
    L = la.cholesky_unrolled(K)
    if entry == "chol":
        return (K,), (L,)
    Bm = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64).to(dt)
    if entry == "trsm":
        return (L, Bm), ((la.solve_upper_T_unrolled if up else la.solve_lower_unrolled)(L, Bm),)
    if entry == "pair":
        return (K, Bm), la.factor_solve_plain(K, Bm)
    X = la.solve_lower_unrolled(L, Bm)
    gL = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64).to(dt)
    return (L, X, gL, Bm), la.factor_solve_bwd_plain(L, X, gL, Bm)


def launcher(so, case, inputs):
    """A call that launches ``so``'s kernel for ``case`` on fresh outputs."""
    entry, dt, n, k, up = case
    fn = getattr(so, f"k2d_{entry}_{TAGS[dt]}")
    st = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr()

    def run():
        if entry == "chol":
            (K,) = inputs
            outs = (torch.empty_like(K),)
            rc = fn(p(K), p(outs[0]), T, n, st)
        elif entry == "trsm":
            L, Bm = inputs
            outs = (torch.empty_like(Bm),)
            rc = fn(p(L), p(Bm), p(outs[0]), T, n, k, int(up), st)
        elif entry == "pair":
            K, Bm = inputs
            outs = (torch.empty_like(K), torch.empty_like(Bm))
            rc = fn(p(K), p(Bm), p(outs[0]), p(outs[1]), T, n, k, st)
        else:
            L, X, gL, gX = inputs
            outs = (torch.empty_like(L), torch.empty_like(X))
            rc = fn(p(L), p(X), p(gL), p(gX), p(outs[0]), p(outs[1]), T, n, k, st)
        if rc != 0:
            raise RuntimeError(f"launch failed with cudaError {rc} for {case}")
        return outs

    return run


def library(case, inputs):
    """One ``torch.linalg`` call (two for the pair) computing the case's
    function, or None."""
    entry, _, _, _, up = case
    if entry == "chol":
        return lambda: torch.linalg.cholesky(inputs[0])
    if entry == "trsm":
        L, Bm = inputs
        if up:
            return lambda: torch.linalg.solve_triangular(L.mT, Bm, upper=True)
        return lambda: torch.linalg.solve_triangular(L, Bm, upper=False)
    if entry == "pair":
        K, Bm = inputs

        def pair():
            Ll = torch.linalg.cholesky(K)
            return Ll, torch.linalg.solve_triangular(Ll, Bm, upper=False)

        return pair
    return None


def bound(case):
    """(ms, "bytes" or "operations"): what the entry must move
    (``la.k2_work``: triangular inputs read as their lower triangles, each
    output written once) at the memory rate, or its operations at the
    dtype's peak."""
    entry, dt, n, k, _ = case
    values, ops = la.k2_work(entry, n, k or 0)
    t_bytes = T * values * (torch.finfo(dt).bits // 8) / HBM_BYTES_PER_S
    t_ops = T * ops / PEAK_FLOPS[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_turns(runs: dict, reps: int, flush) -> dict:
    """Per name, the CUDA-event times (ms) of ``reps`` launches taken in
    turns A, B, C, C, B, A, ... after a warm-up launch each; the L2 flushed
    before every launch."""
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
    ap.add_argument("sources", nargs="*", help="NAME=PATH of a k2_linalg.cuh (or older .cu) version")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_designs: no CUDA device", file=sys.stderr)
        return 1
    sources = dict(s.split("=", 1) for s in args.sources) or {"current": str(CSRC / "k2_linalg.cuh")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a source, all at once
        futs = {nm: pool.submit(build, nm, Path(p).resolve()) for nm, p in sources.items()}
        libs = {nm: f.result() for nm, f in futs.items()}
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    smi = card(dev)
    print(f"k2_designs: built {list(sources)} in {build_s:.1f} s on {smi}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = l2_flush_buffer(dev)
    rows = []
    for case in cases():
        entry, dt, n, k, up = case
        inputs, want = inputs_for(case, gen, dev)
        runs = {nm: launcher(so, case, inputs) for nm, (so, dts) in libs.items() if dt in dts}
        tol = (1e-8 if entry == "bwd" else 1e-9) if dt == torch.float64 else 1e-4
        errs = {}
        for nm, fn in runs.items():
            got = fn()
            errs[nm] = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
        assert all(e <= tol for e in errs.values()), (case, errs)
        lib = library(case, inputs)
        if lib is not None:
            runs["library"] = lib
        times = time_turns(runs, args.reps, flush)
        b_ms, b_by = bound(case)
        row = {"entry": entry, "dtype": str(dt).removeprefix("torch."), "shape": [T, n, k or n],
               "upper_t": up, "max_rel_err": errs, "bound_ms": b_ms, "bound_by": b_by,
               "mean_ms": {nm: statistics.fmean(v) for nm, v in times.items()},
               "median_ms": {nm: statistics.median(v) for nm, v in times.items()},
               "min_ms": {nm: min(v) for nm, v in times.items()}}
        rows.append(row)
        print(f"{entry} {row['dtype']} {row['shape']}{' upper_t' if up else ''} (bound {b_ms:.4f} {b_by}): "
              + ", ".join(f"{nm} {row['mean_ms'][nm]:.4f} / {row['median_ms'][nm]:.4f}" for nm in runs)
              + " ms (mean / median)", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "k2_designs.json").write_text(json.dumps(
        {"card": smi, "reps": args.reps, "T": T, "sources": sources, "build_s": build_s, "cases": rows},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
