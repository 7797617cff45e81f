#!/usr/bin/env python3
"""Time designs of kernel K6 against each other in one process on the card.

    python tools/k6_designs.py [NAME=SOURCE ...] [--variant NAME:CONST=VALUE,...] [--reps 20]

Each SOURCE is a version of ``vgpmp_torch/csrc/k6_rff.cuh``; the headers it
includes (``kernels.h``, ``launch.cuh``) come from its own directory first,
then from ``vgpmp_torch/csrc``. A ``--variant`` is the checkout's header
with the named ``constexpr int`` constants of ``namespace k6`` changed (e.g.
``bt2:BT=2`` or ``fwd256:FWD_THREADS=256``), written under
``build/k6_designs/NAME/``. With neither: the checkout's header, as
``current``, which always comes first. Every version is compiled with
``nvcc`` for ``sm_90a`` beside a small C shim (``k1_designs.py:compile_shim``;
float32 and float64 in one library), all at once, and loaded with
``ctypes``.

The cases: wam's and franka's round-0 shapes (``chip_smoke.py:K6_SHAPES``,
inputs from ``chip_smoke.py:k6_inputs``: the inducing inputs and the grid in
one launch, as the draw makes it), float32, and wam's in float64. Each
version's forward and backward are first checked against the plain chain
in float64 with autograd (2e-5 of the largest magnitude in float32, 1e-12
in float64) and against the first version's bits; then the forward launch
and the backward launch are each timed in turns (``k2_designs.py:time_turns``:
A, B, B, A, ...) with the 50 MB L2 flushed before every launch, beside the
bound (``chip_smoke.py:k6_bound``). Prints one line per case and entry with
each version's mean, median and standard deviation and its share of the
bound, and writes ``chiprun_out/k6_designs.json``. Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
from k1_designs import compile_shim  # noqa: E402
from k2_designs import time_turns  # noqa: E402
from vgpmp_torch.timing import card, l2_flush_buffer  # noqa: E402

CSRC = ROOT / "vgpmp_torch" / "csrc"
OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "k6_designs"
CASES = {"wam": ("wam", torch.float32), "franka": ("franka", torch.float32),
         "wam float64": ("wam", torch.float64)}

SHIM = r"""
#include "k6_rff.cuh"
// dims: R, L, A, nb, ns; flags [A] or null
#define K6D(S, tag)                                                                               \
  extern "C" int k6d_fwd_##tag(const S* x, const S* om, const S* ph, const S* sc, const S* w,    \
                               const unsigned char* fl, const long long* d, S* out, void* st) {  \
    const K6Args<S> a{x, om, ph, sc, w, fl, d[0], (int)d[1], (int)d[2], (int)d[3], (int)d[4]};   \
    return (int)k6_rff_launch<S>(a, out, (cudaStream_t)st);                                      \
  }                                                                                              \
  extern "C" int k6d_bwd_##tag(const S* x, const S* om, const S* ph, const S* sc, const S* w,    \
                               const unsigned char* fl, const long long* d, const S* g,          \
                               S* d_om, S* d_sc, S* d_x, int n_dx, void* st) {                   \
    const K6Args<S> a{x, om, ph, sc, w, fl, d[0], (int)d[1], (int)d[2], (int)d[3], (int)d[4]};   \
    return (int)k6_rff_bwd_launch<S>(a, g, d_om, d_sc, d_x, n_dx, (cudaStream_t)st);             \
  }
K6D(float, f32)
K6D(double, f64)
"""


def variant(name: str, spec: str) -> Path:
    """The checkout's header with ``spec``'s constants (``A=1,B=2``) changed."""
    src = (CSRC / "k6_rff.cuh").read_text()
    for item in spec.split(","):
        const, value = item.split("=")
        src, n = re.subn(rf"(constexpr int {const} = )[^;]+;", rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"{name}: no constant {const} in k6_rff.cuh")
    path = BUILD / name / "k6_rff.cuh"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def build_one(name: str, source: Path):
    so = compile_shim(BUILD / name, source, "k6", SHIM)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for tag in ("f32", "f64"):
        getattr(so, f"k6d_fwd_{tag}").argtypes = [vp] * 9
        getattr(so, f"k6d_bwd_{tag}").argtypes = [vp] * 11 + [i32, vp]
    return so


def launchers(so, t):
    """The forward and the backward launch of ``so`` on ``k6_inputs``' tensors
    ``t``, as ``ops.rff.prior_paths`` hands them to the extension, into
    outputs made once: ``(fwd, bwd, outputs)``; the inputs live as long as
    the launchers."""
    B, L, Mc = t["x"].shape
    N, nb, S = t["x_const"].shape[-1], t["omega"].shape[-1], t["w"].shape[1]
    P, A = B * L, Mc + N
    x = torch.cat([t["x"], t["x_const"].expand(B, L, N)], dim=-1).reshape(P, A).contiguous()
    ins = [x, t["omega"].reshape(P, nb).contiguous(), t["phase"].reshape(P, nb).contiguous(),
           t["scale"].reshape(P).contiguous(), t["w"].contiguous()]
    dims = torch.tensor([B, L, A, nb, S], dtype=torch.int64)
    g = t["g"].contiguous()
    out = torch.empty(B, S, L, A, dtype=x.dtype, device=x.device)
    d_om, d_sc, d_x = torch.empty_like(ins[1]), torch.empty_like(ins[3]), torch.empty(P, Mc, dtype=x.dtype,
                                                                                        device=x.device)
    tag = "f32" if x.dtype == torch.float32 else "f64"
    fwd_fn, bwd_fn = getattr(so, f"k6d_fwd_{tag}"), getattr(so, f"k6d_bwd_{tag}")
    held = (ins, dims, g)  # alive as long as the launchers are
    ptrs = [v.data_ptr() for v in ins] + [None, dims.data_ptr()]

    def fwd():
        assert held
        rc = fwd_fn(*ptrs, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"k6 forward launch failed: {rc}")

    def bwd():
        rc = bwd_fn(*ptrs, g.data_ptr(), d_om.data_ptr(), d_sc.data_ptr(), d_x.data_ptr(), Mc,
                    torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"k6 backward launch failed: {rc}")

    return fwd, bwd, (out, d_om, d_sc, d_x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="NAME=PATH of a k6_rff.cuh version")
    ap.add_argument("--variant", action="append", default=[], help="NAME:CONST=VALUE,...")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_designs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {"current": CSRC / "k6_rff.cuh"}
    sources.update({nm: Path(p) for nm, p in (s.split("=", 1) for s in args.sources)})
    sources.update({nm: variant(nm, spec) for nm, spec in (v.split(":", 1) for v in args.variant)})
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: build_one(kv[0], Path(kv[1]).resolve()), sources.items())))
    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    records = []
    for case in args.cases:
        robot, dtype = CASES[case]
        t = chip_smoke.k6_inputs(torch, robot, dev, [1.0, 1.0, 1.0, 0.4, 1.0, 1.0, 1.0], 0.25, dtype=dtype)
        paths, d_x, d_om, d_sc = chip_smoke.k6_reference(torch, t)
        B, L, _ = t["x"].shape
        want = [paths, d_om.reshape(B * L, -1), d_sc.reshape(-1), d_x.reshape(B * L, -1)]
        tol = 2e-5 if dtype == torch.float32 else 1e-12
        runs, first, rec = {}, None, {"case": case, "shape": list(chip_smoke.K6_SHAPES[robot]), "versions": {}}
        for nm, so in libs.items():
            fwd, bwd, outs = launchers(so, t)
            fwd()
            bwd()
            torch.cuda.synchronize()
            errs = [((o.double() - w).abs().max() / w.abs().max()).item() for o, w in zip(outs, want)]
            same = first is None or all(torch.equal(o, f) for o, f in zip(outs, first))
            first = first or [o.clone() for o in outs]
            rec["versions"][nm] = {"errors": errs, "bit_equal_to_first": same}
            if max(errs) > tol:
                raise AssertionError(f"{case}, {nm}: errors {errs} above {tol}")
            runs[f"{nm} fwd"], runs[f"{nm} bwd"] = fwd, bwd
        bound = {"fwd": chip_smoke.k6_bound(robot), "bwd": chip_smoke.k6_bound(robot, True) - chip_smoke.k6_bound(robot)}
        if dtype == torch.float64:
            bound = {k: v * chip_smoke.F32_FLOPS / chip_smoke.F64_FLOPS for k, v in bound.items()}
        for entry in ("fwd", "bwd"):
            times = time_turns({nm: runs[f"{nm} {entry}"] for nm in libs}, args.reps, flush)
            for nm, ts in times.items():
                mean = statistics.mean(ts)
                rec["versions"][nm][entry] = {"mean_ms": mean, "median_ms": statistics.median(ts),
                                              "std_ms": statistics.pstdev(ts), "bound_ms": bound[entry],
                                              "bound_share": bound[entry] / mean}
            print(f"{case} {entry}: " + "; ".join(
                f"{nm} {v[entry]['mean_ms']:.4f} ms (median {v[entry]['median_ms']:.4f}, sd {v[entry]['std_ms']:.4f}, "
                f"{100 * v[entry]['bound_share']:.1f} % of {bound[entry]:.4f}){'' if v['bit_equal_to_first'] else ' [bits differ]'}"
                for nm, v in rec["versions"].items()), flush=True)
        records.append(rec)
        del t, want, runs
    OUT.mkdir(exist_ok=True)
    (OUT / "k6_designs.json").write_text(json.dumps({"card": card(dev), "records": records}, indent=1))
    print(card(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
