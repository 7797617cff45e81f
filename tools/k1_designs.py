#!/usr/bin/env python3
"""Time designs of kernel K1 against each other in one process on the card.

    python tools/k1_designs.py [NAME=SOURCE ...] [--reps 30]

Each SOURCE is a version of ``vgpmp_torch/csrc/k1_collision.cuh``; the
headers it includes (``scene.cuh``, ``fk.cuh``, ``kernels.h``,
``launch.cuh``) come from its own directory first, then from
``vgpmp_torch/csrc``. With no argument: the checkout's header, as
``current``. Every version is compiled with ``nvcc`` for ``sm_90a`` beside a
small C shim, one shared library for each (scalar type, lookup mode) it is
timed in, all at once, and loaded with ``ctypes``.

The cases, franka/industrial at ``chip_smoke.py:k1_inputs``' 36 000 configs
x 37 spheres, σ per row: every instantiation of the template, the base
packed lookup (the main path), nearest and trilinear, each also composed on
``chip_smoke.py:OBJECTS``' scene, in float32 and float64; each forward only,
with d/dq, and (packed and nearest) with h² beside d/dq. Each case is first checked against
``vgpmp_torch.likelihoods.collision.log_prob_plain`` for every version
(``chip_smoke.py:k1_agreement``'s tolerances; h² against the plain hinge
squared), then timed in turns (``k2_designs.py:time_turns``: A, B, B, A,
...) with the 50 MB L2 flushed before every launch, one launch between two
CUDA events, beside its bound
(``chip_smoke.py:k1_bound``: the distinct sectors this run's lookups need,
in nearest mode with d/dq the neighbours of the hinge-active pairs only, at
3.35 TB/s). Each checked version's lik and d/dq are also compared with
the first checked version's, bit for bit (the record keeps whether they
are equal and the largest relative difference). Prints one line per case
with each version's mean, median and standard deviation and its share of
the bound, and writes ``chiprun_out/k1_designs.json``. ``--cases NAME ...``
times only those cases (e.g. ``"packed float64"``) and builds only the
libraries they need. ``--configs N ...`` times each case at the first N of
those configs (whole σ rows: the rows are the divisor of N nearest below
N / 1 000, so that a row's K configs stay whole), once for each N, e.g.
``--configs 33792 36000`` (33 792 = 1 056 tiles of 32, two waves of a
kernel that holds four blocks on each of the 132 SMs).

The ``dsigma`` cases (float32 and float64) time ``k1_dsigma`` of each
version at smoke (i)'s shape: g [36 000] and h² [37, 36 000] (the plain
hinge squared of the packed model at those configs) with σ [36, 37]. Each
version is checked against ``dsigma_plain`` in float64 (1e-5 of
Σ|g|h²/(2σ²), ``chip_smoke.py:trainable_phase``'s tolerance) and for a NaN
in g, which must make its (row, sphere) entries NaN and no other; beside
them, unchecked, a launch of an empty kernel (the timer's floor) and
``torch.einsum("prk,rk->rp", h2, g)`` (the reduction without the
1/(2σ²) scale: a reference, not the function). For these cases the
record also gives each version's device-only time: the kernels' own
duration in a ``torch.profiler`` window (CUPTI) of ``--reps`` launches,
the L2 flushed before each, taken after every event-timed case, since a
traced process launches more slowly afterwards. The K1 cases' record also
says whether each version's lik with d/dq is its forward-only lik bit for
bit (``lik_equal_to_forward_only``). Needs a CUDA device and ``nvcc``.

To time an earlier design, pass its source, e.g. from git:
``git show <commit>:vgpmp_torch/csrc/k1_collision.cuh > .proof/old/k1_collision.cuh``
(and its ``scene.cuh`` beside it, where that changed too). ``--unchecked
NAME ...`` times those versions without the check: an ablation that drops
work to show what that work costs.
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
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
from k2_designs import time_turns  # noqa: E402
from vgpmp_torch.likelihoods import collision as col  # noqa: E402
from vgpmp_torch.timing import card, l2_flush_buffer  # noqa: E402

CSRC = ROOT / "vgpmp_torch" / "csrc"
OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "k1_designs"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

# the (scalar type, lookup mode) libraries a version is built into
LIBS = {("float", "packed"): "K1_PACKED", ("float", "nearest"): "K1_NEAREST",
        ("float", "trilinear"): "K1_TRILINEAR", ("double", "packed"): "K1_PACKED",
        ("double", "nearest"): "K1_NEAREST", ("double", "trilinear"): "K1_TRILINEAR"}

# each case's (scalar type, lookup mode) library
CASES = {"packed": ("float", "packed"), "composed packed": ("float", "packed"),
         "nearest": ("float", "nearest"), "composed nearest": ("float", "nearest"),
         "trilinear": ("float", "trilinear"), "composed trilinear": ("float", "trilinear"),
         "packed float64": ("double", "packed"), "composed packed float64": ("double", "packed"),
         "nearest float64": ("double", "nearest"), "composed nearest float64": ("double", "nearest"),
         "trilinear float64": ("double", "trilinear"),
         "composed trilinear float64": ("double", "trilinear"),
         "dsigma": ("float", "dsigma"), "dsigma float64": ("double", "dsigma")}

SHIM = r"""
#include "k1_collision.cuh"
using S = K1D_SCALAR;
template cudaError_t k1_loglik_launch<S, K1D_MODE>(const K1Args<S>&, cudaStream_t);
// grid: base offset (3), origin (3), delta; shape: nx, ny, nz; counts: G, Ks, Kb, Kc
extern "C" int k1d_run(const S* q, const S* sigma, const S* robot, const S* spheres, const void* table,
                       const double* grid, const int* shape, const S* grid_f, const int* grid_i,
                       const void* cells, const S* prims, const int* counts, S* lik, S* dlik, S* h2,
                       long long T, long long K, int P, int dof, int craig, int grad, double eps,
                       void* st) {
  const SceneExtras ex{grid_f, grid_i, cells, prims, counts[0], counts[1], counts[2], counts[3]};
  const GridArgs<S> g{(S)grid[0], (S)grid[1], (S)grid[2], (S)grid[3], (S)grid[4], (S)grid[5],
                      (S)grid[6], shape[0], shape[1], shape[2]};
  const K1Args<S> a{q, sigma, robot, spheres, table, ex, lik, dlik, h2, T, K, P, dof, craig != 0,
                    grad != 0, g, (S)eps};
  return (int)k1_loglik_launch<S, K1D_MODE>(a, (cudaStream_t)st);
}
"""


DSIGMA_SHIM = r"""
#include "k1_collision.cuh"
using S = K1D_SCALAR;
template cudaError_t k1_dsigma_launch<S>(const S*, const S*, const S*, S*, int64_t, int64_t, int,
                                         cudaStream_t);
__global__ void k1d_empty_kernel() {}
extern "C" int k1d_dsigma(const S* g, const S* h2, const S* sigma, S* out, long long T, long long K, int P,
                          void* st) {
  return (int)k1_dsigma_launch<S>(g, h2, sigma, out, T, K, P, (cudaStream_t)st);
}
// the timer's floor: one launch of a kernel that does nothing
extern "C" int k1d_empty(void* st) {
  k1d_empty_kernel<<<1, 32, 0, (cudaStream_t)st>>>();
  return (int)cudaGetLastError();
}
"""


def compile_shim(build: Path, source: Path, stem: str, shim: str):
    """``shim`` (C++ that includes a version of a kernel's header) compiled
    by ``nvcc`` for ``sm_90a`` into ``build/lib{stem}.so`` and loaded with
    ``ctypes``; the headers come from ``source``'s directory first, then
    from ``vgpmp_torch/csrc``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    build.mkdir(parents=True, exist_ok=True)
    cu = build / f"shim_{stem}.cu"
    cu.write_text(shim)
    lib = build / f"lib{stem}.so"
    res = subprocess.run([nvcc, *FLAGS, f"-I{source.parent}", f"-I{CSRC}", "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({stem}):\n{res.stderr}")
    return ctypes.CDLL(str(lib))


def build_one(name: str, source: Path, scalar: str, mode: str):
    """``name``'s library for one (scalar type, lookup mode), or with mode
    ``dsigma`` its ``k1_dsigma`` and an empty kernel."""
    vp, i64, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    if mode == "dsigma":
        so = compile_shim(BUILD / name, source, f"k1_{scalar}_dsigma",
                          f"#define K1D_SCALAR {scalar}\n" + DSIGMA_SHIM)
        so.k1d_dsigma.argtypes = [vp] * 4 + [i64, i64, i32, vp]
        so.k1d_empty.argtypes = [vp]
        return so
    so = compile_shim(BUILD / name, source, f"k1_{scalar}_{mode}",
                      f"#define K1D_SCALAR {scalar}\n#define K1D_MODE {LIBS[scalar, mode]}\n" + SHIM)
    so.k1d_run.argtypes = [vp] * 15 + [i64, i64, i32, i32, i32, i32, f64, vp]
    return so


def build(sources: dict, keys=tuple(LIBS)) -> dict:
    """``{name: {(scalar, mode): library}}`` for the (scalar, mode)
    ``keys``, one ``nvcc`` a library, all at once."""
    with ThreadPoolExecutor(len(sources) * len(keys)) as pool:
        futs = {(nm, key): pool.submit(build_one, nm, Path(p).resolve(), *key)
                for nm, p in sources.items() for key in keys}
        libs = {nm: {} for nm in sources}
        for (nm, key), f in futs.items():
            libs[nm][key] = f.result()
    return libs


def launcher(so, model, q, sigma, grad: bool, h2: bool):
    """A call that launches ``so``'s K1 on ``model``'s tables, as
    ``collision.k1_loglik`` hands them to the extension, into outputs made
    once (so that the timed window holds the launch alone)."""
    sc, fk = model.scene, model.fk
    packed = sc.mode == "packed"
    table = sc.base_packed.words if packed else sc.base.data.contiguous()
    grid_f, grid_i, cells, prims, counts = model.tables.k1_args(packed)
    T, dof = q.shape
    P = sigma.shape[1]
    grid = (ctypes.c_double * 7)(*model._base_offset_host, *model._grid_host)
    shape = (ctypes.c_int * 3)(*sc.base.shape)
    cnt = (ctypes.c_int * 4)(grid_f.shape[0], *counts)
    st = torch.cuda.current_stream().cuda_stream
    lik = torch.empty(T, dtype=q.dtype, device=q.device)
    dlik = torch.empty(T, dof, dtype=q.dtype, device=q.device) if grad else None
    sq = torch.empty(P, T, dtype=q.dtype, device=q.device) if h2 else None
    p = lambda t: None if t is None else t.data_ptr()

    def run():
        rc = so.k1d_run(p(q), p(sigma), p(fk.k1_robot), p(fk.k1_spheres), p(table), grid, shape, p(grid_f),
                        p(grid_i), p(cells), p(prims), cnt, p(lik), p(dlik), p(sq), T, T // sigma.shape[0],
                        P, dof, int(fk.craig), int(grad), model.epsilon, st)
        if rc != 0:
            raise RuntimeError(f"k1_designs: launch failed with cudaError {rc}")
        return lik, dlik, sq

    return run


def models():
    """``{case: (collision model, scalar)}`` on the card: franka/industrial
    in each mode and dtype the cases time, with and without OBJECTS."""
    from vgpmp_torch.session import PlanningSession

    s32 = PlanningSession("franka", "industrial")
    s64 = PlanningSession("franka", "industrial", dtype=torch.float64)
    o32, o64 = chip_smoke.object_session(s32)[1], chip_smoke.object_session(s64)[1]
    mode = chip_smoke.mode_model
    return {"packed": (s32.model.collision, "float"), "composed packed": (o32.model.collision, "float"),
            "nearest": (mode(s32, "nearest"), "float"), "composed nearest": (mode(o32, "nearest"), "float"),
            "trilinear": (mode(s32, "trilinear"), "float"),
            "composed trilinear": (mode(o32, "trilinear"), "float"),
            "packed float64": (s64.model.collision, "double"),
            "composed packed float64": (o64.model.collision, "double"),
            "nearest float64": (mode(s64, "nearest"), "double"),
            "composed nearest float64": (mode(o64, "nearest"), "double"),
            "trilinear float64": (mode(s64, "trilinear"), "double"),
            "composed trilinear float64": (mode(o64, "trilinear"), "double")}, (s32, s64)


def same_bits(got, first) -> dict:
    """Whether the tensors ``got`` equal ``first``'s bit for bit (a NaN
    where it is NaN), and their largest difference relative to ``first``'s
    largest finite magnitude."""
    eq, rel = True, 0.0
    for a, b in zip(got, first):
        if a is None:
            continue
        eq &= bool(torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(), b.nan_to_num()))
        ok = ~(torch.isnan(a) | torch.isnan(b))
        scale = b[ok].abs().max().item() if ok.any() else 0.0
        rel = max(rel, (a[ok] - b[ok]).abs().max().item() / scale if scale > 0 else 0.0)
    return {"bit_equal_to_first": eq, "max_rel_diff_to_first": rel}


def check(runs: dict, model, q, sigma, grad: bool, h2: bool) -> dict:
    """Each version's launch against the plain version (value and, with
    ``grad``, d/dq; with ``h2``, h² against the plain hinge squared on the
    configs whose value agrees), and against the first version's bits;
    returns each version's record."""
    B, P = sigma.shape
    x = q.clone().requires_grad_(grad)
    lik_p = col.log_prob_plain(model, x.reshape(B, -1, q.shape[-1]), sigma).reshape(-1)
    gp = torch.autograd.grad(lik_p.sum(), x)[0] if grad else None
    lik_p = lik_p.detach()
    out, first = {}, None
    for nm, fn in runs.items():
        lik, dlik, sq = (None if t is None else t.clone() for t in fn())
        first = first or (lik, dlik, sq)
        if grad:
            close, rec = chip_smoke.k1_agreement(torch, lik, dlik, lik_p, gp, model.scene.mode == "trilinear")
        else:
            rtol, atol = (1e-9, 1e-9) if q.dtype == torch.float64 else (1e-5, 1e-3)
            close = torch.isclose(lik, lik_p, rtol=rtol, atol=atol)
            share = (~close).float().mean().item()
            assert share <= 1e-3, f"{nm}: {share:.2e} of the configs disagree with the plain version"
            rec = {"other_voxel_share": share, "max_abs_err": (lik - lik_p)[close].abs().max().item()}
        if h2:
            with torch.no_grad():
                h = model.hinge_cost(q)
            hh = (h * h).T
            err = ((sq - hh).abs() / (1e-4 * hh.abs() + 1e-7))[:, close].max().item()
            assert err <= 1, f"{nm}: h² disagrees with the plain hinge squared"
            rec["h2_err_of_tol"] = err
        out[nm] = {**rec, **same_bits((lik, dlik, sq), first)}
    torch.cuda.synchronize()
    return out


def rows_of(n: int, per_row: int = 1000) -> int:
    """The σ rows of ``n`` configs: the largest divisor of ``n`` that is at
    most ``ceil(n / per_row)``, so that each row holds ``n // rows`` whole
    configs (36 000 -> 36 of 1 000, 33 792 -> 33 of 1 024)."""
    top = -(-n // per_row)
    return max(r for r in range(1, top + 1) if n % r == 0)


def device_only(runs: dict, reps: int, flush) -> dict:
    """Per name, the device-only time (ms) a call of ``runs[name]`` takes:
    its kernels' own duration in a ``torch.profiler`` window (CUPTI) of
    ``reps`` calls, the L2 flushed before each (the flush's fill kernels
    left out), and the kernels launched a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for nm, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and "fill" not in e.key.lower()]
        out[nm] = {"device_ms": sum(e.self_device_time_total for e in ev) / 1e3 / reps,
                   "kernels_a_call": sum(e.count for e in ev) / reps}
    return out


def dsigma_runs(libs: dict, scalar: str, g, h2, sigma) -> tuple[dict, dict]:
    """Each version's ``k1_dsigma`` on (g, h², σ) into an output made once,
    and, unchecked, an empty kernel's launch and ``torch.einsum``'s
    reduction of the same h² and g."""
    R, P = sigma.shape
    K = g.shape[0] // R
    st = torch.cuda.current_stream().cuda_stream

    def launch(so, gg, out):
        rc = so.k1d_dsigma(gg.data_ptr(), h2.data_ptr(), sigma.data_ptr(), out.data_ptr(), g.shape[0], K, P, st)
        if rc != 0:
            raise RuntimeError(f"k1_designs: k1_dsigma failed with cudaError {rc}")
        return out

    checked = {}
    for nm, lib in libs.items():
        out = torch.empty_like(sigma)
        checked[nm] = (lambda so=lib[scalar, "dsigma"], out=out: launch(so, g, out),
                       lambda gg, so=lib[scalar, "dsigma"]: launch(so, gg, torch.empty_like(sigma)))
    first = next(iter(libs.values()))[scalar, "dsigma"]

    def empty():
        rc = first.k1d_empty(st)
        if rc != 0:
            raise RuntimeError(f"k1_designs: the empty kernel failed with cudaError {rc}")

    hv, gv = h2.view(P, R, K), g.view(R, K)
    return checked, {"empty kernel": empty, "einsum": lambda: torch.einsum("prk,rk->rp", hv, gv)}


def dsigma_check(checked: dict, g, h2, sigma) -> dict:
    """Each version's ``k1_dsigma`` against the float64 sum of the same terms
    (1e-5 of Σ|g|h²/(2σ²)), bit for bit against the first version, and with
    a NaN in g at row 4: that row NaN in every sphere (the plain sum's NaN
    times 0 is NaN too) and no other row."""
    R, P = sigma.shape
    K = g.shape[0] // R
    ref = col.dsigma_plain(g.double(), h2.double(), sigma.double())
    scale = col.dsigma_plain(g.abs().double(), h2.double(), sigma.double()).clamp(min=1e-30)
    gn = g.clone()
    gn[4 * K + 17] = float("nan")
    want_nan = torch.zeros_like(ref, dtype=torch.bool)
    want_nan[4] = True
    out, first = {}, None
    for nm, (run, run_g) in checked.items():
        got = run().clone()
        first = first if first is not None else got
        err = ((got.double() - ref).abs() / scale).max().item()
        assert err <= 1e-5, f"{nm}: k1_dsigma disagrees with the float64 sum: {err:.2e} of Σ|g|h²/(2σ²)"
        nan = torch.isnan(run_g(gn))
        assert torch.equal(nan, want_nan), f"{nm}: a NaN in g did not stay in its row"
        out[nm] = {"max_rel_err": err, "max_abs_err": (got.double() - ref).abs().max().item(),
                   "nan_in_g_stays_in_its_row": True, **same_bits((got,), (first,))}
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="NAME=PATH of a k1_collision.cuh version")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="versions timed without the check: ablations that drop work")
    ap.add_argument("--cases", nargs="*", default=None, help="the cases to time (default: all)")
    ap.add_argument("--configs", nargs="*", type=int, default=[36000],
                    help="time each case at the first N of the 36 000 configs, for each N given")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_designs: no CUDA device", file=sys.stderr)
        return 1
    sources = dict(s.split("=", 1) for s in args.sources) or {"current": str(CSRC / "k1_collision.cuh")}
    unknown = set(args.cases or ()) - set(CASES)
    if unknown:
        raise SystemExit(f"k1_designs: no case {sorted(unknown)}; the cases are {list(CASES)}")
    if any(n < 1 or n > 36000 for n in args.configs):
        raise SystemExit("k1_designs: --configs takes 1 to 36 000")
    wanted = [c for c in CASES if args.cases is None or c in args.cases]
    t0 = time.perf_counter()
    libs = build(sources, tuple(dict.fromkeys(CASES[c] for c in wanted)))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    smi = card(dev)
    print(f"k1_designs: built {list(sources)} in {build_s:.1f} s on {smi}", flush=True)
    cases, (s32, _) = models()
    cases = {c: cases[c] for c in wanted if c in cases}
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    q_all = chip_smoke.k1_inputs(torch, s32)
    B, L = q_all.shape[0], q_all.shape[-1]
    P = s32.model.collision.fk.sphere_radii.shape[0]
    sig_all = 0.003 + 0.005 * torch.rand((B, P), generator=gen, device=dev)
    g_all = torch.randn(q_all.numel() // L, generator=gen, device=dev)
    rows, profiled = [], []

    def report(row, names, extra=""):
        row["share_of_bound"] = {nm: row["bound_ms"] / m for nm, m in row["mean_ms"].items()}
        rows.append(row)
        print(f"{row['case']} {row['what']} at {row['shape'][0]} configs (bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}{extra}): "
              + ", ".join(f"{nm} {row['mean_ms'][nm]:.4f} / {row['median_ms'][nm]:.4f} "
                          f"± {row['stdev_ms'][nm]:.4f} ({100 * row['share_of_bound'][nm]:.1f} %)"
                          for nm in names)
              + " ms (mean / median ± stdev, share of bound)", flush=True)

    def timed(times):
        return {"mean_ms": {nm: statistics.fmean(v) for nm, v in times.items()},
                "median_ms": {nm: statistics.median(v) for nm, v in times.items()},
                "stdev_ms": {nm: statistics.stdev(v) for nm, v in times.items()},
                "min_ms": {nm: min(v) for nm, v in times.items()}}

    for n in args.configs:
        R = rows_of(n)
        q32 = q_all.reshape(-1, L)[:n]
        sig32 = sig_all[:R]
        for case in wanted:
            scalar, mode = CASES[case]
            dt = torch.float64 if scalar == "double" else torch.float32
            q, sigma = q32.to(dt).contiguous(), sig32.to(dt)
            if mode == "dsigma":
                with torch.no_grad():
                    h = s32.model.collision.hinge_cost(q32)
                h2 = (h * h).T.to(dt).contiguous()
                g = g_all[:n].to(dt)
                checked, extra = dsigma_runs(libs, scalar, g, h2, sigma)
                errs = dsigma_check({nm: fn for nm, fn in checked.items() if nm not in args.unchecked},
                                    g, h2, sigma)
                runs = {**{nm: fn[0] for nm, fn in checked.items()}, **extra}
                times = time_turns(runs, args.reps, flush)
                es = q.element_size()
                # h² and g read once, σ read and the result written once; 2 operations a term
                b_ms, b_by = chip_smoke.bound_ms((n * P + n + 2 * R * P) * es, 2 * n * P,
                                                 chip_smoke.F64_FLOPS if es == 8 else chip_smoke.F32_FLOPS)
                row = {"case": case, "dtype": str(dt).removeprefix("torch."), "mode": mode, "what": "reduction",
                       "design": chip_smoke.DSIGMA_DESIGN, "shape": [n, P, R], "errors": errs,
                       "bound_ms": b_ms, "bound_by": b_by, "nbytes": (n * P + n + 2 * R * P) * es,
                       **timed(times)}
                profiled.append((row, runs))
                report(row, runs, f"; checked versions bit-equal: "
                                  f"{all(e['bit_equal_to_first'] for e in errs.values())}")
                continue
            model, _ = cases[case]
            forward_lik = {}
            for grad, h2 in ((False, False), (True, False), (True, True)):
                if h2 and mode == "trilinear":
                    continue
                runs = {nm: launcher(lib[scalar, mode], model, q, sigma, grad, h2) for nm, lib in libs.items()}
                errs = check({nm: fn for nm, fn in runs.items() if nm not in args.unchecked}, model, q, sigma,
                             grad, h2)
                # whether each version's lik is the forward-only instantiation's, bit for bit
                for nm, rec in errs.items():
                    lik = runs[nm]()[0]
                    if grad:
                        same = same_bits((lik,), (forward_lik[nm],))
                        rec["lik_equal_to_forward_only"] = same["bit_equal_to_first"]
                        rec["lik_rel_diff_to_forward_only"] = same["max_rel_diff_to_first"]
                    else:
                        forward_lik[nm] = lik.clone()
                times = time_turns(runs, args.reps, flush)
                b_ms, b_by, sectors, nbytes, _ = chip_smoke.k1_bound(torch, model, q, sigma, grad, h2)
                what = "h2" if h2 else "grad" if grad else "forward"
                row = {"case": case, "dtype": str(dt).removeprefix("torch."), "mode": mode, "what": what,
                       "design": chip_smoke.k1_design(model), "shape": [q.shape[0], P, R], "errors": errs,
                       "bound_ms": b_ms, "bound_by": b_by, "sectors": sectors, "nbytes": nbytes,
                       **timed(times)}
                report(row, runs, f", {sectors} sectors; checked versions bit-equal: "
                                  f"{all(e['bit_equal_to_first'] for e in errs.values())}")
    # the profiler windows last: a traced process launches more slowly afterwards
    for row, runs in profiled:
        row["device_only"] = device_only(runs, args.reps, flush)
        print(f"{row['case']} {row['what']} at {row['shape'][0]} configs, device-only: "
              + ", ".join(f"{nm} {d['device_ms']:.4f} ms ({d['kernels_a_call']:g} kernels a call; event "
                          f"{row['mean_ms'][nm]:.4f})" for nm, d in row["device_only"].items()), flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "k1_designs.json").write_text(json.dumps(
        {"card": smi, "reps": args.reps, "sources": sources, "build_s": build_s, "configs": args.configs,
         "cases": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
