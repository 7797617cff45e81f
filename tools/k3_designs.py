#!/usr/bin/env python3
"""Time designs of kernel K3 against each other in one process on the card.

    python tools/k3_designs.py [NAME=SOURCE ...] [--reps 30]

Each SOURCE is a version of ``vgpmp_torch/csrc/k3_clearance.cuh``; the
headers it includes (``scene.cuh``, ``fk.cuh``, ``kernels.h``,
``launch.cuh``) come from its own directory first, then from
``vgpmp_torch/csrc``. With no argument: the checkout's header, as
``current``. Every version is compiled with ``nvcc`` for ``sm_90a`` beside a
small C shim (``k1_designs.py:compile_shim``), one shared library for each
scalar type, all at once, and loaded with ``ctypes``.

The cases, franka/industrial at ``chip_smoke.py:k3_inputs``' shapes: both
entries, on the base grid alone and on ``chip_smoke.py:OBJECTS``' scene, in
float32 and float64. ``k3_min_clearance`` is checked on the 230 400 PD-path
probes plus as many uniform configs against
``vgpmp_torch.likelihoods.collision.min_clearance_eval_plain`` (1e-5 m,
1e-9 m in float64) and timed on the probes; ``k3_probe_clearance`` on 40 x
6 400 probes against ``vgpmp_torch.sim.probe_clearance_plain``
(``chip_smoke.py:k3_probe_agreement``). Each version's ``out`` and segment
counts are also compared with the first version's, bit for bit. Then every
version is timed in turns (``k2_designs.py:time_turns``: A, B, B, A, ...)
with the 50 MB L2 flushed before every launch, beside its bound
(``chip_smoke.py:k3_bound``). Prints one line per case with each version's
mean, median and standard deviation and its share of the bound, and writes
``chiprun_out/k3_designs.json``. ``--unchecked NAME ...`` times those
versions without the check: an ablation that drops work. Needs a CUDA
device and ``nvcc``.

To time an earlier design, pass its source, e.g. from git:
``git show <commit>:vgpmp_torch/csrc/k3_clearance.cuh > .proof/old/k3_clearance.cuh``
(with that commit's ``scene.cuh`` and ``fk.cuh`` beside it).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
from k1_designs import compile_shim, same_bits  # noqa: E402
from k2_designs import time_turns  # noqa: E402
from vgpmp_torch import sim  # noqa: E402
from vgpmp_torch.likelihoods import collision as col  # noqa: E402
from vgpmp_torch.timing import card, l2_flush_buffer  # noqa: E402

CSRC = ROOT / "vgpmp_torch" / "csrc"
OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "k3_designs"
SCALARS = ("float", "double")

SHIM = r"""
#include "k3_clearance.cuh"
using S = K3D_SCALAR;
template cudaError_t k3_min_clearance_launch<S>(const S*, const S*, const S*, const S*, const SceneExtras&,
                                                S*, int64_t, int, int, bool, GridArgs<S>, cudaStream_t);
template cudaError_t k3_probe_clearance_launch<S>(const S*, const S*, const S*, const S*,
                                                  const SceneExtras&, S*, int64_t, int, int, bool,
                                                  GridArgs<S>, const K3Probe<S>&, cudaStream_t);
// grid: base offset (3), origin (3), delta; shape: nx, ny, nz; counts: G, Ks, Kb, Kc; probe: 0 for
// k3_min_clearance, else the fused entry on q_s .. seg_count with G probes a row and T segments
extern "C" int k3d_run(const S* q, const S* robot, const S* spheres, const S* sdf, const double* grid,
                       const int* shape, const S* grid_f, const int* grid_i, const S* cells, const S* prims,
                       const int* counts, S* out, long long n, int P, int dof, int craig, int probe,
                       const S* q_s, const S* q_g, const S* depth_s, const S* depth_g, const bool* visited,
                       const long long* seg_idx, int* seg_count, long long G, long long T, double radius,
                       double slack, void* st) {
  const SceneExtras ex{grid_f, grid_i, cells, prims, counts[0], counts[1], counts[2], counts[3]};
  const GridArgs<S> g{(S)grid[0], (S)grid[1], (S)grid[2], (S)grid[3], (S)grid[4], (S)grid[5],
                      (S)grid[6], shape[0], shape[1], shape[2]};
  if (!probe)
    return (int)k3_min_clearance_launch<S>(q, robot, spheres, sdf, ex, out, n, P, dof, craig != 0, g,
                                           (cudaStream_t)st);
  // the division by the radius as the binding takes it (csrc/bindings.cpp:k3_probe_run)
  const K3Probe<S> pa{q_s, q_g, depth_s, depth_g, visited, (const int64_t*)seg_idx, seg_count, G, T,
                      S(1) / (S)radius, (S)slack};
  return (int)k3_probe_clearance_launch<S>(q, robot, spheres, sdf, ex, out, n, P, dof, craig != 0, g,
                                           pa, (cudaStream_t)st);
}
"""


def build_one(name: str, source: Path, scalar: str):
    """``name``'s library for one scalar type."""
    so = compile_shim(BUILD / name, source, f"k3_{scalar}", f"#define K3D_SCALAR {scalar}\n" + SHIM)
    vp, i64, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    so.k3d_run.argtypes = [vp] * 12 + [i64, i32, i32, i32, i32] + [vp] * 7 + [i64, i64, f64, f64, vp]
    return so


def build(sources: dict) -> dict:
    """``{name: {scalar: library}}``, one ``nvcc`` a library, all at once."""
    with ThreadPoolExecutor(len(sources) * len(SCALARS)) as pool:
        futs = {(nm, sc): pool.submit(build_one, nm, Path(p).resolve(), sc)
                for nm, p in sources.items() for sc in SCALARS}
        libs = {nm: {} for nm in sources}
        for (nm, sc), f in futs.items():
            libs[nm][sc] = f.result()
    return libs


def launcher(so, model, q, probe=None):
    """A call that launches ``so``'s K3 on ``model``'s tables, as
    ``collision.k3_min_clearance`` (``probe`` None: ``q [n, L]``) or
    ``collision.k3_probe_clearance`` (``probe`` its arguments after ``qs``;
    ``q [B, G, L]``) hand them to the extension, into outputs made once (so
    that the timed window holds the launch alone; the segment counts are
    zeroed once, so only the first call's are the entry's result). Returns
    ``(out, counts or None)``."""
    sc, fk = model.scene, model.fk
    grid_f, grid_i, cells, prims, counts = model.tables.k3_args()
    L = q.shape[-1]
    qf = q.reshape(-1, L).contiguous()
    n, P = qf.shape[0], fk.k1_spheres.shape[0]
    grid = (ctypes.c_double * 7)(*model._base_offset_host, *model._grid_host)
    shape = (ctypes.c_int * 3)(*sc.base.shape)
    cnt = (ctypes.c_int * 4)(grid_f.shape[0], *counts)
    st = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n, dtype=q.dtype, device=q.device)
    p = lambda t: None if t is None else t.data_ptr()
    if probe is None:
        pr, extra, seg_count = 0, [None] * 7 + [0, 0, 0.0, 0.0], None
    else:
        *rows, T, radius, slack = probe
        held = [t.contiguous() for t in rows]  # q_s, q_g, depth_s, depth_g, visited, seg_idx
        seg_count = torch.zeros(q.shape[0], T, dtype=torch.int32, device=q.device)
        pr = 1
        extra = [*map(p, held), p(seg_count), q.shape[1], T, radius, slack]

    def run():
        rc = so.k3d_run(p(qf), p(fk.k1_robot), p(fk.k1_spheres), p(sc.base.data), grid, shape, p(grid_f),
                        p(grid_i), p(cells), p(prims), cnt, p(out), n, P, L, int(fk.craig), pr, *extra, st)
        if rc != 0:
            raise RuntimeError(f"k3_designs: launch failed with cudaError {rc}")
        return out, seg_count

    run.inputs = held if probe is not None else None  # alive as long as the call
    return run


def models():
    """``{case: (session, scalar)}`` on the card: franka/industrial alone and
    with OBJECTS, float32 and float64."""
    from vgpmp_torch.session import PlanningSession

    s32 = PlanningSession("franka", "industrial")
    s64 = PlanningSession("franka", "industrial", dtype=torch.float64)
    return {"base": (s32, "float"), "objects": (chip_smoke.object_session(s32)[1], "float"),
            "base float64": (s64, "double"), "objects float64": (chip_smoke.object_session(s64)[1], "double")}


def check_min(runs: dict, model, q) -> dict:
    """Each version's ``k3_min_clearance`` against the plain version and the
    first version's bits."""
    tol = 1e-9 if q.dtype == torch.float64 else 1e-5
    want = col.min_clearance_eval_plain(model, q)
    out, first = {}, None
    for nm, fn in runs.items():
        got = fn()[0].clone()
        first = first if first is not None else got
        err = (got - want).abs().max().item()
        assert torch.isfinite(got).all() and err <= tol, f"{nm}: K3 disagrees with the plain version ({err:.3e} m)"
        out[nm] = {"max_abs_err": err, **same_bits((got,), (first,))}
    return out


def check_probe(runs: dict, model, inp) -> dict:
    """Each version's ``k3_probe_clearance`` against the plain version
    (``chip_smoke.py:k3_probe_agreement``) and the first version's bits,
    the clearance and the segment counts."""
    qs, args = inp["probe"]
    clear_p, count_p = sim.probe_clearance_plain(partial(col.min_clearance_eval_plain, model), qs, *args)
    out, first = {}, None
    for nm, fn in runs.items():
        clear, count = (t.clone() for t in fn())
        clear = clear.reshape(qs.shape[:2])
        first = first or (clear, count)
        rec = chip_smoke.k3_probe_agreement(torch, qs, args, clear, count, clear_p, count_p, inp["visited"],
                                            inp["seg_idx"], inp["B"])
        bits = same_bits((clear,), (first[0],))
        bits["counts_equal_to_first"] = bool(torch.equal(count, first[1]))
        out[nm] = {**rec, **bits}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="NAME=PATH of a k3_clearance.cuh version")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="versions timed without the check: ablations that drop work")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_designs: no CUDA device", file=sys.stderr)
        return 1
    sources = dict(s.split("=", 1) for s in args.sources) or {"current": str(CSRC / "k3_clearance.cuh")}
    t0 = time.perf_counter()
    libs = build(sources)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    smi = card(dev)
    print(f"k3_designs: built {list(sources)} in {build_s:.1f} s on {smi}", flush=True)
    flush = l2_flush_buffer(dev)
    rows = []
    for case, (sess, scalar) in models().items():
        model = sess.model.collision
        inp = chip_smoke.k3_inputs(torch, sess)
        q_path, qs, probe = inp["q_path"], *inp["probe"]
        q_all = torch.cat([q_path, inp["q_box"]])
        for entry in ("k3_min_clearance", "k3_probe_clearance"):
            if entry == "k3_min_clearance":
                errs = check_min({nm: launcher(lib[scalar], model, q_all) for nm, lib in libs.items()
                                  if nm not in args.unchecked}, model, q_all)
                runs = {nm: launcher(lib[scalar], model, q_path) for nm, lib in libs.items()}
                b_ms, b_by, sectors = chip_smoke.k3_bound(torch, model, q_path, 0, 0)
                shape = list(q_path.shape[:1])
            else:
                runs = {nm: launcher(lib[scalar], model, qs, probe) for nm, lib in libs.items()}
                errs = check_probe({nm: fn for nm, fn in runs.items() if nm not in args.unchecked}, model, inp)
                b_ms, b_by, sectors = chip_smoke.k3_probe_bound(torch, model, qs, probe[6])
                shape = list(qs.shape[:2])
            torch.cuda.synchronize()
            times = time_turns(runs, args.reps, flush)
            row = {"case": case, "entry": entry, "dtype": str(q_path.dtype).removeprefix("torch."),
                   "design": chip_smoke.k3_design(model), "shape": shape, "errors": errs, "bound_ms": b_ms,
                   "bound_by": b_by, "sectors": sectors,
                   "mean_ms": {nm: statistics.fmean(v) for nm, v in times.items()},
                   "median_ms": {nm: statistics.median(v) for nm, v in times.items()},
                   "stdev_ms": {nm: statistics.stdev(v) for nm, v in times.items()},
                   "min_ms": {nm: min(v) for nm, v in times.items()}}
            row["share_of_bound"] = {nm: b_ms / m for nm, m in row["mean_ms"].items()}
            rows.append(row)
            same = all(e.get("bit_equal_to_first") and e.get("counts_equal_to_first", True) for e in errs.values())
            print(f"{case} {entry} (bound {b_ms:.4f} ms by {b_by}, {sectors} sectors; bit-equal to "
                  f"{next(iter(runs))}: {same}): "
                  + ", ".join(f"{nm} {row['mean_ms'][nm]:.4f} / {row['median_ms'][nm]:.4f} "
                              f"± {row['stdev_ms'][nm]:.4f} ({100 * row['share_of_bound'][nm]:.1f} %)"
                              for nm in runs)
                  + " ms (mean / median ± stdev, share of bound)", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "k3_designs.json").write_text(json.dumps(
        {"card": smi, "reps": args.reps, "sources": sources, "build_s": build_s, "cases": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
