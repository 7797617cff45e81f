#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vgpmp_torch`` once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``). Set-up builds the session of the cell's configuration
and warms up the cell's bucket shapes; the window then drives
``solve_adaptive`` with whole batches of the cell's traffic for ``--seconds``
(a closed loop with one client); after the window the answers are held to
the plain reference (``benchmark/reference``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, which also end standard
error. A four-card cell runs one process a card, started and joined here
over NCCL.

Exits 2, printing no result, without the cards the cell asks for; 3 where a
module of JAX, Flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every cache the program or PyTorch writes stays inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
# one host thread for the host's own arithmetic: the program is host-bound, and a
# team of threads on a shared host spread runs of the same work by ~10 %
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
RANK_TIMEOUT_S = 340


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell, as the parent starts it
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def read_metric(name: str, rec: dict):
    """The per-layer metric ``name`` from its reader ``benchmark/metrics/<name>.py``."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def run_rank(cell: dict, args, device, rank: int = 0, world: int = 1, t_start: float = T_START,
             overrides=None, backend: str = "nccl") -> dict:
    """This process's part of a run: set-up, the window, the traced batch, the
    comparison. Returns what :func:`compose` needs."""
    import torch

    from benchmark.harness import check, program, trace, window
    from benchmark.reference import model as ref
    from benchmark.work import step as step_work

    t_imports = time.time()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(torch.device(device))
        torch.cuda.init()
    mesh = None
    if world > 1:
        mesh = program.init_ranks(rank, world, args.port, device, backend)
    t_system = time.time()
    system = program.System(cell, device, mesh, overrides)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    system.warm_up()
    if world > 1:
        torch.distributed.barrier()
    # what set-up made stays; the collector then walks only what the window makes
    gc.collect()
    gc.freeze()
    t_window = time.time()
    setup = {"setup_s": t_window - t_start, "start_and_imports_s": t_imports - t_start,
             "cuda_init_and_ranks_s": t_system - t_imports, **system.times}
    log(f"rank {rank}: set-up {json.dumps(setup)}")

    def go(k: int, wants: bool) -> bool:
        flag = torch.tensor([int(wants)], device=system.device)
        torch.distributed.broadcast(flag, src=0)
        return bool(flag.item())

    sink: list = []
    traced = {}

    def run_batch(k: int) -> dict:
        if args.trace and k == 1:
            before = program.launch_counts()
            out, events = trace.profile_call(lambda: system.run_batch(k, args.seed, sink))
            traced.update(events=events, counts={n: v - before[n] for n, v in program.launch_counts().items()},
                          rounds=out["rounds"])
            return out
        return system.run_batch(k, args.seed, sink)

    batches = window.run(args.seconds, run_batch, go=go if world > 1 else None,
                         at_least=2 if args.trace else 1)
    totals = window.totals(batches)
    peak = torch.cuda.max_memory_allocated(system.device) if cuda else 0
    log(f"rank {rank}: window {json.dumps(totals)}")

    rec = {"window": totals}
    out = {"rank": rank, "setup": setup, "window": totals, "memory_peak_bytes": int(peak)}
    cfg = cell["config"]
    pb = ref.Problem.load(ROOT / cfg["assets"], cfg["robot"], cfg["problemset"], system.pp, system.device)
    n_local = system.rows // system.dp
    s0, g0 = sink[0]["starts"], sink[0]["goals"]
    mine = slice(rank * n_local, (rank + 1) * n_local) if world > 1 else slice(None)
    if args.trace:
        events = traced.pop("events")
        log(f"rank {rank}: profiler events by kind {json.dumps(trace.kinds(events))}")
        rec["trace"] = trace.record(trace.reduce_events(events))
        rec["traced_rounds"] = traced["rounds"]
        tr = rec["trace"]
        log(f"rank {rank}: profiler records of K1 {tr['k1_records']} of {traced['counts']['k1']} launches, "
            f"K2 {tr['k2_records']} of {traced['counts']['k2']} (dropped: "
            f"{traced['counts']['k1'] - tr['k1_records']}, {traced['counts']['k2'] - tr['k2_records']})")
        # the least time of the traced batch's Adam steps (their host spans are the trace's)
        pp = system.pp
        rec["step"] = {"least_s": sum(system.train.num_steps * step_work.least_s(
            len(r["starts"]) // system.dp, int(pp["num_samples"]), pb.L, int(pp["time_spacing_X"]),
            int(pp.get("num_bases", 1024)), int(pp["num_inducing"]), pb.P) for r in sink[1]["rounds"])}
        if cuda:
            rec["stages"] = stages(system, pb, s0[mine], g0[mine], args.seed)
        out["trace"] = {"busy_s": tr["busy_s"], "window_s": tr["window_s"], "breakdown": tr["breakdown"]}
    out["per_layer"] = {}
    if rank == 0:
        for x in cell["per_layer"]:
            v = read_metric(x["name"], rec)
            if v is not None:
                out["per_layer"][x["name"]] = {"value": float(v), "unit": x["unit"]}

    # the comparison, once the window is closed and its state freed
    picks = check.sample_batches(len(sink), args.seed)
    records = [sink[i] for i in picks] if rank == 0 else []
    sink.clear()
    if cuda:
        torch.cuda.empty_cache()
    nums = check.model_numbers(system, pb, s0, g0, args.seed, mine)
    v = nums.pop("_verdicts")
    log(f"rank {rank}: per-row gaps at quantiles 0.5, 0.9, 0.99, 1: {json.dumps(nums.pop('_quantiles'))}")
    ans = check.answer_numbers(system, pb, records, system.max_rounds)
    nums["verdict_mismatch"] = v["mismatch"] + ans["mismatch"]
    nums["choice_mismatch"] = ans["choice_mismatch"]
    nums["rows_judged"] = v["rows"] + ans["rows"]
    nums["rows_undecided"] = v["undecided"] + ans["undecided"]
    out["numbers"] = nums
    out["forbidden"] = program.forbidden_modules()
    if world > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return out


def stages(system, pb, starts, goals, seed) -> dict:
    """The collision stage and the pathwise draw and evaluation, each timed
    alone with CUDA events at the cell's round-0 size (this rank's rows)."""
    import torch

    from benchmark.harness import program, trace
    from benchmark.harness.traffic import seed_of
    from benchmark.work import k1 as k1_work
    from benchmark.work import rff as rff_work

    fns = program.stage_calls(system, starts, goals, seed_of(seed, 0, 4))
    pp = system.pp
    B, S, N = len(starts), int(pp["num_samples"]), int(pp["time_spacing_X"])
    out = {"k1": {"ms": trace.time_ms(fns["k1"], 10, system.device),
                  **k1_work.work(pb, fns["q"], fns["sigma"].numel())},
           "rff": {"ms": trace.time_ms(fns["rff"], 10, system.device),
                   **rff_work.work(B, S, pb.L, N, int(pp.get("num_bases", 1024)),
                                   int(pp["num_inducing"]) + 2)}}
    del fns
    torch.cuda.empty_cache()
    return out


def compose(cell: dict, args, results: list) -> dict:
    """The run's last line from every rank's result (rank 0 first)."""
    import torch

    from benchmark.harness import check

    r0 = results[0]
    nums = {}
    for k in ("elbo_gap", "grad_gap", "change_gap", "best_gap"):
        nums[k] = max(r["numbers"][k] for r in results)
    for k in ("verdict_mismatch", "choice_mismatch"):
        nums[k] = sum(r["numbers"][k] for r in results)
    judged = check.judge_all(nums, cell["limits"])
    info = {k: sum(r["numbers"][k] for r in results) for k in ("rows_judged", "rows_undecided")}
    log(f"compared rows {info['rows_judged']}, undecided by a probe within 1e-5 m of its floor "
        f"{info['rows_undecided']}")
    w = r0["window"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
              "count": len(results), "memory_peak_bytes": max(r["memory_peak_bytes"] for r in results)}
    if args.trace:
        metrics = r0["per_layer"]
        if all("trace" in r for r in results):
            device["busy_s"] = sum(r["trace"]["busy_s"] for r in results) / len(results)
            device["window_s"] = sum(r["trace"]["window_s"] for r in results) / len(results)
    else:
        values = {"solves_per_s": w["solves_per_s"], "executed_share": w["executed_share"],
                  "setup_s": r0["setup"]["setup_s"]}
        metrics = {x["name"]: {"value": values[x["name"]], "unit": x["unit"]} for x in cell["end_to_end"]}
    line = {"correct": all(j["ok"] for j in judged.values()), "attempted": int(w["rows"]),
            "failed": int(w["failed"]), "metrics": metrics, "device": device}
    if args.trace and "trace" in r0:
        line["breakdown"] = r0["trace"]["breakdown"]
    line["checks"] = {k: {"value": j["value"], "limit": j["limit"]} for k, j in judged.items()}
    return line


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(cmds: list, env: dict) -> list:
    """Start one process a rank, wait for all (killing the rest when one fails
    or overruns), and return each one's result, the last line of its output."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True) for c in cmds]
    outs, failed = [None] * len(procs), None
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for i, p in enumerate(procs):
            try:
                outs[i], _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                failed = f"rank {i} overran {RANK_TIMEOUT_S} s"
                break
            if p.returncode != 0:
                failed = f"rank {i} exited {p.returncode}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        raise RuntimeError(failed)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    chips = int(cell["workload"]["chips"])
    import torch

    if args.rank is not None:  # one rank of a multi-card cell
        res = run_rank(cell, args, f"cuda:{args.rank}", args.rank, args.world, args.t_start)
        print(json.dumps(res), flush=True)
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if chips == 1:
        results = [run_rank(cell, args, "cuda:0")]
    else:
        port = free_port()
        cmds = [[sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                 "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
                 "--rank", str(r), "--world", str(chips), "--port", str(port), "--t-start", repr(T_START)]
                for r in range(chips)]
        results = spawn_ranks(cmds, dict(os.environ))
        results.sort(key=lambda r: r["rank"])
    rc, line = finish(cell, args, results)
    if line is not None:
        print(json.dumps(line), flush=True)
    return rc


def finish(cell: dict, args, results: list):
    """``(exit code, last line or None)``: no line where any rank, or this
    process, holds a module of JAX, Flax or the JAX package."""
    found = sorted(set(sum((r["forbidden"] for r in results), [])) | set(_forbidden_here()))
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3, None
    line = compose(cell, args, results)
    for k, c in line["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return 0, line


def _forbidden_here():
    from benchmark.harness.program import forbidden_modules

    return forbidden_modules()


if __name__ == "__main__":
    sys.exit(main())
