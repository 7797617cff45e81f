#!/usr/bin/env python
"""Launch a multi-process sharded solve of the PyTorch port on this machine.

Spawns ``--processes`` workers (``python -m vgpmp_torch.parallel.multihost``),
rank r of N, joined through a TCP rendezvous on a free local port, each
waited for with a timeout; a rank that fails or times out fails the run and
the others are killed. With ``--device cuda`` rank r runs on card
``r % torch.cuda.device_count()``; the backend defaults to ``nccl`` there
and to ``gloo`` on the CPU. NCCL refuses two ranks on one card: pass
``--backend gloo`` to put several ranks on one (gloo carries CUDA tensors
through the host).

Rank 0's metrics line (``run_sharded``'s keys) is printed and written to
``chiprun_out/launch_multihost_torch.json`` (or ``--json-out``).

Example (two ranks on the CPU, tiny budget):
    python tools/launch_multihost_torch.py --processes 2 --device cpu \
        --overrides '{"num_steps": 12, "num_samples": 4}' --max-problems 8
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_devices(device: str, processes: int) -> list:
    """Each rank's ``--device``: ``cpu``, or ``cuda:<r % cards>``."""
    if device == "cpu":
        return ["cpu"] * processes
    import torch

    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("--device cuda: no CUDA device")
    return [f"cuda:{r % cards}" for r in range(processes)]


def launch_local(args) -> dict:
    """Spawn the ranks; return rank 0's metrics."""
    port = free_port()
    devices = worker_devices(args.device, args.processes)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    procs, outs = [], []
    for rank in range(args.processes):
        out = tempfile.NamedTemporaryFile(mode="w+", suffix=f".rank{rank}.json", delete=False)
        out.close()
        outs.append(out.name)
        cmd = [
            sys.executable, "-m", "vgpmp_torch.parallel.multihost",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(args.processes),
            "--process-id", str(rank),
            "--robot", args.robot,
            "--problemset", args.problemset,
            "--sample-shards", str(args.sample_shards),
            "--seed", str(args.seed),
            "--backend", backend,
            "--device", devices[rank],
            "--json-out", out.name,
        ]
        if args.max_problems:
            cmd += ["--max-problems", str(args.max_problems)]
        if args.overrides:
            cmd += ["--overrides", args.overrides]
        env = dict(os.environ, LOCAL_RANK=str(rank))
        if args.device == "cpu":  # one share of the cores each, not all of them each
            env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.processes)))
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        for rank, p in enumerate(procs):
            try:
                stdout, _ = p.communicate(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} did not finish in {args.timeout} s") from None
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{stdout[-4000:]}")
        return json.loads(Path(outs[0]).read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in outs:
            os.unlink(o)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--problemset", default="industrial")
    ap.add_argument("--sample-shards", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-problems", type=int, default=None)
    ap.add_argument("--overrides", default=None)
    ap.add_argument("--timeout", type=int, default=900, help="seconds each rank may take")
    ap.add_argument("--json-out", default=str(ROOT / "chiprun_out" / "launch_multihost_torch.json"))
    args = ap.parse_args(argv)

    metrics = launch_local(args)
    line = json.dumps(metrics)
    Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json_out).write_text(line)
    print(line)
    return metrics


if __name__ == "__main__":
    main()
