#!/usr/bin/env python3
"""Registers, spills and shared memory of the port's CUDA kernels, as ``ptxas``
reports them.

    python tools/kernel_resources.py [source.cu ...]

Compiles each source (default: every ``vgpmp_torch/csrc/k*.cu``) for
``sm_90a`` with ``nvcc -Xptxas -v``, all sources at once, and prints one line
per kernel: registers per thread, bytes of spill stores and loads, stack frame
and static shared memory. Needs ``nvcc``; runs no kernel, so it needs no
card. The record also goes to ``chiprun_out/kernel_resources.json``. To read
an older version of a kernel, pass the path of that version's source (it must
sit beside the headers it includes).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vgpmp_torch" / "csrc"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xptxas", "-v", "-c")

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("kernel_resources: no nvcc on this machine")
    return nvcc


def demangle(names):
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not names:
        return dict(zip(names, names))
    out = subprocess.run([filt, *names], capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.strip().splitlines()))


def parse(log: str):
    """``ptxas -v`` text -> one record per entry function."""
    rows, cur = [], None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = {"mangled": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _STACK.search(line)):
            cur.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif cur is not None and (m := _USED.search(line)):
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["static_smem_bytes"] = int(s.group(1)) if s else 0
    return rows


def resources(sources):
    """Compile ``sources`` side by side; ``{source: [kernel records]}``."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *FLAGS, f"-I{Path(src).resolve().parent}", f"-I{CSRC}", str(src),
             "-o", str(Path(tmp) / f"{i}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, src in enumerate(sources)]
        out = {}
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            rows = parse(log)
            names = demangle([r["mangled"] for r in rows])
            for r in rows:
                r["kernel"] = names[r["mangled"]]
            out[str(src)] = rows
    return out


def main(argv) -> int:
    sources = [Path(a) for a in argv] or sorted(CSRC.glob("k*.cu"))
    rec = resources(sources)
    for src, rows in rec.items():
        print(src)
        for r in rows:
            print(f"  {r['registers']:4d} regs  spill {r['spill_store_bytes']}/{r['spill_load_bytes']} B"
                  f"  stack {r['stack_bytes']} B  smem {r['static_smem_bytes']} B  {r['kernel'][:150]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_resources.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
