#!/usr/bin/env python3
"""Registers, spills and shared memory of the port's CUDA kernels, as ``ptxas``
reports them.

    python tools/kernel_resources.py [source.cu ...] [--against DIR]

Compiles each source (default: every ``vgpmp_torch/csrc/k*.cu``) for
``sm_90a`` with ``nvcc -Xptxas -v``, all sources at once, and prints one line
per kernel: registers per thread, bytes of spill stores and loads, stack frame
and static shared memory, and the SHA-256 of its machine code (the SASS text
``cuobjdump -sass`` prints for it, so that two versions of a source show
which kernels they left unchanged). Needs ``nvcc``; runs no kernel, so it
needs no card. The record also goes to ``chiprun_out/kernel_resources.json``. To read
an older version of a kernel, pass the path of that version's source (it must
sit beside the headers it includes). ``--against DIR`` also compiles the
file of the same name in DIR (an older version's sources beside its headers)
for each source, and prints for every kernel its registers and spills in
both and whether its machine code is the same (``same SASS``) or changed.
"""

from __future__ import annotations

import hashlib
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
_FUNCTION = re.compile(r"Function : (\S+)")


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


def find_cuobjdump() -> str:
    return shutil.which("cuobjdump") or str(Path(find_nvcc()).with_name("cuobjdump"))


def sass_hashes(obj: Path) -> dict:
    """``{mangled name: SHA-256 of its SASS}`` of the object file ``obj``,
    each line's runs of blanks taken as one (``cuobjdump`` pads its columns
    to the longest name in the file, so a kernel added to or changed in a
    file would otherwise move the hash of every other kernel there)."""
    out = subprocess.run([find_cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if m := _FUNCTION.search(line):
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(" ".join(line.split()))
    return {n: hashlib.sha256("\n".join(lines).encode()).hexdigest() for n, lines in funcs.items()}


def resources(sources):
    """Compile ``sources`` side by side; ``{source: [kernel records]}``."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(i, src, subprocess.Popen(
            [nvcc, *FLAGS, f"-I{Path(src).resolve().parent}", f"-I{CSRC}", str(src),
             "-o", str(Path(tmp) / f"{i}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, src in enumerate(sources)]
        out = {}
        for i, src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            rows = parse(log)
            names = demangle([r["mangled"] for r in rows])
            sass = sass_hashes(Path(tmp) / f"{i}.o")
            for r in rows:
                r["kernel"] = names[r["mangled"]]
                r["sass_sha256"] = sass.get(r["mangled"])
            out[str(src)] = rows
    return out


def compare(rec: dict, sources, old_dir: Path) -> list:
    """Per kernel of ``sources``: its registers, spills and SASS hash beside
    those of the same kernel compiled from ``old_dir``'s file of the same
    name (matched by the demangled name: a kernel in an anonymous namespace
    is mangled with a hash of its file's path); printed, and returned as
    records."""
    out = []
    for src in sources:
        old = {r["kernel"]: r for r in rec[str(old_dir / src.name)]}
        print(f"{src} against {old_dir / src.name}")
        for r in rec[str(src)]:
            o = old.get(r["kernel"])
            same = o is not None and o["sass_sha256"] == r["sass_sha256"]
            was = "new kernel" if o is None else (f"{o['registers']:4d} regs spill {o['spill_store_bytes']} B")
            print(f"  {'same SASS' if same else 'changed  '}  {was} -> {r['registers']:4d} regs spill "
                  f"{r['spill_store_bytes']} B  {r['kernel'][:130]}")
            out.append({"source": str(src), "kernel": r["kernel"], "same_sass": same,
                        "registers": r["registers"], "spill_store_bytes": r["spill_store_bytes"],
                        "old_registers": None if o is None else o["registers"],
                        "old_spill_store_bytes": None if o is None else o["spill_store_bytes"]})
    return out


def main(argv) -> int:
    old_dir = None
    if "--against" in argv:
        i = argv.index("--against")
        old_dir = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    sources = [Path(a) for a in argv] or sorted(CSRC.glob("k*.cu"))
    rec = resources(sources + ([old_dir / s.name for s in sources] if old_dir else []))
    if old_dir is not None:
        rec["against"] = compare(rec, sources, old_dir)
    for src, rows in rec.items():
        if src == "against":
            continue
        print(src)
        for r in rows:
            print(f"  {r['registers']:4d} regs  spill {r['spill_store_bytes']}/{r['spill_load_bytes']} B"
                  f"  stack {r['stack_bytes']} B  smem {r['static_smem_bytes']} B  sass "
                  f"{(r['sass_sha256'] or '-')[:12]}  {r['kernel'][:150]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_resources.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
