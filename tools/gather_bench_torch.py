#!/usr/bin/env python
"""Gather microbenchmark of the PyTorch/CUDA port on an NVIDIA GPU: the
counterpart of ``tools/gather_bench.py``.

The JAX tool asks whether a Pallas kernel gathering from a table held in the
TPU's on-chip memory beats XLA's gather from device memory. A GPU block's
shared memory is smaller than any of these tables, so here the question is
"table resident in the L2 against table in device memory":

1. kernel K4 (``vgpmp_torch/csrc/k4_gather.cu``) gathering 4-byte entries (what
   the Pallas kernel gathers) and 8-byte rows (what the packed SDF lookup
   gathers) at the profiled step's point count, from tables of 262 144 and
   1 048 576 entries (1-8 MB, L2-resident after the first touch) and of
   27 703 085 entries (the industrial scene's cell count: 111 and 222 MB,
   larger than the L2);
2. beside each, the plain indexing ``table[idx]`` (checked equal to K4) and
   the library call ``torch.index_select`` on the same inputs;
3. the production op through the port's plain path: ``packed_nearest_distance``
   forward, and the gradient of the hinge through its autograd function, on a
   synthetic grid of the industrial scene's dimensions with the points spread
   over the whole grid.

Each call is timed with CUDA events with the L2 flushed before it. Prints one
JSON object (ns per point for each) and writes it to
``chiprun_out/gather_bench.json``. It needs a CUDA device and raises without
one.

Run on the GPU, from the repo root:  python tools/gather_bench_torch.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from vgpmp_torch import resolve_device
from vgpmp_torch.ops.gather import gather_plain, k4_gather
from vgpmp_torch.sdf.grid import PackedSdfGrid, SdfGrid, packed_nearest_distance
from vgpmp_torch.timing import l2_flush_buffer, time_ms

# B x S x N x P of the profiled franka step, cut to a multiple of 1024 as the
# Pallas kernel's grid cuts it
NPTS = (36 * 20 * 50 * 37 // 1024) * 1024
INDUSTRIAL_DIMS = (337, 401, 205)
TABLE_CELLS = (262_144, 1_048_576, int(np.prod(INDUSTRIAL_DIMS)))


def gather_case(ncells: int, entry_bytes: int, npts: int, device, flush) -> dict:
    """K4, the plain indexing and ``torch.index_select`` on one table size and
    entry width: exact equality of the three, then their times."""
    gen = torch.Generator(device=device).manual_seed(ncells + entry_bytes)
    idx = torch.randint(0, ncells, (npts,), generator=gen, device=device, dtype=torch.int32)
    words = entry_bytes // 4
    table = torch.arange(ncells * words, dtype=torch.int32, device=device)
    if words == 2:
        table = table.reshape(ncells, 2)
    out = k4_gather(table, idx)
    equal = bool(torch.equal(out, gather_plain(table, idx))
                 and torch.equal(out, torch.index_select(table, 0, idx)))
    if not equal:
        raise AssertionError(f"K4 disagrees with table[idx]: {ncells} cells of {entry_bytes} bytes")
    per = 32 // entry_bytes  # entries in a 32-byte sector
    ms = {"k4": time_ms(lambda: k4_gather(table, idx), flush=flush),
          "plain": time_ms(lambda: gather_plain(table, idx), flush=flush),
          "library": time_ms(lambda: torch.index_select(table, 0, idx), flush=flush)}
    return {"ncells": ncells, "entry_bytes": entry_bytes, "npts": npts, "equal": equal,
            "table_mb": ncells * entry_bytes / 1e6,
            "sectors_touched": int(torch.unique(idx // per).numel()),
            **{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_ns_per_pt": v * 1e6 / npts for k, v in ms.items()}}


def bench_production_op(npts: int, device, flush) -> dict:
    """The packed-SDF lookup as the port's plain path runs it: the forward
    value, and the gradient of the hinge cost through the autograd function
    (no second gather)."""
    rng = np.random.default_rng(0)
    delta = 0.0045
    grid = SdfGrid.from_arrays(rng.uniform(-0.05, 0.5, size=INDUSTRIAL_DIMS).astype(np.float32),
                               np.zeros(3), delta, torch.float32, device)
    packed = PackedSdfGrid.pack(grid)
    extent = delta * np.array(INDUSTRIAL_DIMS)
    pts = torch.as_tensor(rng.uniform(0.0, extent, size=(npts, 3)).astype(np.float32), device=device)

    def forward():
        with torch.no_grad():
            return packed_nearest_distance(packed, pts)

    def hinge_grad():
        p = pts.clone().requires_grad_()
        cost = torch.clamp(0.05 - packed_nearest_distance(packed, p), min=0.0).square().sum()
        return torch.autograd.grad(cost, p)[0]

    return {"packed_fwd_ns_per_pt": time_ms(forward, 10, flush) * 1e6 / npts,
            "packed_hinge_grad_ns_per_pt": time_ms(hinge_grad, 10, flush) * 1e6 / npts,
            "packed_table_mb": packed.words.numel() * 4 / 1e6}


def main() -> dict:
    device = resolve_device()  # raises without CUDA: there is no CPU mode
    flush = l2_flush_buffer(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"device": torch.cuda.get_device_name(0), "card": smi, "npts": NPTS}
    out.update(bench_production_op(NPTS, device, flush))
    out["gathers"] = [gather_case(ncells, entry_bytes, NPTS, device, flush)
                      for entry_bytes in (4, 8) for ncells in TABLE_CELLS]
    print(json.dumps(out, indent=1))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "gather_bench.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
