"""One rank of a small multi-process run on the CPU over gloo, with a fault
planted where the test asks: ``python -m benchmark.tests._rank RANK WORLD
PORT FAULT``. Prints the rank's result as its last line."""

import argparse
import json
import sys

import torch

from benchmark import run
from benchmark.harness import check
from benchmark.tests.conftest import TINY, tiny_cell


def main():
    rank, world, port, fault = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    check.BLOCK = 4
    if fault == "no_exchange":
        from vgpmp_torch.parallel import sharded

        def own_slab_only(x, mesh):
            parts = [x if i == mesh.dp_index else torch.zeros_like(x) for i in range(mesh.dp)]
            return torch.cat(parts)

        sharded.gather_rows = own_slab_only
    cell = tiny_cell(rows=4 * world, sizes=(4 * world, 2 * world, world))
    args = argparse.Namespace(workload=cell["workload"]["name"], seed=2 ** 31 + 5, seconds=0.1, trace=0,
                              port=port)
    res = run.run_rank(cell, args, "cpu", rank, world, overrides=TINY, backend="gloo")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
