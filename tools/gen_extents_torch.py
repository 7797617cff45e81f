#!/usr/bin/env python
"""Mesh extents, offsets and point clouds through the PyTorch/CUDA port's
OBJ loader: the counterpart of ``tools/gen_extents.py``.

For each mesh, writes ``<stem>.extent.txt`` (the bounding box's extent),
``<stem>.offset.txt`` (its centre) and, with ``--xyz``, ``<stem>.xyz`` (the
vertices), under ``chiprun_out/extents`` unless ``--out-dir`` names another
directory. Host work only: it reads the mesh with
``vgpmp_torch.sdf.gen.load_obj`` and needs no device.

Usage: python tools/gen_extents_torch.py mesh1.obj [mesh2.obj ...] [--xyz] [--out-dir D]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vgpmp_torch.sdf.gen import load_obj  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("meshes", nargs="+", type=Path)
    ap.add_argument("--xyz", action="store_true", help="also dump vertex cloud")
    ap.add_argument("--out-dir", type=Path, default=ROOT / "chiprun_out" / "extents")
    args = ap.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    for mesh in args.meshes:
        verts, tris, piece = load_obj(mesh)
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        stem = args.out_dir / mesh.stem
        np.savetxt(f"{stem}.extent.txt", (hi - lo)[None], fmt="%.8f")
        np.savetxt(f"{stem}.offset.txt", ((hi + lo) / 2)[None], fmt="%.8f")
        if args.xyz:
            np.savetxt(f"{stem}.xyz", verts, fmt="%.6f")
        print(f"{mesh.name}: extent={np.round(hi - lo, 4).tolist()} "
              f"center={np.round((hi + lo) / 2, 4).tolist()} "
              f"({len(verts)} verts, {len(tris)} tris, {piece.max() + 1} pieces)")


if __name__ == "__main__":
    main()
