#!/usr/bin/env python
"""Scene SDF grids from scene meshes, through the PyTorch/CUDA port: the
counterpart of ``tools/gen_scene_sdfs.py``.

For each scene, ``vgpmp_torch.sdf.gen.load_obj`` reads its mesh under
``--data-dir``/scenes and ``mesh_to_sdf`` voxelizes it with kernel K5 on the
card (``--device cpu``: the plain PyTorch version), sized as the JAX tool
sizes it (``delta = max_extent / dim``, ``padding`` cells on every side).
Each grid goes to ``<out-dir>/<scene>.npz`` with its metadata in
``<scene>.json`` (``SdfGrid.save_npz``), under ``chiprun_out/scenes`` unless
``--out-dir`` names another directory; never into the JAX package's assets.

Run from the repo root:
    python tools/gen_scene_sdfs_torch.py --data-dir DATA [--scenes industrial ...]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vgpmp_torch.sdf.gen import load_obj, mesh_to_sdf  # noqa: E402
from vgpmp_torch.sdf.grid import SdfGrid  # noqa: E402

SCENES = {
    "industrial": "industrial/industrial-acd.obj",
    "bookshelves": "bookshelves/bookshelves_center.obj",
    "lab": "lab/lab.obj",
    "boxes": "boxes/boxes-acd.obj",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True, type=Path, help="holds scenes/<scene>/<mesh>.obj")
    ap.add_argument("--out-dir", default=ROOT / "chiprun_out" / "scenes", type=Path)
    ap.add_argument("--dim", type=int, default=150)
    ap.add_argument("--padding", type=int, default=25)
    ap.add_argument("--scenes", nargs="*", default=list(SCENES))
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    for name in args.scenes:
        mesh = args.data_dir / "scenes" / SCENES[name]
        verts, tris, piece = load_obj(mesh)
        t0 = time.perf_counter()
        data, origin, delta = mesh_to_sdf(verts, tris, piece, dim=args.dim, padding=args.padding,
                                          device=args.device)
        data = data.cpu().numpy()
        dt = time.perf_counter() - t0
        path = args.out_dir / f"{name}.npz"
        SdfGrid.save_npz(
            path,
            data,
            origin,
            delta,
            meta={
                "scene": name,
                "mesh": str(mesh),
                "tris": int(len(tris)),
                "pieces": int(piece.max()) + 1,
                "dims": [int(d) for d in data.shape],
                "delta": delta,
                "origin": [float(v) for v in origin],
                "min_sdf": float(data.min()),
                "max_sdf": float(data.max()),
            },
        )
        print(
            f"{name}: {data.shape} delta={delta:.4f} origin={np.round(origin, 3).tolist()} "
            f"range=[{data.min():.3f},{data.max():.3f}] ({dt:.1f}s) -> {path}"
        )


if __name__ == "__main__":
    main()
