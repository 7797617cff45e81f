"""K5's source (``vgpmp_torch/csrc/k5_mesh_sdf.cuh``) on the CPU, held to the
port's plain version (``vgpmp_torch.sdf.gen.sdf_grid_plain``) and to the JAX
package's native voxelizer (``vgpmp_tpu.sdf.gen.mesh_to_sdf``, the committed
``vgpmp_tpu/native/libsdfgen.so``).

The header is compiled here by g++ against ``tests/k2_cpu/`` (a stub of what
the kernel takes from CUDA: a block as its 128 threads, ``__syncthreads`` a
barrier, dynamic shared memory one array poisoned past the launch's bytes)
and called through ``ctypes`` (``k2_cpu/k5_cpu.cpp``), with the triangles
handed over as ``vgpmp_torch.sdf.gen.k5_mesh_sdf`` hands them to the card's
(their vertices in float64, sorted by piece). The meshes: the unit cube, two
overlapping cubes, a 40-piece mesh of boxes and prisms with more triangles
than the kernel's shared-memory tile (640 against ``TILE``), and the two
cubes stretched along x, whose grid is longer in x than a block's span
(``SPAN``), so that a column takes two blocks.

Tolerances: values within 1e-6 m of both references (float64 inside, float32
out; the host voxelizer's bounding-sphere prune rounds otherwise), the sign
bit equal in every cell.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_support import cube_mesh, one_thread, two_cubes_mesh  # noqa: F401
from vgpmp_tpu.sdf import gen as jgen
from vgpmp_torch.sdf import gen as tgen

CSRC = Path(__file__).resolve().parents[1] / "vgpmp_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "k2_cpu"
MESHES = {
    "cube": (cube_mesh, dict(delta=0.07, padding=4)),
    "two_cubes": (two_cubes_mesh, dict(delta=0.05, padding=4)),
    "forty_pieces_tiled": (lambda: chip_smoke.synthetic_mesh(1, 40, 640, (30, 26, 18), 0.05, 3),
                           dict(delta=0.05, padding=3)),
    "two_blocks_a_column": (lambda: two_cubes_mesh((4.0, 0.1, 0.1)), dict(delta=0.01, padding=1)),
}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\w+);", (CSRC / "k5_mesh_sdf.cuh").read_text()).group(1))


@pytest.fixture(scope="module")
def k5cpu(tmp_path_factory):
    """The kernel's source built for the CPU (g++, C++20, threads)."""
    d = tmp_path_factory.mktemp("k5_cpu")
    launch = (CSRC / "launch.cuh").read_text()
    call = "kernel<<<grid, block, smem, st>>>(args...);"
    assert call in launch
    (d / "launch.cuh").write_text(launch.replace(call, "k2_cpu_launch(kernel, grid, block, smem, args...);"))
    for f in ("k5_mesh_sdf.cuh", "kernels.h"):
        shutil.copy(CSRC / f, d)
    so = d / "k5_cpu.so"
    cmd = ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{STUB}",
           str(STUB / "k5_cpu.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.k5_f64.argtypes = [P, P, ctypes.c_longlong, P, P, P]
    return lib


def k5_run(lib, verts, tris, piece, origin, delta, dims) -> np.ndarray:
    """The CPU build of K5 on the grid ``(origin, delta, dims)``."""
    piece, order = torch.sort(torch.as_tensor(piece, dtype=torch.int32), stable=True)
    tri = torch.as_tensor(verts, dtype=torch.float64)[torch.as_tensor(tris).long()[order]].reshape(-1, 9).contiguous()
    grid = torch.tensor([*origin, delta], dtype=torch.float64)
    shape = torch.tensor(dims, dtype=torch.int32)
    out = torch.full(tuple(dims), float("nan"), dtype=torch.float32)
    rc = lib.k5_f64(tri.data_ptr(), piece.contiguous().data_ptr(), tri.shape[0], grid.data_ptr(),
                    shape.data_ptr(), out.data_ptr())
    assert rc == 0
    return out.numpy()


def test_cases_reach_the_tile_and_the_span():
    """The 40-piece mesh has more triangles than a tile, and the long grid more
    cells along x than a block spans."""
    assert len(MESHES["forty_pieces_tiled"][0]()[1]) > _constant("TILE")
    span = _constant("THREADS") * _constant("CELLS")  # the source's SPAN
    verts = MESHES["two_blocks_a_column"][0]()[0]
    assert span < tgen.grid_dims(verts, 0.01, padding=1)[2][0] <= 2 * span


@pytest.mark.parametrize("name", list(MESHES))
def test_k5_source_matches_plain_and_native(k5cpu, name):
    make, kw = MESHES[name]
    verts, tris, piece = make()
    origin, delta, dims = tgen.grid_dims(verts, padding=kw["padding"], delta=kw["delta"])
    got = k5_run(k5cpu, verts, tris, piece, origin, delta, dims)
    assert np.isfinite(got).all()
    plain = tgen.sdf_grid_plain(*(torch.as_tensor(x) for x in (verts, tris, piece)), origin, delta, dims).numpy()
    native, n_origin, n_delta = jgen.mesh_to_sdf(verts, tris, piece, use_native=True, **kw)
    np.testing.assert_array_equal(origin, n_origin)
    assert delta == n_delta and native.shape == tuple(dims)
    for ref in (plain, native):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))
    assert 0 < (got < 0).sum() < got.size
