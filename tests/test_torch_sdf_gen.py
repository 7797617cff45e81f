"""The port's mesh -> SDF pipeline (``vgpmp_torch/sdf/gen.py``) on the CPU,
in float64 inside, against the JAX package's: ``load_obj`` on an OBJ with
quads, a pentagon, negative and slashed indices and ``o``/``g`` groups;
``mesh_to_sdf`` (the plain version, ``device="cpu"``) against
``vgpmp_tpu.sdf.gen.mesh_to_sdf`` with its native voxelizer (the committed
``vgpmp_tpu/native/libsdfgen.so``) and with its numpy twin, on the unit cube,
two overlapping cubes and a 40-piece mesh of boxes and prisms
(``chip_smoke.py:synthetic_mesh``, 640 triangles); the analytic cube.

Tolerances: origin and delta equal, the shape equal, values within 1e-6 m
(both sides compute in float64 and round to float32; the native voxelizer's
bounding-sphere prune and its region order round differently), the sign
bit equal in every cell (a cell on a face of the cube is -0.0 on one side and
-5.6e-17 on the other: inside on both).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_support import cube_mesh, one_thread, two_cubes_mesh  # noqa: F401
from vgpmp_tpu.sdf import gen as jgen
from vgpmp_torch.sdf import gen as tgen

OBJ = """\
# a tetrahedron, a quad-faced box and a pentagonal prism, in three groups
o tet
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
f 1 3 2
f 1 2 4
f 1 4 3
f 2 3 4
g box
v 2 0 0
v 3 0 0
v 3 1 0
v 2 1 0
v 2 0 1
v 3 0 1
v 3 1 1
v 2 1 1
f -8/1 -5/2 -6/3 -7/4
f -4//1 -3//1 -2//1 -1//1
f 5 6 10 9
f 6 7 11 10
f 7 8 12 11
f 8 5 9 12
o prism
v 0 3 0
v 0.95 3.31 0
v 0.59 4.31 0
v -0.59 4.31 0
v -0.95 3.31 0
f 13 14 15 16 17
"""


MESHES = {
    "cube": (cube_mesh, dict(delta=0.07, padding=4)),
    "two_cubes": (two_cubes_mesh, dict(delta=0.05, padding=4)),
    "forty_pieces": (lambda: chip_smoke.synthetic_mesh(1, 40, 640, (30, 26, 18), 0.05, 3), dict(delta=0.05, padding=3)),
}


def test_load_obj_matches_jax(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ)
    ours, theirs = tgen.load_obj(path), jgen.load_obj(path)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    verts, tris, piece = ours
    # 4 + 12 (6 quads) + 3 (one pentagon) triangles in pieces 0, 1, 2
    assert len(verts) == 17 and len(tris) == 19
    np.testing.assert_array_equal(np.bincount(piece), [4, 12, 3])
    np.testing.assert_array_equal(tris[4], [4, 7, 6])  # the negative indices of the first quad


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_to_sdf_matches_jax_voxelizers(name):
    make, kw = MESHES[name]
    verts, tris, piece = make()
    data, origin, delta = tgen.mesh_to_sdf(verts, tris, piece, device="cpu", **kw)
    assert data.dtype == torch.float32 and data.device.type == "cpu"
    data = data.numpy()
    for native in (True, False):
        ref, ref_origin, ref_delta = jgen.mesh_to_sdf(verts, tris, piece, use_native=native, **kw)
        assert data.shape == ref.shape and delta == ref_delta
        np.testing.assert_array_equal(origin, ref_origin)
        np.testing.assert_allclose(data, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.signbit(data), np.signbit(ref))
    assert 0 < (data < 0).sum() < data.size


def test_sizing_from_dim_matches_jax():
    """``delta = max_extent / dim`` when no delta is given."""
    verts, tris, piece = two_cubes_mesh()
    data, origin, delta = tgen.mesh_to_sdf(verts, tris, piece, dim=12, padding=2, device="cpu")
    ref, ref_origin, ref_delta = jgen.mesh_to_sdf(verts, tris, piece, dim=12, padding=2)
    assert data.shape == ref.shape and delta == ref_delta
    np.testing.assert_array_equal(origin, ref_origin)
    np.testing.assert_allclose(data.numpy(), ref, rtol=0, atol=1e-6)


def test_voxelizer_matches_analytic_cube():
    """``tests/test_sdf.py``'s analytic case through the port."""
    v, tris, piece = cube_mesh()
    data, origin, delta = tgen.mesh_to_sdf(v, tris, piece, delta=0.05, padding=6, device="cpu")
    nx, ny, nz = data.shape
    xs = origin[0] + delta * np.arange(nx)
    ys = origin[1] + delta * np.arange(ny)
    zs = origin[2] + delta * np.arange(nz)
    P = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
    q = np.abs(P) - 0.5
    ref = np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(axis=-1), 0)
    np.testing.assert_allclose(data.numpy(), ref, atol=1e-6)


def test_plain_slabs_are_seamless():
    """The plain version's slabs of x-planes (any ``chunk``) give one grid."""
    verts, tris, piece = two_cubes_mesh()
    origin, delta, dims = tgen.grid_dims(verts, 0.05, padding=4)
    args = [torch.as_tensor(x) for x in (verts, tris, piece)] + [origin, delta, dims]
    whole = tgen.sdf_grid_plain(*args)
    for chunk in (1, dims[1] * dims[2] * 3 + 5):
        torch.testing.assert_close(tgen.sdf_grid_plain(*args, chunk=chunk), whole, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor ``sdf_grid`` takes the plain version; the K5 wrapper
    itself takes CUDA tensors only, and counts nothing it did not launch."""
    verts, tris, piece = cube_mesh()
    origin, delta, dims = tgen.grid_dims(verts, 0.1, padding=1)
    args = [torch.as_tensor(x) for x in (verts, tris, piece)] + [origin, delta, dims]
    before = tgen.k5_mesh_sdf.launches
    with pytest.raises(ValueError, match="CUDA"):
        tgen.k5_mesh_sdf(*args)
    torch.testing.assert_close(tgen.sdf_grid(*args), tgen.sdf_grid_plain(*args), rtol=0, atol=0)
    assert tgen.k5_mesh_sdf.launches == before
