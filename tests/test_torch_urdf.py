"""The port's URDF toolchain (``vgpmp_torch/kinematics/urdf.py``) and its
asset tools (``tools/gen_scene_sdfs_torch.py``, ``tools/gen_extents_torch.py``)
against the JAX package's, on files the tests write under ``tmp_path``.

The URDF: franka's Craig DH table and sphere set (``franka.json``) written as
a chain of revolute joints, joint i's origin at ``xyz = (a, -d sin α, d cos
α)``, ``rpy = (α, 0, 0)``, its axis along z, and each sphere a ``<visual>``
sphere of its frame's link. Both packages' ``UrdfModel`` parse it: links,
spheres, joints, chains, ``link_transform`` of every link and
``sphere_world_positions`` over seeded configurations (with and without a
base pose) equal to 1e-12; the port's DH FK (float64) gives the same sphere
positions to 1e-12.

The tools run on a mesh written from ``chip_smoke.py:synthetic_mesh`` (one
``o`` group a piece) at a small ``--dim``, the port's scene tool on the CPU
(``--device cpu``), the JAX tools in a subprocess: the same grid (float16
storage, values within one float16 rounding of 1e-6), origin, delta and
metadata, and the same extent, offset and point-cloud files.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_support import one_thread  # noqa: F401
from vgpmp_tpu.kinematics import urdf as jurdf
from vgpmp_torch import robots as trobots
from vgpmp_torch.kinematics import dh as tdh
from vgpmp_torch.kinematics import urdf as turdf

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


def _floats(*xs) -> str:
    return " ".join(repr(float(x)) for x in xs)


def _franka_urdf(path: Path) -> Path:
    spec = trobots.load_robot("franka")
    meta = spec.meta
    links = [meta["link_name_base"], *meta["active_links"]]
    lines = ['<?xml version="1.0"?>', '<robot name="franka_dh">']
    for f, link in enumerate(links):
        lines.append(f'  <link name="{link}">')
        for i in np.nonzero(np.asarray(spec.sphere_frame) == f)[0]:
            x, y, z = np.asarray(spec.sphere_offsets)[i]
            lines += [f'    <visual name="sphere_{i}">', f'      <origin xyz="{_floats(x, y, z)}" rpy="0 0 0"/>',
                      f'      <geometry><sphere radius="{_floats(np.asarray(spec.sphere_radii)[i])}"/></geometry>',
                      "    </visual>"]
        lines.append("  </link>")
    for j, (d, a, alpha) in enumerate(np.asarray(spec.dh, dtype=np.float64)):
        xyz = (a, -d * np.sin(alpha), d * np.cos(alpha))
        lines += [f'  <joint name="{meta["active_joints"][j]}" type="revolute">',
                  f'    <origin xyz="{_floats(*xyz)}" rpy="{_floats(alpha)} 0 0"/>',
                  f'    <parent link="{links[j]}"/>', f'    <child link="{links[j + 1]}"/>',
                  '    <axis xyz="0 0 1"/>', '    <limit lower="-3" upper="3" effort="1" velocity="1"/>',
                  "  </joint>"]
    lines.append("</robot>")
    out = path / "franka_dh.urdf"
    out.write_text("\n".join(lines) + "\n")
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _franka_urdf(tmp_path_factory.mktemp("urdf"))
    return trobots.load_robot("franka"), turdf.UrdfModel(str(path)), jurdf.UrdfModel(str(path))


def _configs(spec, n=4, seed=0):
    rng = np.random.default_rng(seed)
    lim = np.asarray(spec.joint_limits, dtype=np.float64)
    return rng.uniform(lim.min(axis=1), lim.max(axis=1), size=(n, spec.dof))


def test_urdf_models_parse_alike(models):
    spec, ours, theirs = models
    assert ours.name == theirs.name and ours.root_link == theirs.root_link == spec.meta["link_name_base"]
    assert list(ours.links) == list(theirs.links)
    for name, link in ours.links.items():
        other = theirs.links[name]
        assert [(s.link, s.radius, s.name) for s in link.spheres] == [(s.link, s.radius, s.name) for s in other.spheres]
        for s, t in zip(link.spheres, other.spheres):
            np.testing.assert_array_equal(s.offset, t.offset)
        assert ours.link_index(name) == theirs.link_index(name)
        assert [j.name for j in ours.chain_to(name)] == [j.name for j in theirs.chain_to(name)]
    assert len(ours.joints) == spec.dof
    for a, b in zip(ours.joints, theirs.joints):
        assert (a.name, a.joint_type, a.parent, a.child, a.index) == (b.name, b.joint_type, b.parent, b.child, b.index)
        np.testing.assert_array_equal(a.origin, b.origin)
        np.testing.assert_array_equal(a.axis, b.axis)
    spheres = ours.spheres_in_link_order()
    assert len(spheres) == len(spec.sphere_radii)
    np.testing.assert_array_equal([s.radius for s in spheres], np.asarray(spec.sphere_radii, dtype=np.float64))


@pytest.mark.parametrize("with_base", [False, True])
def test_urdf_fk_matches_jax_and_port_dh(models, with_base):
    spec, ours, theirs = models
    base = np.eye(4)
    if with_base:
        base = turdf.pose_to_matrix([0.1, -0.2, 0.3], [0.2, -0.1, 0.7])
    fk = tdh.FkModel.from_spec(spec, base, dtype=torch.float64)
    for q in _configs(spec):
        values = dict(zip(spec.meta["active_joints"], q))
        for link in ours.links:
            np.testing.assert_allclose(ours.link_transform(link, values, base),
                                       theirs.link_transform(link, values, base), rtol=0, atol=1e-12)
        pos = ours.sphere_world_positions(values, base)
        np.testing.assert_allclose(pos, theirs.sphere_world_positions(values, base), rtol=0, atol=1e-12)
        dh_pos = tdh.sphere_positions(fk, torch.as_tensor(q)).numpy()
        np.testing.assert_allclose(pos, dh_pos, rtol=0, atol=1e-12)


def test_transform_helpers_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        rpy, xyz, axis, theta = rng.normal(size=3), rng.normal(size=3), rng.normal(size=3), rng.normal()
        np.testing.assert_array_equal(turdf.rpy_to_matrix(tuple(rpy)), jurdf.rpy_to_matrix(tuple(rpy)))
        np.testing.assert_array_equal(turdf.pose_to_matrix(xyz, rpy), jurdf.pose_to_matrix(xyz, rpy))
        np.testing.assert_array_equal(turdf.axis_angle_matrix(axis, theta), jurdf.axis_angle_matrix(axis, theta))


def _write_obj(path: Path, verts, tris, piece) -> Path:
    lines = [f"v {_floats(*v)}" for v in verts]
    for p in range(int(piece.max()) + 1):
        lines.append(f"o piece{p}")
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris[piece == p]]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def _jax_tool(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, *map(str, args)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]


def test_scene_sdf_tool_matches_jax_tool(tmp_path):
    import gen_scene_sdfs_torch

    verts, tris, piece = chip_smoke.synthetic_mesh(4, 9, 130, (24, 28, 16), 0.05, 3)
    _write_obj(tmp_path / "data" / "scenes" / "boxes" / "boxes-acd.obj", verts, tris, piece)
    common = ["--data-dir", tmp_path / "data", "--dim", "20", "--padding", "3", "--scenes", "boxes"]
    gen_scene_sdfs_torch.main([*map(str, common), "--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    _jax_tool(ROOT / "tools" / "gen_scene_sdfs.py", *common, "--out-dir", tmp_path / "jax")
    with np.load(tmp_path / "port" / "boxes.npz") as a, np.load(tmp_path / "jax" / "boxes.npz") as b:
        assert a["data"].dtype == b["data"].dtype == np.float16 and a["data"].shape == b["data"].shape
        np.testing.assert_allclose(a["data"].astype(np.float32), b["data"].astype(np.float32), rtol=2 ** -10, atol=1e-6)
        np.testing.assert_array_equal(a["origin"], b["origin"])
        assert float(a["delta"]) == float(b["delta"])
    ours, theirs = (json.loads((tmp_path / d / "boxes.json").read_text()) for d in ("port", "jax"))
    assert ours.keys() == theirs.keys()
    for k in ("scene", "mesh", "tris", "pieces", "dims", "delta", "origin"):
        assert ours[k] == theirs[k], k
    assert ours["pieces"] == 9 and ours["tris"] == 130
    for k in ("min_sdf", "max_sdf"):
        assert abs(ours[k] - theirs[k]) <= 1e-6, k


def test_scene_sdf_tool_needs_a_data_dir():
    """No default data directory: the tool refuses to run without one."""
    import gen_scene_sdfs_torch

    with pytest.raises(SystemExit):
        gen_scene_sdfs_torch.main(["--scenes", "boxes"])


def test_extents_tool_matches_jax_tool(tmp_path):
    import gen_extents_torch

    verts, tris, piece = chip_smoke.synthetic_mesh(5, 4, 56, (20, 20, 20), 0.05, 2)
    mesh = _write_obj(tmp_path / "mesh.obj", verts, tris, piece)
    gen_extents_torch.main([str(mesh), "--xyz", "--out-dir", str(tmp_path / "port")])
    _jax_tool(ROOT / "tools" / "gen_extents.py", mesh, "--xyz", "--out-dir", tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["mesh.extent.txt", "mesh.offset.txt", "mesh.xyz"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names:
        assert (tmp_path / "port" / n).read_text() == (tmp_path / "jax" / n).read_text(), n
