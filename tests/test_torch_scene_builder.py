"""Port parity: the named-object registry (``SceneBuilder``, ``OBJECT_LIBRARY``)
and the composed scene's distance and gradient, against ``vgpmp_tpu.scene``.

Float64 throughout. The registry's bookkeeping must be equal; distances of
the built scenes agree to 1e-12 in the packed, nearest and trilinear modes;
the spatial gradient of a hinge on the composed distance agrees with
``jax.grad`` to 1e-12, with NaN in the same places: JAX's
``jnp.linalg.norm`` has a NaN gradient at the zero vector, so every point
inside or on a box (and at a sphere primitive's centre or on a capsule's
segment) has a NaN gradient in both packages, whatever source attains the
minimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import smooth_grid
from vgpmp_tpu import scene as jscene
from vgpmp_tpu.sdf import grid as jg
from vgpmp_torch import scene as tscene
from vgpmp_torch.sdf import grid as tg

BASE = (smooth_grid(np.random.default_rng(2), (24, 22, 20), scale=1.0) + np.float32(0.15),
        np.array([-1.0, -1.1, -0.3]), 0.09)
BLOB = (smooth_grid(np.random.default_rng(3), (12, 14, 10), scale=0.6) - np.float32(0.05),
        np.array([-0.25, -0.3, -0.2]), 0.05)
CAN = {"kind": "capsule", "radius": 0.1, "height": 0.5}
# segment 0.15 - 0.2 < 0, clipped to 0: a zero-length segment, whose distance
# is 0/0 = NaN everywhere in both packages (ROADMAP.md Queue 3)
STUB = {"kind": "capsule", "radius": 0.1, "height": 0.15}


def _grids(arrays):
    data, origin, delta = arrays
    return (jg.SdfGrid.from_arrays(data, origin, delta, jnp.float64),
            tg.SdfGrid.from_arrays(data, origin, delta, torch.float64))


def _builders(mode="nearest", base_offset=(0.05, -0.02, 0.01)):
    """The same objects in both packages' builders: every library name, a
    grid object and an explicit spec."""
    jbase, tbase = _grids(BASE)
    jblob, tblob = _grids(BLOB)
    jb = jscene.SceneBuilder(base=jbase, base_offset=base_offset, mode=mode, dtype=jnp.float64)
    tb = tscene.SceneBuilder(base=tbase, base_offset=base_offset, mode=mode, dtype=torch.float64,
                             device="cpu")
    for b, blob in ((jb, jblob), (tb, tblob)):
        b.add_object("cube", [0.9, 0.0, -0.2])
        b.add_object("table", [-0.3, 0.4, -0.4])
        b.add_object("duck", [-0.6, 0.3, 0.175])  # its centre in the table's top, and deeper
        b.add_object("pringles", [-0.5, -0.4, 0.0])
        b.add_object("blob", [0.2, 0.3, 0.35], grid=blob)
        b.add_object("can", [0.5, 0.5, 0.2], spec=CAN)
    return jb, tb


def _points(n=3000, seed=0):
    """Seeded points over the scene, plus 200 within 0.06 m of the duck's
    centre (a small target for uniform points)."""
    rng = np.random.default_rng(seed)
    duck = np.array([-0.6, 0.3, 0.225])
    return np.concatenate([rng.uniform([-1.2, -1.2, -0.5], [1.4, 1.1, 1.2], size=(n, 3)),
                           duck + rng.uniform(-0.035, 0.035, size=(200, 3))])


def test_registry_matches_jax():
    jb, tb = _builders()
    assert tb.names == jb.names == ["cube", "table", "duck", "pringles", "blob", "can"]
    for name in jb.names:
        assert tb.get_object_index_by_name(name) == jb.get_object_index_by_name(name)
        jo, to = jb.get_object_by_name(name), tb.get_object_by_name(name)
        assert (to.kind, to.spec) == (jo.kind, jo.spec)
        np.testing.assert_array_equal(to.position, jo.position)
    assert tb.get_object_by_index(4).name == jb.get_object_by_index(4).name == "blob"
    assert tb.get_object_by_index(4).kind == "grid"
    for b in (jb, tb):
        b.move_object("duck", [0.1, 0.2, 0.3])
        b.remove_object("cube")
        b.remove_object_by_index(2)  # pringles, after the cube went
    assert tb.names == jb.names == ["table", "duck", "blob", "can"]
    np.testing.assert_array_equal(tb.get_object_by_name("duck").position,
                                  jb.get_object_by_name("duck").position)
    for fn in (lambda b: b.get_object_index_by_name("cube"), lambda b: b.remove_object("cube")):
        with pytest.raises(KeyError):
            fn(tb)
        with pytest.raises(KeyError):
            fn(jb)
    assert tscene.OBJECT_LIBRARY == jscene.OBJECT_LIBRARY


def test_unknown_object_error_matches_jax():
    jb, tb = _builders()
    errs = []
    for b in (jb, tb):
        with pytest.raises(KeyError) as info:
            b.add_object("teapot", [0, 0, 0])
        errs.append(str(info.value))
    assert errs[0] == errs[1] and "teapot" in errs[1] and "pringles" in errs[1]
    assert tb.names == jb.names  # nothing added


def test_build_places_objects_as_jax():
    """``local_z``, the capsule's segment (``height - 2r``, clipped at 0), the
    grid object's offset and the base offset, field by field."""
    jb, tb = _builders()
    js, ts = jb.build(), tb.build()
    for f in ("sphere_centers", "sphere_radii", "box_centers", "box_rotations", "box_half_extents",
              "capsule_a", "capsule_b", "capsule_radii"):
        got, want = getattr(ts.primitives, f), np.asarray(getattr(js.primitives, f))
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    np.testing.assert_array_equal(ts.extra_offsets.numpy(), np.asarray(js.extra_offsets))
    np.testing.assert_array_equal(ts.base_offset.numpy(), np.asarray(js.base_offset))
    assert ts.mode == js.mode == "nearest" and len(ts.extra_grids) == 1
    for b in (jb, tb):
        b.add_object("stub", [0.0, 0.0, 0.0], spec=STUB)
    js, ts = jb.build(), tb.build()
    for f in ("capsule_a", "capsule_b"):
        np.testing.assert_array_equal(getattr(ts.primitives, f).numpy(), np.asarray(getattr(js.primitives, f)))
    np.testing.assert_array_equal(ts.primitives.capsule_a[2].numpy(), ts.primitives.capsule_b[2].numpy())
    pts = _points(50)
    assert np.isnan(np.asarray(js.distance(jnp.asarray(pts)))).all()
    assert torch.isnan(ts.distance(torch.as_tensor(pts))).all()


@pytest.mark.parametrize("mode", ["packed", "nearest", "trilinear"])
def test_built_scene_distance_matches_jax(mode):
    """The built scenes at seeded points, in the builder's mode and with the
    trilinear override the metric takes: 1e-12. Every source attains the
    minimum somewhere."""
    from _torch_support import source_wins

    jb, tb = _builders(mode)
    js, ts = jb.build(), tb.build()
    assert ts.mode == js.mode == mode
    pts = _points()
    for override in (None, "trilinear"):
        want = np.asarray(js.distance(jnp.asarray(pts), mode_override=override))
        got = ts.distance(torch.as_tensor(pts), mode_override=override).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    wins = source_wins(ts, torch.as_tensor(pts))
    assert len(wins) == 5 and min(wins.values()) > 0, wins


def test_moved_object_distance_matches_jax():
    jb, tb = _builders()
    for b in (jb, tb):
        b.move_object("blob", [-0.4, 0.1, 0.5])
        b.move_object("table", [0.2, -0.3, -0.5])
    pts = _points(seed=1)
    want = np.asarray(jb.build().distance(jnp.asarray(pts)))
    np.testing.assert_allclose(tb.build().distance(torch.as_tensor(pts)).numpy(), want, rtol=0, atol=1e-12)


def _hinge_grads(jsc, tsc, pts, eps=0.05):
    """Per point, the gradient of ``max(eps - d, 0)^2`` in both packages."""
    jf = jax.vmap(jax.grad(lambda p: jnp.maximum(eps - jsc.distance(p), 0.0) ** 2))
    want = np.asarray(jf(jnp.asarray(pts)))
    x = torch.as_tensor(pts).clone().requires_grad_()
    (torch.clamp(eps - tsc.distance(x), min=0.0) ** 2).sum().backward()
    return x.grad.numpy(), want


def test_box_gradient_nan_matches_jax():
    """Repair (0): a unit box at the origin alone. Inside (d = -0.3) and on the
    surface the gradient is NaN in both; outside it is the same number."""
    base = _grids((np.full((6, 6, 6), 5.0), np.array([-3.0] * 3), 1.0))
    prim = dict(box_centers=np.zeros((1, 3)), box_rotations=np.eye(3)[None],
                box_half_extents=np.full((1, 3), 0.5))
    jsc = jscene.Scene(base=base[0], base_offset=jnp.zeros(3),
                       primitives=jscene.Primitives.empty(jnp.float64).replace(
                           **{k: jnp.asarray(v) for k, v in prim.items()}))
    e = tscene.Primitives.empty(torch.float64)
    tsc = tscene.Scene(base=base[1], base_offset=torch.zeros(3, dtype=torch.float64),
                       primitives=tscene.Primitives(e.sphere_centers, e.sphere_radii,
                                                    *(torch.as_tensor(prim[k]) for k in
                                                      ("box_centers", "box_rotations", "box_half_extents")),
                                                    e.capsule_a, e.capsule_b, e.capsule_radii))
    pts = np.array([[0.1, 0.2, 0.05], [0.9, 0.2, 0.05], [0.5, 0.1, -0.2], [0.52, 0.56, 0.0]])
    np.testing.assert_allclose(tsc.distance(torch.as_tensor(pts)).numpy(), [-0.3, 0.4, 0.0, np.hypot(0.02, 0.06)],
                               atol=1e-12)
    got, want = _hinge_grads(jsc, tsc, pts)
    assert np.isnan(want[[0, 2]]).all() and np.isfinite(want[[1, 3]]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[[1, 3]], want[[1, 3]], rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["packed", "nearest", "trilinear"])
def test_composed_gradient_nan_pattern_matches_jax(mode):
    """The built scene at seeded points plus planted ones: inside the cube
    where the cube attains the minimum, inside the table where the blob
    grid is deeper, at the duck's centre and on the pringles segment. The
    NaN pattern is equal point for point and the finite gradients agree to
    1e-12."""
    jb, tb = _builders(mode)
    js, ts = jb.build(), tb.build()
    cube = tb.get_object_by_name("cube").position
    duck = np.asarray(ts.primitives.sphere_centers[0])
    seg = 0.5 * (ts.primitives.capsule_a[0] + ts.primitives.capsule_b[0]).numpy()
    planted = np.array([cube + [0.1, -0.05, 0.2], duck, seg])
    pts = np.concatenate([planted, _points(2000, seed=3)])
    # a point inside the table where another source is deeper
    table = np.asarray(ts.primitives.box_centers[1])
    cand = table + np.random.default_rng(4).uniform([-0.7, -0.45, -0.025], [0.7, 0.45, 0.025], (4000, 3))
    t = torch.as_tensor(cand)
    srcs = dict(ts.sources(t))
    deeper = torch.stack([d for k, d in srcs.items() if k != "boxes"]).amin(0) < srcs["boxes"]
    assert deeper.any()
    pts = np.concatenate([pts, cand[deeper.numpy()][:5]])
    got, want = _hinge_grads(js, ts, pts)
    nan = np.isnan(want).any(-1)
    assert nan[:3].all() and nan[-5:].all() and nan.sum() > 20
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=1e-12)
