"""Port parity: ``SdfGrid``'s reference-format I/O, transforms, the mode
dispatch and the numpy twins, against ``vgpmp_tpu.sdf.grid``.

A grid that either package writes in the SDFGen text format (``%.6g``) is
read by the other as the writer's own package reads it, to 1e-6 (they are
equal), and as the written grid to the format's six significant digits
(5e-6 relative). Transforms are exact float64 arithmetic on the same
numbers (1e-12); lookups gather the same cell (1e-12, gradients 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import smooth_grid
from vgpmp_tpu import sdf as jsdf
from vgpmp_tpu.sdf import grid as jg
from vgpmp_torch import sdf as tsdf
from vgpmp_torch.sdf import grid as tg

SHAPE = (9, 7, 11)
ORIGIN = np.array([-0.31, 0.12, -0.25])
DELTA = 0.035


@pytest.fixture(scope="module")
def data():
    return smooth_grid(np.random.default_rng(3), SHAPE)


@pytest.fixture(scope="module")
def grids(data):
    return (jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jnp.float64),
            tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, torch.float64, "cpu"))


def _points(rng, n=300):
    lo, hi = ORIGIN - 0.1, ORIGIN + DELTA * np.array(SHAPE) + 0.1  # includes clipped points
    return rng.uniform(lo, hi, size=(n, 3))


def _assert_grid(tgrid, data, origin, delta, tol):
    np.testing.assert_allclose(tgrid.data.numpy(), np.asarray(data), rtol=0, atol=tol)
    np.testing.assert_allclose(tgrid.origin.numpy(), np.asarray(origin), rtol=0, atol=tol)
    np.testing.assert_allclose(float(tgrid.delta), float(delta), rtol=0, atol=tol)


def test_package_exports_jax_names():
    assert tsdf.__all__ == jsdf.__all__
    assert tsdf.distance is tg.distance and tsdf.SdfGrid is tg.SdfGrid


def test_jax_text_is_read_by_the_port(grids, data, tmp_path):
    jgrid, _ = grids
    path = tmp_path / "jax.sdf"
    jgrid.to_sdf_text(path)
    got = tg.SdfGrid.from_sdf_text(path, torch.float64, "cpu")
    assert got.shape == SHAPE and got.data.dtype == torch.float64
    want = jg.SdfGrid.from_sdf_text(path, jnp.float64)
    _assert_grid(got, want.data, want.origin, want.delta, 1e-6)
    np.testing.assert_allclose(got.data.numpy(), data, rtol=5e-6, atol=1e-12)
    np.testing.assert_allclose(got.origin.numpy(), ORIGIN, rtol=5e-6)


def test_port_text_is_read_by_jax(grids, data, tmp_path):
    _, tgrid = grids
    path = tmp_path / "port.sdf"
    tgrid.to_sdf_text(path)
    got = jg.SdfGrid.from_sdf_text(path, jnp.float64)
    mine = tg.SdfGrid.from_sdf_text(path, torch.float64, "cpu")
    _assert_grid(mine, got.data, got.origin, got.delta, 1e-6)
    np.testing.assert_allclose(np.asarray(got.data), data, rtol=5e-6, atol=1e-12)
    # the header and the x-fastest body are the JAX writer's, byte for byte
    jpath = tmp_path / "jax.sdf"
    grids[0].to_sdf_text(jpath)
    assert path.read_text() == jpath.read_text()


def test_text_round_trip_keeps_dtype_and_device(grids, tmp_path):
    path = tmp_path / "g.sdf"
    grids[1].to_sdf_text(path)
    g32 = tg.SdfGrid.from_sdf_text(path)
    assert g32.data.dtype == torch.float32 and g32.data.device.type == "cpu"
    assert g32.shape == SHAPE


def test_resized_matches_jax(grids):
    jgrid, tgrid = grids
    want, got = jgrid.resized(1.7), tgrid.resized(1.7)
    _assert_grid(got, want.data, want.origin, want.delta, 1e-12)
    assert got.data.dtype == torch.float64


@pytest.mark.parametrize("lo,hi", [((1, 0, 2), (8, 7, 9)), ((0, 2, 0), (4, 5, 11))])
def test_trimmed_matches_jax(grids, lo, hi):
    jgrid, tgrid = grids
    want, got = jgrid.trimmed(lo, hi), tgrid.trimmed(np.array(lo), np.array(hi))
    assert got.shape == tuple(want.data.shape)
    _assert_grid(got, want.data, want.origin, want.delta, 1e-12)
    # the trimmed grid reads what the full grid reads inside the box
    rng = np.random.default_rng(5)
    inner = np.asarray(want.origin) + DELTA * (rng.uniform(0.5, 1.0, (50, 3)) * (np.array(hi) - np.array(lo) - 1))
    np.testing.assert_allclose(tg.trilinear_distance(got, torch.as_tensor(inner)).numpy(),
                               tg.trilinear_distance(tgrid, torch.as_tensor(inner)).numpy(), atol=1e-12)


def test_save_npz_loads_in_both(data, tmp_path):
    path = tmp_path / "scene.npz"
    tg.SdfGrid.save_npz(path, data, ORIGIN, DELTA, meta={"source": "test"})
    jpath = tmp_path / "jax_scene.npz"
    jg.SdfGrid.save_npz(jpath, data, ORIGIN, DELTA, meta={"source": "test"})
    with np.load(path) as a, np.load(jpath) as b:
        assert a["data"].dtype == np.float16
        for k in ("data", "origin", "delta"):
            np.testing.assert_array_equal(a[k], b[k])
    assert path.with_suffix(".json").read_text() == jpath.with_suffix(".json").read_text()
    got = tg.SdfGrid.load(path, torch.float64, "cpu")
    want = jg.SdfGrid.load(path, jnp.float64)
    _assert_grid(got, want.data, want.origin, want.delta, 0.0)
    np.testing.assert_allclose(got.data.numpy(), data, atol=2e-3)  # float16 storage


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_distance_dispatch_matches_jax(grids, mode):
    jgrid, tgrid = grids
    rng = np.random.default_rng(7)
    pts, w = _points(rng), rng.normal(size=300)
    want = jg.distance(jgrid, jnp.asarray(pts), mode)
    want_g = jax.grad(lambda p: jnp.sum(jg.distance(jgrid, p, mode) * w))(jnp.asarray(pts))
    p = torch.tensor(pts, requires_grad=True)
    got = tg.distance(tgrid, p, mode)
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-10, atol=1e-12)


def test_distance_refuses_unknown_mode(grids):
    jgrid, tgrid = grids
    pts = np.zeros((2, 3))
    with pytest.raises(ValueError, match="unknown SDF mode 'packed'") as jerr:
        jg.distance(jgrid, jnp.asarray(pts), "packed")
    with pytest.raises(ValueError, match="unknown SDF mode 'packed'") as terr:
        tg.distance(tgrid, torch.as_tensor(pts), "packed")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("zero_replacement", [0.1, 0.0])
def test_numpy_twins_match_jax(data, zero_replacement):
    data = data.astype(np.float64)
    rng = np.random.default_rng(11)
    pts = _points(rng)
    np.testing.assert_array_equal(tg.nearest_distance_np(data, ORIGIN, DELTA, pts),
                                  jg.nearest_distance_np(data, ORIGIN, DELTA, pts))
    got = tg.central_difference_grad_np(data, ORIGIN, DELTA, pts, zero_replacement)
    np.testing.assert_array_equal(got, jg.central_difference_grad_np(data, ORIGIN, DELTA, pts,
                                                                     zero_replacement))
    # the twins agree with the port's tensor lookups
    tgrid = tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, torch.float64, "cpu")
    np.testing.assert_allclose(got, tg.central_difference_grad(tgrid, torch.as_tensor(pts),
                                                               zero_replacement).numpy(), atol=1e-12)
