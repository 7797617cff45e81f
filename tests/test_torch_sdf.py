"""Port parity: SDF packing, lookups and their gradients, composed scenes.

Small random grids (with exact-zero plateaus and bf16 rounding ties) go
through ``vgpmp_tpu.sdf``/``vgpmp_tpu.scene`` and the port on the CPU in
float64. The packed table must agree bit for bit; lookups are the same
gather of the same cell, so values agree to float64 rounding (1e-12) and
gradients to 1e-10 relative.
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

SHAPE = (20, 17, 23)
ORIGIN = np.array([-0.3, -0.2, -0.25])
DELTA = 0.03


@pytest.fixture(scope="module")
def grids():
    data = smooth_grid(np.random.default_rng(0), SHAPE)
    jgrid = jg.SdfGrid.from_arrays(data, ORIGIN, DELTA, jnp.float64)
    tgrid = tg.SdfGrid.from_arrays(data, ORIGIN, DELTA, torch.float64, "cpu")
    return data, jgrid, tgrid


def _points(rng, n=400):
    lo, hi = ORIGIN - 0.1, ORIGIN + DELTA * np.array(SHAPE) + 0.1  # includes clipped points
    return rng.uniform(lo, hi, size=(n, 3))


def test_pack_is_bit_identical(grids):
    data, jgrid, tgrid = grids
    want = np.asarray(jg.PackedSdfGrid.pack(jgrid).words)
    got = tg.PackedSdfGrid.pack(tgrid).words.numpy().view(np.uint32)
    assert want.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the planted ties and plateaus are in there
    assert (data == 0).any()


@pytest.mark.parametrize("kind", ["packed", "nearest", "trilinear"])
def test_lookup_and_gradient_match_jax(grids, kind):
    _, jgrid, tgrid = grids
    rng = np.random.default_rng(1)
    pts, w = _points(rng), rng.normal(size=400)
    if kind == "packed":
        jp, tp = jg.PackedSdfGrid.pack(jgrid), tg.PackedSdfGrid.pack(tgrid)
        jf = lambda p: jg.packed_nearest_distance(jp, p)
        tf = lambda p: tg.packed_nearest_distance(tp, p)
    elif kind == "nearest":
        jf = lambda p: jg.nearest_distance(jgrid, p)
        tf = lambda p: tg.nearest_distance(tgrid, p)
    else:
        jf = lambda p: jg.trilinear_distance(jgrid, p)
        tf = lambda p: tg.trilinear_distance(tgrid, p)
    want = np.asarray(jf(jnp.asarray(pts)))
    gwant = np.asarray(jax.grad(lambda p: jnp.sum(jnp.asarray(w) * jf(p)))(jnp.asarray(pts)))
    pt = torch.as_tensor(pts).requires_grad_()
    got = tf(pt)
    (torch.as_tensor(w) * got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pt.grad.numpy(), gwant, rtol=1e-10, atol=1e-12)


def test_central_difference_zero_replacement(grids):
    _, jgrid, tgrid = grids
    pts = _points(np.random.default_rng(2))
    for zr in (0.1, 0.0):
        np.testing.assert_allclose(
            tg.central_difference_grad(tgrid, torch.as_tensor(pts), zr).numpy(),
            np.asarray(jg.central_difference_grad(jgrid, jnp.asarray(pts), zr)), rtol=1e-12)


@pytest.mark.parametrize("mode,override", [("packed", None), ("nearest", None),
                                           ("trilinear", None), ("packed", "trilinear"),
                                           ("packed", "nearest")])
def test_scene_distance_matches_jax(grids, mode, override):
    """Scene.distance in all three modes, with an extra grid and primitives."""
    data, jgrid, tgrid = grids
    prim = dict(
        sphere_centers=np.array([[0.1, 0.0, 0.1]]), sphere_radii=np.array([0.05]),
        box_centers=np.array([[0.0, 0.1, 0.0]]), box_rotations=np.eye(3)[None],
        box_half_extents=np.array([[0.05, 0.02, 0.04]]),
        capsule_a=np.array([[0.0, 0.0, 0.0]]), capsule_b=np.array([[0.0, 0.0, 0.2]]),
        capsule_radii=np.array([0.03]),
    )
    extra = data[::2, ::2, ::2].copy()
    off, eoff = np.array([0.05, -0.02, 0.01]), np.array([[0.1, 0.1, 0.0]])
    js = jscene.Scene(
        base=jgrid, base_offset=jnp.asarray(off),
        extra_grids=(jg.SdfGrid.from_arrays(extra, ORIGIN, 2 * DELTA, jnp.float64),),
        extra_offsets=jnp.asarray(eoff),
        primitives=jscene.Primitives(**{k: jnp.asarray(v) for k, v in prim.items()}),
        mode="nearest" if mode == "packed" else mode)
    ts = tscene.Scene(
        base=tgrid, base_offset=torch.as_tensor(off),
        extra_grids=(tg.SdfGrid.from_arrays(extra, ORIGIN, 2 * DELTA, torch.float64),),
        extra_offsets=torch.as_tensor(eoff),
        primitives=tscene.Primitives(**{k: torch.as_tensor(v) for k, v in prim.items()}),
        mode="nearest" if mode == "packed" else mode)
    if mode == "packed":
        js, ts = js.packed(), ts.packed()
    pts = _points(np.random.default_rng(3))
    want = np.asarray(js.distance(jnp.asarray(pts), mode_override=override))
    got = ts.distance(torch.as_tensor(pts), mode_override=override).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
