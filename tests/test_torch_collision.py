"""Port parity: forward kinematics and the collision likelihood (plain and K1).

FK on all four robots against ``vgpmp_tpu.kinematics.dh`` and its numpy twin;
``CollisionModel.log_prob`` and ``∂/∂q`` against ``jax.grad`` on a small
random scene in float64 (same cells gathered, so 1e-10 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import smooth_grid
from vgpmp_tpu import robots as jrobots
from vgpmp_tpu import scene as jscene
from vgpmp_tpu.kinematics import dh as jdh
from vgpmp_tpu.likelihoods import collision as jcol
from vgpmp_tpu.sdf import grid as jg
from vgpmp_torch import robots as trobots
from vgpmp_torch import scene as tscene
from vgpmp_torch.kinematics import dh as tdh
from vgpmp_torch.likelihoods import collision as tcol
from vgpmp_torch.sdf import grid as tg

ORIGIN = np.array([-1.2, -1.2, -0.6])
DELTA = 0.06
SHAPE = (40, 40, 36)
BASE = np.eye(4)
BASE[:3, 3] = [0.05, -0.1, 0.02]


def _configs(spec, rng, n):
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    return rng.uniform(lo, hi, size=(n, spec.dof))


@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_sphere_positions_match_jax_and_numpy(robot):
    jspec, tspec = jrobots.load_robot(robot), trobots.load_robot(robot)
    np.testing.assert_array_equal(tspec.sphere_offsets, jspec.sphere_offsets)
    q = _configs(jspec, np.random.default_rng(0), 64)
    jfk = jdh.FkModel.from_spec(jspec, BASE, dtype=jnp.float64)
    tfk = tdh.FkModel.from_spec(tspec, BASE, dtype=torch.float64, device="cpu")
    want = np.asarray(jdh.sphere_positions(jfk, jnp.asarray(q)))
    got = tdh.sphere_positions(tfk, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(tdh.sphere_positions_frames(tfk, torch.as_tensor(q)).numpy(),
                               want, rtol=1e-10, atol=1e-12)
    np_twin = np.stack([jdh.sphere_positions_np(jspec, BASE, qi) for qi in q[:8]])
    np.testing.assert_allclose(got[:8], np_twin, rtol=1e-10, atol=1e-12)
    ee = np.asarray(jdh.fk_frames(jfk, jnp.asarray(q))[..., -1, :3, 3])
    np.testing.assert_allclose(tdh.ee_positions(tfk, torch.as_tensor(q)).numpy(), ee,
                               rtol=1e-10, atol=1e-12)


def _models(robot, dtype_j=jnp.float64, dtype_t=torch.float64, device="cpu", origin=ORIGIN,
            delta=DELTA):
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    off = np.array([0.1, 0.0, -0.05])
    jspec, tspec = jrobots.load_robot(robot), trobots.load_robot(robot)
    jsc = jscene.Scene(base=jg.SdfGrid.from_arrays(data, origin, delta, dtype_j),
                       base_offset=jnp.asarray(off, dtype_j)).packed()
    tsc = tscene.Scene(base=tg.SdfGrid.from_arrays(data, origin, delta, dtype_t, device),
                       base_offset=torch.as_tensor(off, dtype=dtype_t, device=device)).packed()
    jm = jcol.CollisionModel(fk=jdh.FkModel.from_spec(jspec, BASE, dtype=dtype_j), scene=jsc,
                             epsilon=jnp.asarray(0.05, dtype_j))
    tm = tcol.CollisionModel(fk=tdh.FkModel.from_spec(tspec, BASE, dtype=dtype_t, device=device),
                             scene=tsc, epsilon=0.05)
    return jspec, jm, tm


@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_log_prob_and_grad_match_jax(robot):
    jspec, jm, tm = _models(robot)
    rng = np.random.default_rng(1)
    q = _configs(jspec, rng, 3 * 40).reshape(3, 40, jspec.dof)
    sigma = rng.uniform(0.004, 0.006, size=(3, jspec.num_spheres))
    jf = jax.vmap(lambda qb, sb: jm.log_prob(qb, sb))
    want = np.asarray(jf(jnp.asarray(q), jnp.asarray(sigma)))
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jf(x, jnp.asarray(sigma))))(jnp.asarray(q)))
    qt = torch.as_tensor(q).requires_grad_()
    got = tm.log_prob(qt, torch.as_tensor(sigma))
    got.sum().backward()
    assert (want < 0).mean() > 0.2  # the hinge is active for a good share of configs
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(qt.grad.numpy(), gwant, rtol=1e-9, atol=1e-8)
    # hinge cost and clearance along the way
    np.testing.assert_allclose(tm.hinge_cost(torch.as_tensor(q[0])).numpy(),
                               np.asarray(jm.hinge_cost(jnp.asarray(q[0]))), rtol=1e-10, atol=1e-12)


def test_joint_sigmoid_round_trip_matches_jax():
    spec = jrobots.load_robot("franka")
    lo, hi = spec.limits_low, spec.limits_high
    f = np.random.default_rng(2).normal(size=(5, spec.dof)) * 2
    want = np.asarray(jcol.joint_sigmoid(jnp.asarray(f), jnp.asarray(lo), jnp.asarray(hi)))
    got = tcol.joint_sigmoid(torch.as_tensor(f), torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    back = tcol.joint_sigmoid_inverse(got, torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_allclose(back.numpy(), f, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_clearance_eval_matches_jax_inside_and_outside_the_grid(robot):
    """The metric's trilinear clearance, per sphere and its minimum, on a grid
    smaller than the arm's reach, so that sphere centres leave it on all six
    sides and the border clamps are exercised; float64, 1e-12."""
    origin, delta = np.array([-0.2, -0.3, 0.1]), 0.015
    jspec, jm, tm = _models(robot, origin=origin, delta=delta)
    q = _configs(jspec, np.random.default_rng(4), 3 * 50).reshape(3, 50, jspec.dof)
    rel = (tdh.sphere_positions(tm.fk, torch.as_tensor(q)) - tm.scene.base_offset).numpy() - origin
    top = delta * (np.array(SHAPE) - 1)
    assert (rel < 0).any(axis=(0, 1, 2)).all() and (rel > top).any(axis=(0, 1, 2)).all()
    assert ((rel > 0) & (rel < top)).all(axis=-1).any()
    want = np.asarray(jm.sphere_clearance_eval(jnp.asarray(q)))
    got = tm.sphere_clearance_eval(torch.as_tensor(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.min_clearance_eval(torch.as_tensor(q)).numpy(), want.min(-1),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(tcol.min_clearance_eval_plain(tm, torch.as_tensor(q)),
                               got.min(dim=-1).values, rtol=0, atol=0)
