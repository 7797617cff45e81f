"""Port parity: ``engine/analysis.py`` (EE uncertainty, the debug likelihood
and the SDF-gradient probe) against ``vgpmp_tpu.engine.analysis`` on the same
small float64 franka planner and the same inputs.

FK and the lookups are the same arithmetic in both packages, so values agree
to 1e-10 relative; the Jacobian is forward-mode autodiff in both (1e-10).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import planner_models
from vgpmp_tpu.engine import analysis as ja
from vgpmp_tpu.models import vgpmp as jm
from vgpmp_torch.engine import analysis as ta
from vgpmp_torch.kinematics import dh as tdh
from vgpmp_torch.models import vgpmp as tm


@pytest.fixture(scope="module")
def models():
    return planner_models()


def _configs(jspec, rng, shape):
    lo, hi = jspec.limits_low, jspec.limits_high
    return lo + (hi - lo) * rng.uniform(0.1, 0.9, shape + (len(lo),))


def test_ee_positions_is_reexported():
    assert ta.ee_positions is tdh.ee_positions


def test_ee_path_uncertainty_matches_jax(models):
    jspec, jmodel, tmodel = models
    samples = _configs(jspec, np.random.default_rng(0), (6, 11))
    want = np.asarray(ja.ee_path_uncertainty(jmodel.collision.fk, jnp.asarray(samples)))
    got = ta.ee_path_uncertainty(tmodel.collision.fk, torch.as_tensor(samples))
    assert got.shape == (11, 3) and want.shape == (11, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    # a batch axis in front: row by row the same
    batch = ta.ee_path_uncertainty(tmodel.collision.fk, torch.as_tensor(np.stack([samples, samples[::-1]])))
    np.testing.assert_allclose(batch[0].numpy(), want, rtol=1e-12, atol=1e-14)


def test_ee_jacobian_uncertainty_matches_jax(models):
    jspec, jmodel, tmodel = models
    rng = np.random.default_rng(1)
    for q, s in zip(_configs(jspec, rng, (3,)), rng.uniform(0.005, 0.05, (3, 7))):
        want = np.asarray(ja.ee_jacobian_uncertainty(jmodel.collision.fk, jnp.asarray(q), jnp.asarray(s)))
        got = ta.ee_jacobian_uncertainty(tmodel.collision.fk, torch.as_tensor(q), torch.as_tensor(s))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)
        assert got.shape == (3,) and (got > 0).all()


def test_debug_likelihood_matches_jax(models):
    jspec, jmodel, tmodel = models
    rng = np.random.default_rng(2)
    start, goal = _configs(jspec, rng, (2,))
    args = dict(lengthscales=[1.5] * 7, variance=0.2, sigma_obs=0.004, alpha=100.0)
    jp = jm.init_params(jmodel, jnp.asarray(start), jnp.asarray(goal), **args)
    tp = tm.init_params(tmodel, start, goal, **args)
    configs = _configs(jspec, rng, (5, 9))
    want = float(ja.debug_likelihood(jp, jmodel, jnp.asarray(configs)))
    got = ta.debug_likelihood(tp, tmodel, torch.as_tensor(configs))
    assert got.ndim == 0 and want < 0.0
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
    # a batch of two problems scores configs row by row
    tp2 = tp.map(lambda x: torch.cat([x, x]))
    both = ta.debug_likelihood(tp2, tmodel, torch.as_tensor(np.stack([configs, configs])))
    np.testing.assert_allclose(float(both), 2 * want, rtol=1e-10)


@pytest.mark.parametrize("mode", ["packed", "nearest", "trilinear"])
def test_sdf_gradient_at_config_matches_jax(models, mode):
    """The packed mode's stored per-voxel gradient (custom VJP in JAX,
    ``_PackedFn`` here), the nearest mode's central difference and the
    trilinear mode's autodiff."""
    jspec, jmodel, tmodel = models
    jcol, tcol = jmodel.collision, tmodel.collision
    if mode != "packed":
        jcol = jcol.replace(scene=jcol.scene.replace(mode=mode))
        tcol = dataclasses.replace(tcol, scene=dataclasses.replace(tcol.scene, mode=mode))
    for q in _configs(jspec, np.random.default_rng(3), (3,)):
        want = np.asarray(ja.sdf_gradient_at_config(jcol, jnp.asarray(q)))
        got = ta.sdf_gradient_at_config(tcol, torch.as_tensor(q))
        assert got.shape == (jspec.num_spheres, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
        assert np.abs(want).max() > 0
