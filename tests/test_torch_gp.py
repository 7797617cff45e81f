"""Port parity: GP building blocks not reached alone by the model tests.

float64 on the CPU against ``vgpmp_tpu.gp``; same formulas in the same
order, so 1e-12 relative unless a line says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vgpmp_tpu.gp import conditioned as jc
from vgpmp_tpu.gp import pathwise as jp
from vgpmp_tpu.ops import kernels as jk
from vgpmp_torch.gp import conditioned as tc
from vgpmp_torch.gp import pathwise as tp
from vgpmp_torch.ops import kernels as tk


def test_student_t_matches_jax_given_its_uniforms():
    key = jax.random.PRNGKey(4)
    want = np.asarray(jp.student_t(key, 5.0, (7, 64), jnp.float64))
    k1, k2 = jax.random.split(key)
    u = 1.0 - np.array(jax.random.uniform(k1, (7, 64), dtype=jnp.float64))
    v = np.array(jax.random.uniform(k2, (7, 64), dtype=jnp.float64))
    got = tp.student_t(5.0, (7, 64), torch.float64, "cpu", u=torch.as_tensor(u), v=torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_student_t_draws_have_the_t5_spread():
    """Own draws: Student-t(5) has variance 5/3 (5% at 200k draws)."""
    x = tp.student_t(5.0, (200_000,), torch.float64, "cpu", torch.Generator().manual_seed(0))
    assert abs(x.var().item() - 5.0 / 3.0) < 0.05 * 5.0 / 3.0


def test_whitened_scale_matches_jax():
    rng = np.random.default_rng(0)
    G = rng.normal(size=(3, 6, 6))
    chol = np.linalg.cholesky(G @ np.swapaxes(G, -1, -2) + 6 * np.eye(6))
    q_sqrt = rng.normal(size=(3, 4, 4))
    want = np.asarray(jp.whitened_scale(jnp.asarray(chol), jnp.asarray(q_sqrt), 1e-3))
    got = tp.whitened_scale(torch.as_tensor(chol), torch.as_tensor(q_sqrt), 1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_cholesky_kuu_escalation_and_telemetry_match_jax():
    """Duplicated inducing times make latents 0 and 2 singular; a negative
    jitter makes their factors NaN through every retry of the escalation
    chain (a deterministic failure, where zero jitter would hinge on
    rounding). Both packages report the same failed rows and count, and
    agree on the healthy latent."""
    ny = np.array([0.0, 1.0])
    Z = np.linspace(0.2, 0.8, 4)[:, None].repeat(3, axis=1)
    Z[1, 0] = Z[0, 0]
    Z[2, 2] = Z[3, 2]
    ls, var = np.array([0.3, 0.4, 0.5]), np.array([1.0, 1.2, 0.8])
    for jitter, esc in ((1e-6, 0), (-1e-9, 2)):
        Kj, Lj, nj = jc.cholesky_kuu(jk.matern52, jnp.asarray(ny), jnp.asarray(Z), jnp.asarray(ls),
                                     jnp.asarray(var), jitter=jitter, escalations=esc, with_info=True)
        Kt, Lt, nt = tc.cholesky_kuu(tk.matern52, torch.as_tensor(ny), torch.as_tensor(Z),
                                     torch.as_tensor(ls), torch.as_tensor(var), jitter=jitter,
                                     escalations=esc, with_info=True)
        np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=1e-12)
        ok = np.isfinite(np.asarray(Lj)).all(axis=(1, 2))
        np.testing.assert_array_equal(torch.isfinite(Lt).all(dim=-1).all(dim=-1).numpy(), ok)
        np.testing.assert_allclose(Lt.numpy()[ok], np.asarray(Lj)[ok], rtol=1e-10, atol=1e-12)
        assert int(nt) == int(nj) == (2 if esc else 0)


def test_antithetic_noise_pairs():
    noise = tp.draw_noise((2,), 7, 12, 5, 32, torch.float64, "cpu", torch.Generator().manual_seed(1),
                          antithetic=True)
    assert noise.w.shape == (2, 5, 7, 32) and noise.eps.shape == (2, 5, 7, 12)
    torch.testing.assert_close(noise.w[:, 3:5], -noise.w[:, 0:2])
    torch.testing.assert_close(noise.eps[:, 3:5], -noise.eps[:, 0:2])
