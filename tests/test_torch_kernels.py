"""Kernels K1 and K2 against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one; they import no JAX, so
they run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

The CPU-side checks (wrappers refuse CPU tensors, dispatch takes the plain
path on the CPU) run everywhere.
"""

import numpy as np
import pytest
import torch

from _torch_support import cuda_device, smooth_grid  # noqa: F401
from vgpmp_torch import robots, scene
from vgpmp_torch.kinematics import dh
from vgpmp_torch.likelihoods import collision as col
from vgpmp_torch.ops import linalg as la
from vgpmp_torch.sdf import grid as sg

ORIGIN = np.array([-1.2, -1.2, -0.6])
DELTA = 0.06
SHAPE = (40, 40, 36)


def _spd(rng, T, n):
    G = rng.normal(size=(T, n, n))
    return G @ np.swapaxes(G, -1, -2) + n * np.eye(n)


def _collision(robot, dtype, device):
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    sc = scene.Scene(base=sg.SdfGrid.from_arrays(data, ORIGIN, DELTA, dtype, device),
                     base_offset=torch.tensor([0.1, 0.0, -0.05], dtype=dtype, device=device)).packed()
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=dtype, device=device),
                                    scene=sc, epsilon=0.05)


def _configs(spec, rng, shape):
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    return rng.uniform(lo, hi, size=shape + (spec.dof,))


def test_wrappers_refuse_cpu_tensors():
    spec, model = _collision("franka", torch.float32, "cpu")
    q = torch.zeros(4, spec.dof)
    with pytest.raises(ValueError):
        col.k1_loglik(model, q, torch.ones(1, spec.num_spheres), grad=True)
    with pytest.raises(ValueError):
        la.k2_chol(torch.eye(3, dtype=torch.float64)[None])
    # on the CPU the entry point takes the plain version
    lik = model.log_prob(q, torch.full((spec.num_spheres,), 0.005))
    torch.testing.assert_close(lik, col.log_prob_plain(model, q, torch.full((spec.num_spheres,), 0.005)))


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k1_matches_plain_on_card(robot, cuda_device):
    """K1 (float32) against the plain version on the same card. K1's FK may
    fuse multiply-adds and sums in another order, so a sphere near a voxel
    face may land in the neighbouring voxel: at most 1e-3 of the configs may
    differ; the rest agree to 1e-5 relative (+1e-3: sums of 37 float32 terms
    in another order) and their gradients to 1e-3 of the largest."""
    spec, model = _collision(robot, torch.float32, cuda_device)
    q = torch.as_tensor(_configs(spec, np.random.default_rng(3), (4, 2000)), dtype=torch.float32,
                        device=cuda_device)
    sigma = torch.full((4, spec.num_spheres), 0.005, device=cuda_device)
    qk = q.clone().requires_grad_()
    lik_k = model.log_prob(qk, sigma)
    lik_k.sum().backward()
    qp = q.clone().requires_grad_()
    lik_p = col.log_prob_plain(model, qp, sigma)
    lik_p.sum().backward()
    assert (lik_p < 0).float().mean() > 0.2
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    assert (~close).float().mean().item() <= 1e-3
    torch.testing.assert_close(qk.grad[close], qp.grad[close], rtol=1e-3,
                               atol=1e-3 * qp.grad.abs().max().item())
    with torch.no_grad():  # forward-only launch gives the same values
        torch.testing.assert_close(model.log_prob(q, sigma), lik_k.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 50, 100])
def test_k2_matches_plain_on_card(cuda_device, k):
    """K2 forward and backward against the plain versions at main-path shapes
    ([252, 12, 12]); float64 on well-conditioned input, so 1e-9 relative."""
    rng = np.random.default_rng(k)
    K = torch.as_tensor(_spd(rng, 252, 12), device=cuda_device)
    K[7] = -K[7]  # one non-SPD matrix: NaN on both sides
    Bm = torch.as_tensor(rng.normal(size=(252, 12, k)), device=cuda_device)
    L_k = la.chol(K)
    L_p = la.cholesky_unrolled(K)
    assert torch.isnan(L_k[7]).any() and torch.isnan(L_p[7]).any()
    ok = torch.ones(252, dtype=torch.bool, device=cuda_device)
    ok[7] = False
    torch.testing.assert_close(L_k[ok], L_p[ok], rtol=1e-9, atol=1e-12)
    for fn, plain in [(la.solve_lower, la.solve_lower_unrolled),
                      (la.solve_upper_T, la.solve_upper_T_unrolled)]:
        Kt, Bt = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
        out = fn(la.chol(Kt), Bt)
        g_k = torch.autograd.grad(out.square().sum(), [Kt, Bt])
        Kp, Bp = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
        ref = plain(la.cholesky_unrolled(Kp), Bp)
        g_p = torch.autograd.grad(ref.square().sum(), [Kp, Bp])
        torch.testing.assert_close(out, ref, rtol=1e-9, atol=1e-12)
        for a, b in zip(g_k, g_p):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10 * b.abs().max().item())


@pytest.mark.cuda
def test_k2_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError):
        la.chol(torch.eye(4, device=cuda_device)[None])  # float32
    with pytest.raises(ValueError):
        la.chol(torch.eye(33, dtype=torch.float64, device=cuda_device)[None])  # n > 32
