"""Kernels K1 to K6 (K3 with both entries) against their plain PyTorch
versions, on the card.

These tests need an NVIDIA GPU and skip without one; they import no JAX, so
they run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

The CPU-side checks (wrappers refuse CPU tensors, dispatch takes the plain
path on the CPU) run everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_support import (cube_mesh, cuda_device, mc40_grams, real_grams, smooth_grid, source_wins,  # noqa: F401
                            torch_scene_with_objects, two_cubes_mesh)
from vgpmp_torch import robots, scene
from vgpmp_torch.kinematics import dh
from vgpmp_torch.likelihoods import collision as col
from vgpmp_torch.ops import gather as tg
from vgpmp_torch.ops import linalg as la
from vgpmp_torch.ops import rff
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
    with pytest.raises(ValueError):
        col.k3_min_clearance(model, q)
    with pytest.raises(ValueError):
        col.k3_probe_clearance(model, q[None], q[:1], q[:1], torch.zeros(1), torch.zeros(1),
                               torch.ones(1, dtype=torch.bool), torch.zeros(1, 4, dtype=torch.int64),
                               3, 0.5, 5e-3)
    with pytest.raises(ValueError):
        la.k2_factor_solve(torch.eye(3, dtype=torch.float64)[None], torch.ones(1, 3, 2, dtype=torch.float64))
    # on the CPU the entry points take the plain versions
    torch.testing.assert_close(model.min_clearance_eval(q), col.min_clearance_eval_plain(model, q))
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


# (n, T, k): the main path's [252, 12, k] first; then every unroll bucket's
# edge and every problemset Mc (9, 12, 14, 16, 17, 20, 26 are num_inducing + 2),
# at matrix counts that leave a packed warp or block part-filled (T = 3, 253)
# or hold one matrix alone, and at column counts either side of the solve's
# packing (16 | 17) and of its 128-column tile
K2_CASES = [(12, 252, 1), (12, 252, 20), (12, 252, 50), (12, 252, 100),
            (1, 3, 1), (2, 253, 2), (4, 1, 12), (5, 251, 16), (8, 253, 17), (9, 3, 100),
            (12, 251, 1), (12, 251, 100), (13, 253, 128), (14, 251, 12), (16, 3, 129),
            (17, 251, 300), (20, 253, 1), (24, 1, 2), (26, 251, 100), (26, 253, 12), (28, 3, 16),
            (29, 251, 17), (32, 253, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,k", K2_CASES)
def test_k2_matches_plain_on_card(cuda_device, n, T, k):
    """K2's lone factorisation and solves, forward and backward (``_CholFn``,
    ``_TrsmFn``), against the plain versions; float64 on well-conditioned
    input, so 1e-9 relative. One non-SPD matrix (where T > 1) gives NaN in
    itself and in no neighbour packed into its warp or block."""
    rng = np.random.default_rng(1000 * n + T + k)
    K = torch.as_tensor(_spd(rng, T, n), device=cuda_device)
    Bm = torch.as_tensor(rng.normal(size=(T, n, k)), device=cuda_device)
    ok = torch.ones(T, dtype=torch.bool, device=cuda_device)
    if T > 1:
        K[T // 2] = -K[T // 2]  # NaN on both sides, in this matrix only
        ok[T // 2] = False
    L_k = la.chol(K)
    L_p = la.cholesky_unrolled(K)
    if T > 1:
        assert torch.isnan(L_k[T // 2]).any() and torch.isnan(L_p[T // 2]).any()
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
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10 * b.abs().max().item())
        X = fn(L_k, Bm)  # the non-SPD matrix's factor among the others
        if T > 1:
            assert torch.isnan(X[T // 2]).any()
        torch.testing.assert_close(X[ok], ref.detach(), rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(12, 1), (12, 20), (12, 71), (12, 251), (2, 1), (8, 5), (26, 70), (32, 40)])
def test_k2_fused_pair_matches_plain_on_card(cuda_device, n, k):
    """The fused pair, forward and backward (through autograd and called
    directly), against its plain versions; float64 on well-conditioned input,
    so 1e-9 relative. One launch each way; a non-SPD matrix gives NaN."""
    rng = np.random.default_rng(1000 * n + k)
    T = 252
    K = torch.as_tensor(_spd(rng, T, n), device=cuda_device)
    K[7] = -K[7]
    Bm = torch.as_tensor(rng.normal(size=(T, n, k)), device=cuda_device)
    WL = torch.as_tensor(rng.normal(size=(T, n, n)), device=cuda_device)
    WX = torch.as_tensor(rng.normal(size=(T, n, k)), device=cuda_device)
    ok = torch.ones(T, dtype=torch.bool, device=cuda_device)
    ok[7] = False
    L_k, X_k = la.factor_solve(K.reshape(36, 7, n, n), Bm.reshape(36, 7, n, k))  # leading axes
    L_k, X_k = L_k.reshape(T, n, n), X_k.reshape(T, n, k)
    L_p, X_p = la.factor_solve_plain(K, Bm)
    assert all(torch.isnan(v[7]).any() for v in (L_k, X_k, L_p, X_p))
    torch.testing.assert_close(L_k[ok], L_p[ok], rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(X_k[ok], X_p[ok], rtol=1e-9, atol=1e-12)
    gK_n, gB_n = la.k2_factor_solve_bwd(L_k, X_k, WL, WX)
    assert torch.isnan(gK_n[7]).any() and torch.isnan(gB_n[7]).any()

    Kt, Bt = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
    before = (la.k2_factor_solve.launches, la.k2_factor_solve_bwd.launches, la.k2_chol.launches,
              la.k2_trsm.launches)
    Lf, Xf = la.factor_solve(Kt, Bt)
    g_k = torch.autograd.grad((WL[ok] * Lf).sum() + (WX[ok] * Xf).sum(), [Kt, Bt])
    assert (la.k2_factor_solve.launches, la.k2_factor_solve_bwd.launches, la.k2_chol.launches,
            la.k2_trsm.launches) == (before[0] + 1, before[1] + 1, before[2], before[3])
    Kp, Bp = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
    Lg, Xg = la.factor_solve_plain(Kp, Bp)
    g_p = torch.autograd.grad((WL[ok] * Lg).sum() + (WX[ok] * Xg).sum(), [Kp, Bp])
    for a, b, c in zip(g_k, g_p, (gK_n[ok], gB_n[ok])):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10 * b.abs().max().item())
        torch.testing.assert_close(c, b, rtol=1e-8, atol=1e-10 * b.abs().max().item())
    # only one of the two outputs used: the other's gradient arrives as zeros
    Kt2, Bt2 = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
    (gK_only,) = torch.autograd.grad(la.factor_solve(Kt2, Bt2)[0].square().sum(), [Kt2])
    Kp2 = K[ok].clone().requires_grad_()
    (gK_ref,) = torch.autograd.grad(la.cholesky_unrolled(Kp2).square().sum(), [Kp2])
    torch.testing.assert_close(gK_only, gK_ref, rtol=1e-8, atol=1e-10 * gK_ref.abs().max().item())


@pytest.mark.cuda
def test_k1_tail_tile_and_sigma_rows_on_card(cuda_device):
    """K1 where the config count is no multiple of its tile and every sigma row
    covers fewer configs than a tile: each config must still read its own row."""
    spec, model = _collision("franka", torch.float32, cuda_device)
    rng = np.random.default_rng(9)
    q = torch.as_tensor(_configs(spec, rng, (9, 23)), dtype=torch.float32, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.002, 0.02, size=(9, spec.num_spheres)), dtype=torch.float32,
                            device=cuda_device)
    qk = q.clone().requires_grad_()
    lik_k = model.log_prob(qk, sigma)
    lik_k.sum().backward()
    qp = q.clone().requires_grad_()
    lik_p = col.log_prob_plain(model, qp, sigma)
    lik_p.sum().backward()
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    assert (~close).sum().item() <= 1  # 207 configs: at most one in a neighbouring voxel
    torch.testing.assert_close(qk.grad[close], qp.grad[close], rtol=1e-3,
                               atol=1e-3 * qp.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k1_sigma_grad_forward_equals_frozen_forward_on_card(robot, cuda_device):
    """The forward that also writes h² gives the frozen forward's lik and
    d/dq bit for bit, and its h² is the plain version's squared hinge."""
    spec, model = _collision(robot, torch.float32, cuda_device)
    rng = np.random.default_rng(21)
    q = torch.as_tensor(_configs(spec, rng, (3 * 333,)), dtype=torch.float32, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.002, 0.02, size=(3, spec.num_spheres)), dtype=torch.float32,
                            device=cuda_device)
    lik_h, dq_h, h2 = col.k1_loglik(model, q, sigma, True, True)
    lik_f, dq_f, none = col.k1_loglik(model, q, sigma, True)
    assert none is None and h2.shape == (spec.num_spheres, q.shape[0])
    assert torch.equal(lik_h, lik_f) and torch.equal(dq_h, dq_f)
    h = model.hinge_cost(q)  # plain version, [T, P]
    same = torch.isclose(col.log_prob_plain(model, q, sigma.repeat_interleave(333, 0)), lik_f,
                         rtol=1e-5, atol=1e-3)
    assert (~same).sum().item() <= 1  # at most one config in a neighbouring voxel
    torch.testing.assert_close(h2.T[same], (h * h)[same], rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError):  # h² only beside the gradient
        col.k1_loglik(model, q, sigma, False, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k1_dsigma_matches_plain_on_card(robot, dtype, cuda_device):
    """``k1_dsigma`` on K1's own h² against the float64 sum of the same terms,
    and K1's d/dσ through autograd against autograd through the plain
    version (both in ``dtype``). Rows of 1 000 configs straddle the 32-config
    tiles; row 2 holds configs with no sphere in contact (dσ exactly 0); a
    NaN upstream gradient in row 4 stays in ``dσ[4, :]``. Then rows of K = 490
    (wam/lab's S N) and 1 001 configs, whose segments start off a 16-byte
    boundary, from h² and g read one element past one, with a NaN in g.
    Tolerances: 1e-5 of ``Σ|g| h²/(2σ²)`` for the reduction (float32 sums of
    1 000 terms of either sign), 1e-4 end to end (h from float32 FK on both
    sides); in float64 1e-12 and 1e-9."""
    red_tol, e2e_tol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-12, 1e-9)
    spec, model = _collision(robot, dtype, cuda_device)
    rng = np.random.default_rng(31)
    R, K, P = 6, 1000, spec.num_spheres
    q = _configs(spec, rng, (R, K))
    pool = torch.as_tensor(_configs(spec, rng, (40000,)), dtype=dtype, device=cuda_device)
    clear = pool[(model.hinge_cost(pool) == 0).all(dim=-1)]
    assert clear.shape[0] >= K, "too few configs clear of the scene to fill a row"
    q = torch.as_tensor(q, dtype=dtype, device=cuda_device)
    q[2] = clear[:K]
    sigma = torch.as_tensor(rng.uniform(0.002, 0.02, size=(R, P)), dtype=dtype, device=cuda_device)
    g = torch.as_tensor(rng.normal(size=(R, K)), dtype=dtype, device=cuda_device)

    _, _, h2 = col.k1_loglik(model, q.reshape(-1, spec.dof), sigma, True, True)
    got = col.k1_dsigma(g.reshape(-1), h2, sigma)
    ref = col.dsigma_plain(g.reshape(-1).double(), h2.double(), sigma.double())
    scale = col.dsigma_plain(g.reshape(-1).abs().double(), h2.double(), sigma.double())
    assert (got[2] == 0).all() and (scale[2] == 0).all() and (scale[[0, 1, 3]] > 0).any()
    assert ((got.double() - ref).abs() <= red_tol * scale).all()

    # end to end through autograd, configs in a neighbouring voxel weighted 0
    lik_p = col.log_prob_plain(model, q, sigma)
    sk = sigma.clone().requires_grad_()
    lik_k = model.log_prob(q, sk)
    w = g * torch.isclose(lik_k.detach(), lik_p, rtol=1e-5, atol=1e-3)
    (ds_k,) = torch.autograd.grad((w * lik_k).sum(), sk)
    sp = sigma.clone().requires_grad_()
    (ds_p,) = torch.autograd.grad((w * col.log_prob_plain(model, q, sp)).sum(), sp)
    assert ((ds_k - ds_p).abs().double() <= e2e_tol * scale + 1e-30).all()

    # a NaN upstream gradient stays in its row
    gn = g.clone()
    gn[4, 517] = float("nan")
    out = col.k1_dsigma(gn.reshape(-1), h2, sigma)
    assert torch.isnan(out[4]).all() and torch.isfinite(out[torch.arange(R, device=cuda_device) != 4]).all()
    with pytest.raises(ValueError):
        col.k1_dsigma(g.reshape(-1), h2[:, :-1], sigma)

    # ragged rows, read off a 16-byte boundary
    for Kr in (490, 1001):
        T = R * Kr
        gb = torch.as_tensor(rng.normal(size=T + 1), dtype=dtype, device=cuda_device)
        hb = torch.as_tensor(rng.uniform(0, 4e-4, size=P * T + 1) * (rng.uniform(size=P * T + 1) > 0.3),
                             dtype=dtype, device=cuda_device)
        gr, hr = gb[1:], hb[1:].view(P, T)
        assert gr.data_ptr() % 16 and hr.data_ptr() % 16
        gr[3 * Kr + 11] = float("nan")
        got = col.k1_dsigma(gr, hr, sigma)
        ref = col.dsigma_plain(gr.double(), hr.double(), sigma.double())
        scale = col.dsigma_plain(gr.abs().double(), hr.double(), sigma.double())
        rows = torch.arange(R, device=cuda_device) != 3
        assert torch.isnan(got[3]).all() and torch.isfinite(got[rows]).all()
        assert ((got[rows].double() - ref[rows]).abs() <= red_tol * scale[rows]).all()


@pytest.mark.cuda
def test_k2_refuses_what_it_does_not_take(cuda_device):
    """K2 takes float32 and float64 at any n (the streamed design above n =
    128, KERNEL_BLOCK_MAX_N); it refuses, before a launch, another dtype,
    mixed dtypes and mismatched shapes."""
    with pytest.raises(TypeError):
        la.chol(torch.eye(4, dtype=torch.float16, device=cuda_device)[None])  # float16
    eye = torch.eye(4, dtype=torch.float64, device=cuda_device)[None]
    with pytest.raises(TypeError):
        la.factor_solve(eye, eye.float())  # one float64, one float32
    with pytest.raises(ValueError):
        la.factor_solve(eye, torch.ones(1, 5, 2, dtype=torch.float64, device=cuda_device))
    with pytest.raises(TypeError):
        la.k2_trsm(eye, eye.float(), False)
    with pytest.raises(ValueError):
        la.k2_chol(torch.ones(1, 4, 5, dtype=torch.float64, device=cuda_device))  # not square


def _k3_model(robot, device):
    """A float32 model on a grid smaller than the arm's reach, so that sphere
    centres leave it on every side."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    sc = scene.Scene(base=sg.SdfGrid.from_arrays(data, np.array([-0.2, -0.3, 0.1]), 0.015,
                                                 torch.float32, device),
                     base_offset=torch.tensor([0.1, 0.0, -0.05], device=device))
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=torch.float32,
                                                            device=device), scene=sc, epsilon=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 8000])
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k3_matches_plain_on_card(robot, n, cuda_device):
    """K3 (float32) against the plain trilinear clearance on the same card, at
    config counts that leave a ragged last tile of 32 (and one config alone).
    Trilinear interpolation is continuous and K3 differs from the plain
    version by fused multiply-adds only: 1e-5 m absolute. A NaN config gives
    NaN on both sides."""
    spec, model = _k3_model(robot, cuda_device)
    q = torch.as_tensor(_configs(spec, np.random.default_rng(3), (n,)), dtype=torch.float32,
                        device=cuda_device)
    nans = min(5, n // 2)
    q[:nans, 2] = float("nan")
    before = col.k3_min_clearance.launches
    got = model.min_clearance_eval(q)
    assert col.k3_min_clearance.launches == before + 1
    want = col.min_clearance_eval_plain(model, q)
    assert got.shape == (n,)
    assert torch.isnan(got[:nans]).all() and torch.isnan(want[:nans]).all()
    ok = ~torch.isnan(want)
    assert ok.sum() == n - nans
    if n >= 1000:
        assert (want[ok] < 0).float().mean() > 0.05
    torch.testing.assert_close(got[ok], want[ok], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k3_probe_entry_matches_plain_on_card(robot, cuda_device):
    """K3's fused entry against ``probe_clearance_plain`` on ``pd_path_configs``
    output: rows that move, one without motion (not visited) and one that
    turns NaN, with 7 probes per segment so that tiles of 32 straddle rows.
    Clearance to 1e-5 m; every segment count equal, except that a probe
    within 1e-5 m of its floor may fall either way."""
    from vgpmp_torch import sim

    spec, model = _k3_model(robot, cuda_device)
    rng = np.random.default_rng(11)
    B, T = 6, 15
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    a, b = (mid + 0.6 * half * rng.uniform(-1, 1, (B, spec.dof)) for _ in range(2))
    w = np.linspace(0, 1, T)[None, :, None]
    traj = a[:, None] * (1 - w) + b[:, None] * w + 0.05 * rng.normal(size=(B, T, spec.dof))
    traj[1] = traj[1, :1]
    traj[4, T // 2:] = np.nan
    traj = torch.as_tensor(traj, dtype=torch.float32, device=cuda_device)
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj, samples_per_segment=7)
    q_s, q_g = traj[:, 0] + 0.01, torch.nan_to_num(traj[:, -1], 0.1)
    plain = lambda q: col.min_clearance_eval_plain(model, q)
    depth_s, depth_g = torch.clamp(-plain(torch.cat([q_s, q_g])), min=0.0).split(B)
    args = (q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T, 0.5, 5e-3)
    before = col.k3_probe_clearance.launches
    clear, count = model.probe_clearance(qs, *args)
    assert col.k3_probe_clearance.launches == before + 1
    want_clear, want_count = sim.probe_clearance_plain(plain, qs, *args)
    assert clear.shape == want_clear.shape and count.shape == (B, T) and count.dtype == torch.int32
    assert torch.equal(torch.isnan(clear), torch.isnan(want_clear)) and torch.isnan(clear[4]).any()
    ok = ~torch.isnan(want_clear)
    torch.testing.assert_close(clear[ok], want_clear[ok], rtol=0, atol=1e-5)
    floor = sim._floor_from_depths(qs, q_s, q_g, depth_s, depth_g, 0.5, 5e-3)
    near = visited & ((want_clear - floor).abs() <= 1e-5)
    far = sim._segment_count(seg_idx, visited & (want_clear < floor) & ~near, T)
    assert ((far <= count) & (count <= far + sim._segment_count(seg_idx, near, T))).all()
    assert count[1].sum() == 0 and want_count.sum() > 0 and (want_count == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 2])
def test_k4_matches_plain_on_card(words, cuda_device):
    """K4 against the plain indexing: exact, both entry widths, with indices
    at the table's ends and outside it (clamped)."""
    ncells = 100_003
    table = torch.arange(ncells * words, dtype=torch.int32, device=cuda_device) * 40503 - 7
    if words == 2:
        table = table.reshape(ncells, 2)
    idx = torch.randint(0, ncells, (257, 129), device=cuda_device, dtype=torch.int32)
    idx.view(-1)[:4] = torch.tensor([0, ncells - 1, -5, ncells + 9], dtype=torch.int32)
    before = tg.k4_gather.launches
    got = tg.gather(table, idx)
    assert tg.k4_gather.launches == before + 1
    assert torch.equal(got, tg.gather_plain(table, idx))
    assert got.shape == idx.shape + ((2,) if words == 2 else ())


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 2])
@pytest.mark.parametrize("n", [1, 3, 5, 1_000_003])
def test_k4_edges_on_card(words, n, cuda_device):
    """K4 exact at point counts that fill no whole block or 16-byte vector and
    on index views that start off a 16-byte boundary (``idx[1:]``,
    ``idx[3:]``), with indices outside the table clamped; the view is neither
    refused nor copied."""
    ncells = 70_001
    table = torch.arange(ncells * words, dtype=torch.int32, device=cuda_device) * 7919 + 3
    if words == 2:
        table = table.reshape(ncells, 2)
    full = torch.randint(-9, ncells + 9, (n + 3,), device=cuda_device, dtype=torch.int32)
    for off in (0, 1, 3):
        idx = full[off:off + n]
        before = tg.k4_gather.launches
        got = tg.gather(table, idx)
        assert tg.k4_gather.launches == before + 1
        assert torch.equal(got, tg.gather_plain(table, idx)), off
        assert got.shape == (n,) + ((2,) if words == 2 else ()) and got.is_contiguous()


@pytest.mark.cuda
def test_k3_k4_refuse_what_they_do_not_take(cuda_device):
    spec, model = _collision("franka", torch.float64, cuda_device)
    with pytest.raises(TypeError):  # float32 configs on a float64 model
        model.min_clearance_eval(torch.zeros(4, spec.dof, dtype=torch.float32, device=cuda_device))
    _, model32 = _collision("franka", torch.float32, cuda_device)
    with pytest.raises(TypeError):  # float64 configs on a float32 model
        model32.min_clearance_eval(torch.zeros(4, spec.dof, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):  # wrong dof
        col.k3_min_clearance(model32, torch.zeros(4, spec.dof - 1, device=cuda_device))
    B, G, T = 2, 6, 3
    good = dict(q_s=torch.zeros(B, spec.dof, device=cuda_device), q_g=torch.zeros(B, spec.dof, device=cuda_device),
                depth_s=torch.zeros(B, device=cuda_device), depth_g=torch.zeros(B, device=cuda_device),
                visited=torch.ones(B, dtype=torch.bool, device=cuda_device),
                seg_idx=torch.zeros(B, G, dtype=torch.int64, device=cuda_device))
    qs = torch.zeros(B, G, spec.dof, device=cuda_device)
    col.k3_probe_clearance(model32, qs, *good.values(), T, 0.5, 5e-3)  # accepted
    with pytest.raises(TypeError):  # float64 probes
        col.k3_probe_clearance(model32, qs.double(), *good.values(), T, 0.5, 5e-3)
    with pytest.raises(ValueError):  # wrong dof
        col.k3_probe_clearance(model32, qs[..., 1:], *good.values(), T, 0.5, 5e-3)
    bad = dict(good, seg_idx=good["seg_idx"].int())
    with pytest.raises(TypeError):  # int32 segment indices
        col.k3_probe_clearance(model32, qs, *bad.values(), T, 0.5, 5e-3)
    bad = dict(good, depth_s=torch.zeros(B + 1, device=cuda_device))
    with pytest.raises(ValueError):  # a per-row input of the wrong length
        col.k3_probe_clearance(model32, qs, *bad.values(), T, 0.5, 5e-3)
    with pytest.raises(TypeError):
        tg.k4_gather(torch.zeros(8, device=cuda_device), torch.zeros(4, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        tg.k4_gather(torch.zeros(8, 3, dtype=torch.int32, device=cuda_device),
                     torch.zeros(4, dtype=torch.int32, device=cuda_device))


def _composed(robot, device, small_base=False):
    """A float32 model whose scene composes the base grid of ``_collision``
    (or, with ``small_base``, ``_k3_model``'s grid, which sphere centres
    leave) with ``scene_objects``' two extra grids, a sphere, two boxes (one
    rotated) and a capsule; packed unless ``small_base``."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    origin, delta = (np.array([-0.2, -0.3, 0.1]), 0.015) if small_base else (ORIGIN, DELTA)
    sc = torch_scene_with_objects(data, origin, delta, [0.1, 0.0, -0.05], torch.float32, device,
                                  packed=not small_base)
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=torch.float32,
                                                            device=device), scene=sc, epsilon=0.05)


def _k1_against_plain(model, q, sigma):
    """(lik, d/dq) of K1 through ``log_prob`` and of the plain version."""
    out = []
    for fn in (model.log_prob, lambda x, s: col.log_prob_plain(model, x, s)):
        x = q.clone().requires_grad_()
        lik = fn(x, sigma)
        lik.sum().backward()
        out += [lik.detach(), x.grad]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k1_composed_scene_matches_plain_on_card(robot, cuda_device):
    """K1 on a scene with two extra grids (sphere centres outside the first:
    its index clamps) and every primitive kind (one box rotated) against the
    plain composition on the same card. Each source wins the minimum at some
    hinge-active sphere. Tolerances as K1's base test: at most 1e-3 of the
    configs in a neighbouring voxel of some grid, the rest 1e-5 relative
    (+1e-3), gradients 1e-3 of the largest. A config with a sphere centre
    inside or on a box has a NaN d/dq, as JAX's (in the joints that move the
    sphere), on both sides; the pattern may differ only in those configs."""
    spec, model = _composed(robot, cuda_device)
    rng = np.random.default_rng(4)
    q = torch.as_tensor(_configs(spec, rng, (4, 2000)), dtype=torch.float32, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(4, spec.num_spheres)), dtype=torch.float32,
                            device=cuda_device)
    before = col.k1_loglik.launches
    lik_k, g_k, lik_p, g_p = _k1_against_plain(model, q, sigma)
    assert col.k1_loglik.launches == before + 1
    with torch.no_grad():
        pos = dh.sphere_positions(model.fk, q)
        wins = source_wins(model.scene, pos, model.hinge_cost(q) > 0)
    assert len(wins) == 6 and min(wins.values()) > 0, wins
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    assert (~close).float().mean().item() <= 1e-3
    nan_k, nan_p = torch.isnan(g_k), torch.isnan(g_p)
    assert nan_p.any(-1).float().mean() > 0.02
    assert (nan_k != nan_p).any(-1).float().mean().item() <= 1e-3
    both = close & ~(nan_k | nan_p).any(-1)
    torch.testing.assert_close(g_k[both], g_p[both], rtol=1e-3,
                               atol=1e-3 * g_p[both].abs().max().item())
    q2, s2 = q.reshape(-1, spec.dof), sigma
    lik_f, dq_f, _ = col.k1_loglik(model, q2, s2, True)
    lik_h, dq_h, h2 = col.k1_loglik(model, q2, s2, True, True)
    lik_0, _, _ = col.k1_loglik(model, q2, s2, False)
    assert torch.equal(lik_h, lik_f)
    torch.testing.assert_close(lik_0, lik_f)
    torch.testing.assert_close(dq_h, dq_f, rtol=0, atol=0, equal_nan=True)
    h = model.hinge_cost(q2)
    ok = close.reshape(-1)
    torch.testing.assert_close(h2.T[ok], (h * h)[ok], rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k3_composed_scene_matches_plain_on_card(robot, cuda_device):
    """K3 on ``_k3_model``'s small base grid with ``scene_objects``' extras
    against the plain composition: 1e-5 m (as K3's base test); NaN configs
    give NaN on both sides."""
    spec, model = _composed(robot, cuda_device, small_base=True)
    q = torch.as_tensor(_configs(spec, np.random.default_rng(5), (8000,)), dtype=torch.float32,
                        device=cuda_device)
    q[:5, 3] = float("nan")
    before = col.k3_min_clearance.launches
    got = model.min_clearance_eval(q)
    assert col.k3_min_clearance.launches == before + 1
    want = col.min_clearance_eval_plain(model, q)
    with torch.no_grad():
        wins = source_wins(model.scene, dh.sphere_positions(model.fk, q[5:]), None, "trilinear")
    assert len(wins) == 6 and min(wins.values()) > 0, wins
    assert torch.isnan(got[:5]).all() and torch.isnan(want[:5]).all()
    assert not torch.isnan(want[5:]).any() and (want[5:] < 0).float().mean() > 0.05
    torch.testing.assert_close(got[5:], want[5:], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_k3_probe_entry_composed_scene_on_card(cuda_device):
    """K3's fused entry on the composed scene against ``probe_clearance_plain``
    (as ``test_k3_probe_entry_matches_plain_on_card``)."""
    from vgpmp_torch import sim

    spec, model = _composed("franka", cuda_device, small_base=True)
    rng = np.random.default_rng(12)
    B, T = 6, 15
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    a, b = (mid + 0.6 * half * rng.uniform(-1, 1, (B, spec.dof)) for _ in range(2))
    w = np.linspace(0, 1, T)[None, :, None]
    traj = torch.as_tensor(a[:, None] * (1 - w) + b[:, None] * w, dtype=torch.float32, device=cuda_device)
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj, samples_per_segment=7)
    q_s, q_g = traj[:, 0], traj[:, -1]
    plain = lambda q: col.min_clearance_eval_plain(model, q)
    depth_s, depth_g = torch.clamp(-plain(torch.cat([q_s, q_g])), min=0.0).split(B)
    args = (q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T, 0.5, 5e-3)
    clear, count = model.probe_clearance(qs, *args)
    want_clear, want_count = sim.probe_clearance_plain(plain, qs, *args)
    torch.testing.assert_close(clear, want_clear, rtol=0, atol=1e-5)
    floor = sim._floor_from_depths(qs, q_s, q_g, depth_s, depth_g, 0.5, 5e-3)
    near = visited & ((want_clear - floor).abs() <= 1e-5)
    far = sim._segment_count(seg_idx, visited & (want_clear < floor) & ~near, T)
    assert ((far <= count) & (count <= far + sim._segment_count(seg_idx, near, T))).all()
    assert want_count.sum() > 0


@pytest.mark.cuda
def test_move_objects_reaches_k1_and_k3_on_card(cuda_device):
    """``move_objects`` rewrites the pose tables in place: the next K1 and K3
    launches read the moved objects (equal to the plain version on the moved
    scene, and different from before), and no table is reallocated."""
    spec, model = _composed("franka", cuda_device)
    rng = np.random.default_rng(6)
    q = torch.as_tensor(_configs(spec, rng, (2, 1000)), dtype=torch.float32, device=cuda_device)
    sigma = torch.full((2, spec.num_spheres), 0.005, device=cuda_device)
    ptrs = [model.tables.grid_f.data_ptr(), model.tables.prims.data_ptr()]
    with torch.no_grad():
        lik0, clear0 = model.log_prob(q, sigma), model.min_clearance_eval(q)
    sc = model.scene
    shift = torch.tensor([0.05, -0.1, 0.08], device=cuda_device)
    p = sc.primitives
    moved = scene.Scene(base=sc.base, base_offset=sc.base_offset, extra_grids=sc.extra_grids,
                        extra_offsets=sc.extra_offsets + shift,
                        primitives=scene.Primitives(p.sphere_centers + shift, p.sphere_radii,
                                                    p.box_centers - shift, p.box_rotations,
                                                    p.box_half_extents, p.capsule_a + shift,
                                                    p.capsule_b + shift, p.capsule_radii))
    model.move_objects(moved)
    assert [model.tables.grid_f.data_ptr(), model.tables.prims.data_ptr()] == ptrs
    torch.testing.assert_close(model.scene.extra_offsets, moved.extra_offsets)
    with torch.no_grad():
        lik1, clear1 = model.log_prob(q, sigma), model.min_clearance_eval(q)
        lik_p, clear_p = col.log_prob_plain(model, q, sigma), col.min_clearance_eval_plain(model, q)
    assert not torch.equal(lik1, lik0) and not torch.equal(clear1, clear0)
    assert (~torch.isclose(lik1, lik_p, rtol=1e-5, atol=1e-3)).float().mean().item() <= 1e-3
    torch.testing.assert_close(clear1, clear_p, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):  # another set of objects
        model.move_objects(scene.Scene(base=sc.base, base_offset=sc.base_offset))


def _too_many_boxes(device):
    """``_composed``'s model with 300 boxes more: 4 500 floats of extras."""
    spec, model = _composed("franka", device)
    p, n = model.scene.primitives, 300
    many = scene.Primitives(p.sphere_centers, p.sphere_radii, torch.zeros(n, 3, device=device),
                            torch.eye(3, device=device).expand(n, 3, 3).contiguous(),
                            torch.full((n, 3), 0.1, device=device), p.capsule_a, p.capsule_b,
                            p.capsule_radii)
    sc = scene.Scene(base=model.scene.base, base_offset=model.scene.base_offset, primitives=many).packed()
    return spec, col.CollisionModel(fk=model.fk, scene=sc, epsilon=0.05)


def test_scene_extras_that_do_not_fit_are_refused():
    """More extras than a block's shared memory holds are refused with a
    ValueError before a launch; the plain version takes them."""
    spec, model = _too_many_boxes("cpu")
    for args in (model.tables.k1_args, model.tables.k3_args):
        with pytest.raises(ValueError, match="4511 floats"):
            args()
    assert torch.isfinite(model.min_clearance_eval(torch.zeros(2, spec.dof))).all()


@pytest.mark.cuda
def test_scene_extras_refused_on_card(cuda_device):
    """The same refusal on the card, through the launch wrappers."""
    spec, model = _too_many_boxes(cuda_device)
    q = torch.zeros(4, spec.dof, device=cuda_device)
    with pytest.raises(ValueError):
        col.k1_loglik(model, q, torch.ones(1, spec.num_spheres, device=cuda_device), grad=True)
    with pytest.raises(ValueError):
        col.k3_min_clearance(model, q)


def _velocity_grams(robot, ps, device):
    """A combo's velocity-constrained Grams at its tuned init, ``[B·L, n, n]``
    float64, and a training step's columns (S draws, N times, the mean)."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.session import PlanningSession

    s = PlanningSession(robot, ps, overrides={"velocity_constrained": True}, device=device)
    starts, goals = s.queries()
    params = solver.init_batch(s.model, starts, goals, s.planner_params)
    K, _ = planner._gram(s.model, planner.constrain(params, s.model.variance_lower))
    cols = s.model.num_samples + s.train_config.time_spacing_X + 1
    return K.detach().reshape(-1, *K.shape[-2:]).contiguous(), cols


@pytest.mark.cuda
@pytest.mark.parametrize("robot,ps,n", [("franka", "industrial", 14), ("franka", "bookshelves", 28)])
def test_k2_fused_pair_on_velocity_grams_on_card(cuda_device, robot, ps, n):
    """The fused pair on real velocity-constrained Grams (Mc = 2C + M at the
    problemset's M), forward and backward, against its plain versions. Their
    condition numbers reach ~1e10, so two summation orders differ by up to
    cond·eps ≈ 1e-6 of the largest entry: the forward is held to 1e-6 of it,
    the backward (three solves deep) to 1e-5."""
    K, k = _velocity_grams(robot, ps, cuda_device)
    assert K.shape[-1] == n
    rng = np.random.default_rng(n)
    Bm = torch.as_tensor(rng.normal(size=(K.shape[0], n, k)), device=cuda_device)
    WL = torch.as_tensor(rng.normal(size=K.shape), device=cuda_device)
    WX = torch.as_tensor(rng.normal(size=Bm.shape), device=cuda_device)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    L_k, X_k = la.factor_solve(K, Bm)
    L_p, X_p = la.factor_solve_plain(K, Bm)
    assert torch.isfinite(L_k).all() and torch.isfinite(X_k).all()
    assert rel(L_k, L_p) <= 1e-6 and rel(X_k, X_p) <= 1e-6
    Kt, Bt = K.clone().requires_grad_(), Bm.clone().requires_grad_()
    Lf, Xf = la.factor_solve(Kt, Bt)
    g_k = torch.autograd.grad((WL * Lf).sum() + (WX * Xf).sum(), [Kt, Bt])
    Kp, Bp = K.clone().requires_grad_(), Bm.clone().requires_grad_()
    Lg, Xg = la.factor_solve_plain(Kp, Bp)
    g_p = torch.autograd.grad((WL * Lg).sum() + (WX * Xg).sum(), [Kp, Bp])
    for a, b in zip(g_k, g_p):
        assert torch.isfinite(a).all() and rel(a, b) <= 1e-5


@pytest.mark.cuda
def test_velocity_step_launches_on_card(cuda_device):
    """One velocity-mode ELBO and its gradient: one K1 launch, the fused K2
    pair once each way, no lone factorisation or solve."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.session import PlanningSession

    s = PlanningSession("franka", "industrial", overrides={"velocity_constrained": True},
                        device=cuda_device)
    starts, goals = (x[:4] for x in s.queries())
    params = solver.init_batch(s.model, starts, goals, s.planner_params)
    for k in ("q_mu", "q_sqrt", "lengthscales_u", "variance_u"):
        getattr(params, k).requires_grad_(True)
    counters = (col.k1_loglik, la.k2_factor_solve, la.k2_factor_solve_bwd, la.k2_chol, la.k2_trsm)
    before = [c.launches for c in counters]
    X = torch.linspace(0, 1, s.train_config.time_spacing_X, device=cuda_device)
    value = planner.elbo(params, s.model, torch.as_tensor(starts, dtype=torch.float32, device=cuda_device),
                         torch.as_tensor(goals, dtype=torch.float32, device=cuda_device), X,
                         torch.Generator(device=cuda_device).manual_seed(0))
    grads = torch.autograd.grad(value.sum(), [params.q_mu, params.lengthscales_u])
    torch.cuda.synchronize()
    assert torch.isfinite(value).all() and all(torch.isfinite(g).all() for g in grads)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0]


@pytest.mark.cuda
def test_world_of_one_nccl_solve_matches_batch_solver_on_card(cuda_device):
    """``make_sharded_solver`` in a world of one over NCCL is
    ``make_batch_solver`` from the same generator seed, bit for bit, and its
    success count is the validator's on the same trajectories."""
    import socket

    import torch.distributed as dist

    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import validate_trajectory
    from vgpmp_torch.parallel import make_mesh, make_sharded_solver
    from vgpmp_torch.session import PlanningSession

    sess = PlanningSession("franka", "industrial", overrides=dict(num_steps=20))
    starts, goals = (x[:12] for x in sess.queries())
    params = solver.init_batch(sess.model, starts, goals, sess.planner_params)
    gen = lambda: torch.Generator(device=sess.device).manual_seed(4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(sess.device.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        assert mesh.shape == {"dp": 1, "sp": 1} and mesh.device.type == "cuda"
        res, metrics = make_sharded_solver(sess.model, sess.train_config, mesh)(params, starts, goals, gen())
    finally:
        dist.destroy_process_group()
    _, want = solver.make_batch_solver(sess.model, sess.train_config)(params, starts, goals, gen())
    bits = lambda x: x.contiguous().view(torch.int32)
    assert torch.equal(bits(res.best), bits(want.best))
    assert torch.equal(bits(res.elbo_history), bits(want.elbo_history))
    rep = validate_trajectory(sess.model.collision, want.best,
                              torch.as_tensor(starts, dtype=torch.float32, device=sess.device),
                              torch.as_tensor(goals, dtype=torch.float32, device=sess.device),
                              sess.model.limits_low, sess.model.limits_high)
    assert float(metrics["success_rate"] * metrics["num_problems"]) == int(rep.success.sum())
    assert metrics["num_problems"].item() == 12


# ------------------------------------------------ the CUDA envelope


def _grid_model(robot, dtype, device, mode, composed=False):
    """``_collision``'s grid unpacked, looked up in ``mode`` (``nearest`` or
    ``trilinear``, or ``packed``), in ``dtype``; ``composed`` adds
    ``scene_objects``' extras (looked up in the same mode)."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    if composed:
        sc = torch_scene_with_objects(data, ORIGIN, DELTA, [0.1, 0.0, -0.05], dtype, device,
                                      packed=False)
    else:
        sc = scene.Scene(base=sg.SdfGrid.from_arrays(data, ORIGIN, DELTA, dtype, device),
                         base_offset=torch.tensor([0.1, 0.0, -0.05], dtype=dtype, device=device))
    sc = sc.packed() if mode == "packed" else dataclasses.replace(sc, mode=mode)
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=dtype, device=device),
                                    scene=sc, epsilon=0.05)


# float32: as K1's packed test (a sphere near a cell face may land in the
# neighbouring cell, whose value and, in trilinear mode, gradient differ: at
# most 1e-3 of the configs; the rest 1e-5 relative + 1e-3, gradients 1e-3 of
# the largest); float64: the same share, the rest 1e-9 relative (+1e-9) and
# gradients 1e-8 of the largest (FK and sums in another order)
ENVELOPE_TOL = {torch.float32: (1e-5, 1e-3, 1e-3), torch.float64: (1e-9, 1e-9, 1e-8)}


def _k1_mode_check(model, q, sigma, dtype):
    rtol, atol, gtol = ENVELOPE_TOL[dtype]
    lik_k, g_k, lik_p, g_p = _k1_against_plain(model, q, sigma)
    assert (lik_p < 0).float().mean() > 0.2
    nan_k, nan_p = torch.isnan(g_k).any(-1), torch.isnan(g_p).any(-1)
    assert (nan_k != nan_p).float().mean().item() <= 1e-3
    both = ~nan_k & ~nan_p
    scale = g_p[both].abs().max().item()
    close = torch.isclose(lik_k, lik_p, rtol=rtol, atol=atol) & (
        ((g_k - g_p).abs() <= gtol * scale).all(-1) | ~both)
    assert (~close).float().mean().item() <= 1e-3
    torch.testing.assert_close(g_k[close & both], g_p[close & both], rtol=gtol, atol=gtol * scale)
    return close


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k1_grid_modes_match_plain_on_card(robot, mode, dtype, cuda_device):
    """K1's nearest-cell and trilinear lookups on the unpacked grid, in
    float32 and float64, against the plain version (the reference's nearest
    cell with its central-difference gradient, with the 0.1 replacement on
    the grid's plateaus; autodiff of the trilinear interpolation) on the
    same card, through ``log_prob``: one K1 launch of the mode and dtype, no
    plain call. The σ-gradient forward writes h² and equals the frozen
    forward; ``k1_dsigma`` reduces it as ``dsigma_plain`` does."""
    spec, model = _grid_model(robot, dtype, cuda_device, mode)
    rng = np.random.default_rng(7)
    q = torch.as_tensor(_configs(spec, rng, (4, 2000)), dtype=dtype, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(4, spec.num_spheres)), dtype=dtype,
                            device=cuda_device)
    key = (mode, str(dtype).removeprefix("torch."))
    before = col.k1_loglik.launches_by.get(key, 0)
    close = _k1_mode_check(model, q, sigma, dtype)
    assert col.k1_loglik.launches_by[key] == before + 1
    q2 = q.reshape(-1, spec.dof)
    lik_f, dq_f, _ = col.k1_loglik(model, q2, sigma, True)
    lik_h, dq_h, h2 = col.k1_loglik(model, q2, sigma, True, True)
    assert torch.equal(lik_h, lik_f) and torch.equal(dq_h, dq_f)
    h = model.hinge_cost(q2)
    ok = close.reshape(-1)
    torch.testing.assert_close(h2.T[ok], (h * h)[ok], rtol=1e-4, atol=1e-7)
    g = torch.as_tensor(rng.normal(size=(q2.shape[0],)), dtype=dtype, device=cuda_device)
    got = col.k1_dsigma(g, h2, sigma)
    ref = col.dsigma_plain(g.double(), h2.double(), sigma.double())
    scale = col.dsigma_plain(g.abs().double(), h2.double(), sigma.double())
    assert ((got.double() - ref).abs() <= (1e-5 if dtype == torch.float32 else 1e-12) * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_k1_packed_float64_matches_plain_on_card(robot, cuda_device):
    """K1's packed lookup in a float64 model: the bf16 words widened to float64
    as JAX's ``.astype`` widens them, FK and hinge in float64, against the
    plain version to 1e-9 relative."""
    spec, model = _grid_model(robot, torch.float64, cuda_device, "packed")
    rng = np.random.default_rng(8)
    q = torch.as_tensor(_configs(spec, rng, (4, 2000)), dtype=torch.float64, device=cuda_device)
    sigma = torch.full((4, spec.num_spheres), 0.005, dtype=torch.float64, device=cuda_device)
    before = col.k1_loglik.launches_by.get(("packed", "float64"), 0)
    _k1_mode_check(model, q, sigma, torch.float64)
    assert col.k1_loglik.launches_by[("packed", "float64")] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["nearest", "trilinear"])
def test_k1_grid_modes_composed_scene_on_card(mode, dtype, cuda_device):
    """K1 on the composed scene (two extra grids, every primitive kind) in the
    nearest and trilinear modes, float32 and float64, against the plain
    composition; a sphere centre inside a box gives a NaN d/dq on both sides."""
    spec, model = _grid_model("franka", dtype, cuda_device, mode, composed=True)
    rng = np.random.default_rng(4)
    q = torch.as_tensor(_configs(spec, rng, (4, 2000)), dtype=dtype, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(4, spec.num_spheres)), dtype=dtype,
                            device=cuda_device)
    with torch.no_grad():
        wins = source_wins(model.scene, dh.sphere_positions(model.fk, q), model.hinge_cost(q) > 0)
    assert len(wins) == 6 and min(wins.values()) > 0, wins
    _k1_mode_check(model, q, sigma, dtype)


# the split design's cases: few hinge-active pairs (ε = -5 cm: 1-15 % of the
# pairs), every pair active (ε = 5 m), and 2013 configs (a tail tile of 29);
# ε = 5 cm on 8000 configs otherwise
SPLIT_CASES = {"sparse_active": (-0.05, 8000), "all_active": (5.0, 8000), "tail_tile": (0.05, 2013)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("lookup", ["composed packed", "nearest", "composed nearest"])
def test_k1_split_design_cases_on_card(lookup, case, cuda_device):
    """K1's split design (every source's value first, the gradient only for
    hinge-active pairs: the composed packed lookup and the nearest cell,
    alone and composed) against the plain version on the same card, with few
    pairs active, every pair active and a tail tile. Tolerances as
    ``_k1_mode_check``'s (float32), but for the share of active configs; the
    forward without d/dq gives the same lik, and the σ-gradient forward the
    same lik and d/dq, bit for bit, and h² the plain hinge squared. A sphere
    centre inside a box makes d/dq NaN where its pair is hinge-active, in
    the kernel as in JAX; where it is not (only at ε < 0), the plain
    version's autodiff still gives NaN (the maximum's zero times the norm's
    NaN) and K1 takes no gradient (ROADMAP.md Queue 3): each side's NaN
    configs are held to that rule."""
    eps, T = SPLIT_CASES[case]
    if lookup == "composed packed":
        spec, model = _composed("franka", cuda_device)
    else:
        spec, model = _grid_model("franka", torch.float32, cuda_device, "nearest",
                                  composed=lookup.startswith("composed"))
    model = dataclasses.replace(model, epsilon=eps)
    rng = np.random.default_rng(13)
    q = torch.as_tensor(_configs(spec, rng, (1, T)), dtype=torch.float32, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(1, spec.num_spheres)), dtype=torch.float32,
                            device=cuda_device)
    with torch.no_grad():
        pairs = model.hinge_cost(q) > 0
        inside = dict(model.scene.sources(dh.sphere_positions(model.fk, q))).get("boxes")
        inside = torch.zeros_like(pairs) if inside is None else inside <= 0
    active = pairs.float().mean().item()
    if case == "all_active":
        assert active == 1.0
    elif case == "sparse_active":
        assert 0.01 < active < 0.15, active
    rtol, atol, gtol = ENVELOPE_TOL[torch.float32]
    lik_k, g_k, lik_p, g_p = _k1_against_plain(model, q, sigma)
    nan_k, nan_p = torch.isnan(g_k).any(-1), torch.isnan(g_p).any(-1)
    assert (nan_k != (inside & pairs).any(-1)).float().mean().item() <= 1e-3
    assert (nan_p != inside.any(-1)).float().mean().item() <= 1e-3
    both = ~nan_k & ~nan_p
    scale = g_p[both].abs().max().item()
    close = torch.isclose(lik_k, lik_p, rtol=rtol, atol=atol) & (
        ((g_k - g_p).abs() <= gtol * scale).all(-1) | ~both)
    assert (~close).float().mean().item() <= 1e-3
    torch.testing.assert_close(g_k[close & both], g_p[close & both], rtol=gtol, atol=gtol * scale)
    q2 = q.reshape(T, spec.dof)
    lik_f, dq_f, _ = col.k1_loglik(model, q2, sigma, True)
    lik_0, _, _ = col.k1_loglik(model, q2, sigma, False)
    lik_h, dq_h, h2 = col.k1_loglik(model, q2, sigma, True, True)
    assert torch.equal(lik_0, lik_f) and torch.equal(lik_h, lik_f)
    torch.testing.assert_close(dq_h, dq_f, rtol=0, atol=0, equal_nan=True)
    with torch.no_grad():
        h = model.hinge_cost(q2)
    ok = close.reshape(T)
    torch.testing.assert_close(h2.T[ok], (h * h)[ok], rtol=1e-4, atol=1e-7)


# K1-trilinear's cases: every pair hinge-active (ε = 5 m, the gradient pass
# for every pair) and 2013 configs (a tail tile of 29) at ε = 5 cm
TRILINEAR_CASES = {"all_active": (5.0, 4000), "tail_tile": (0.05, 2013)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRILINEAR_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("composed", [False, True], ids=["base", "composed"])
def test_k1_trilinear_cases_on_card(composed, dtype, case, cuda_device):
    """K1-trilinear (the base grid in the one-pass loop, the composed scene in
    the split design) against the plain version on the same card, with every
    pair active and with a tail tile, float32 and float64, at
    ``_k1_mode_check``'s tolerances (a config whose value or d/dq differs,
    a centre across a cell face, counts in the share); the σ-gradient
    forward gives the same lik and d/dq bit for bit, and h² the plain hinge
    squared (float32: 1e-3 relative + 1e-7, since a sphere centre that the
    FK's rounding moves by ~1e-7 m moves a trilinear value by that times the
    grid's slope, up to ~45 at the test grids' planted cells, and h² by
    2.4e-4 of itself in one pair of 74 481 on the card; float64 1e-9 + 1e-12).
    The forward without d/dq gives the same lik bit for bit on the
    base grid; on the composed scene it is another instantiation of the
    value pass, which the compiler fuses differently, and its lik may differ
    from the one with d/dq in the last bits: within 1e-6 relative in float32
    and 1e-14 in float64 (a few ulps of a sum of 37 terms)."""
    eps, T = TRILINEAR_CASES[case]
    spec, model = _grid_model("franka", dtype, cuda_device, "trilinear", composed=composed)
    model = dataclasses.replace(model, epsilon=eps)
    rng = np.random.default_rng(19)
    q = torch.as_tensor(_configs(spec, rng, (1, T)), dtype=dtype, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(1, spec.num_spheres)), dtype=dtype,
                            device=cuda_device)
    with torch.no_grad():
        active = (model.hinge_cost(q) > 0).float().mean().item()
    assert active == 1.0 if case == "all_active" else 0.02 < active < 0.9
    close = _k1_mode_check(model, q, sigma, dtype).reshape(T)
    q2 = q.reshape(T, spec.dof)
    lik_f, dq_f, _ = col.k1_loglik(model, q2, sigma, True)
    lik_0, _, _ = col.k1_loglik(model, q2, sigma, False)
    lik_h, dq_h, h2 = col.k1_loglik(model, q2, sigma, True, True)
    assert torch.equal(lik_h, lik_f)
    if composed:
        torch.testing.assert_close(lik_0, lik_f, rtol=1e-6 if dtype == torch.float32 else 1e-14, atol=0)
    else:
        assert torch.equal(lik_0, lik_f)
    torch.testing.assert_close(dq_h, dq_f, rtol=0, atol=0, equal_nan=True)
    with torch.no_grad():
        h = model.hinge_cost(q2)
    tol = dict(rtol=1e-3, atol=1e-7) if dtype == torch.float32 else dict(rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(h2.T[close], (h * h)[close], **tol)


def _k3_model64(robot, device):
    """``_k3_model`` in float64."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    sc = scene.Scene(base=sg.SdfGrid.from_arrays(data, np.array([-0.2, -0.3, 0.1]), 0.015,
                                                 torch.float64, device),
                     base_offset=torch.tensor([0.1, 0.0, -0.05], dtype=torch.float64, device=device))
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=torch.float64,
                                                            device=device), scene=sc, epsilon=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "wam", "kuka", "ur10"])
def test_k3_float64_matches_plain_on_card(robot, cuda_device):
    """K3's two entries in float64 (FK, corners, lerps and the floor in
    double) against the plain versions: clearances to 1e-9 m, NaN configs NaN
    on both sides, the segment counts equal but for probes within 1e-9 m of
    their floor."""
    from vgpmp_torch import sim

    spec, model = _k3_model64(robot, cuda_device)
    q = torch.as_tensor(_configs(spec, np.random.default_rng(3), (8000,)), dtype=torch.float64,
                        device=cuda_device)
    q[:5, 2] = float("nan")
    before = col.k3_min_clearance.launches_by.get("float64", 0)
    got = model.min_clearance_eval(q)
    assert col.k3_min_clearance.launches_by["float64"] == before + 1
    want = col.min_clearance_eval_plain(model, q)
    assert torch.isnan(got[:5]).all() and torch.isnan(want[:5]).all()
    assert (want[5:] < 0).float().mean() > 0.05
    torch.testing.assert_close(got[5:], want[5:], rtol=0, atol=1e-9)

    rng = np.random.default_rng(12)
    B, T = 6, 15
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    a, b = (mid + 0.6 * half * rng.uniform(-1, 1, (B, spec.dof)) for _ in range(2))
    w = np.linspace(0, 1, T)[None, :, None]
    traj = torch.as_tensor(a[:, None] * (1 - w) + b[:, None] * w, dtype=torch.float64, device=cuda_device)
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj, samples_per_segment=7)
    q_s, q_g = traj[:, 0], traj[:, -1]
    plain = lambda x: col.min_clearance_eval_plain(model, x)
    depth_s, depth_g = torch.clamp(-plain(torch.cat([q_s, q_g])), min=0.0).split(B)
    args = (q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T, 0.5, 5e-3)
    before = col.k3_probe_clearance.launches_by.get("float64", 0)
    clear, count = model.probe_clearance(qs, *args)
    assert col.k3_probe_clearance.launches_by["float64"] == before + 1
    want_clear, want_count = sim.probe_clearance_plain(plain, qs, *args)
    torch.testing.assert_close(clear, want_clear, rtol=0, atol=1e-9)
    floor = sim._floor_from_depths(qs, q_s, q_g, depth_s, depth_g, 0.5, 5e-3)
    near = visited & ((want_clear - floor).abs() <= 1e-9)
    far = sim._segment_count(seg_idx, visited & (want_clear < floor) & ~near, T)
    assert ((far <= count) & (count <= far + sim._segment_count(seg_idx, near, T))).all()
    assert want_count.sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_k3_float64_composed_scene_on_card(robot, cuda_device):
    """K3 in float64 on the composed scene (extras in float64) against the
    plain composition, to 1e-9 m."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    sc = torch_scene_with_objects(data, np.array([-0.2, -0.3, 0.1]), 0.015, [0.1, 0.0, -0.05],
                                  torch.float64, cuda_device, packed=False)
    spec = robots.load_robot(robot)
    model = col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=torch.float64,
                                                       device=cuda_device), scene=sc, epsilon=0.05)
    q = torch.as_tensor(_configs(spec, np.random.default_rng(5), (8000,)), dtype=torch.float64,
                        device=cuda_device)
    got = model.min_clearance_eval(q)
    want = col.min_clearance_eval_plain(model, q)
    assert (want < 0).float().mean() > 0.05
    torch.testing.assert_close(got, want, rtol=0, atol=1e-9)


# (n, T, k): the block design at n = 33 (its first size), 40, 64 and 128
# (KERNEL_BLOCK_MAX_N); T = 1 and 5 (a non-SPD matrix among others); k either side
# of the solves' 128-column tile (129, 130: two blocks a matrix) and of the
# backward's 16- to 64-column tiles; the last panel's ragged edges (n = 63,
# 65, 96, 97, 127: 31, 1, 32, 1 and 31 rows); T = 252, more blocks than SMs;
# k = 33 at n = 128, whose backward tile is narrower than k rounded up to 16
K2_BIG_CASES = [(33, 5, 1), (40, 5, 7), (40, 1, 65), (64, 5, 64), (64, 5, 130), (100, 3, 9),
                (128, 5, 1), (128, 3, 71), (128, 5, 129), (63, 5, 33), (65, 5, 17), (96, 3, 100),
                (97, 5, 71), (127, 3, 16), (128, 3, 33), (40, 252, 100), (128, 252, 71)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,k", K2_BIG_CASES)
def test_k2_block_design_matches_plain_on_card(cuda_device, n, T, k):
    """K2 above n = 32 (one block a matrix, its lower tiles in shared memory):
    the lone factorisation and both solves, forward and backward, and the
    fused pair, forward and backward, against the plain versions; float64 on
    well-conditioned input, so 1e-9 relative (gradients 1e-8). A non-SPD
    matrix gives NaN in itself and in no other matrix."""
    rng = np.random.default_rng(1000 * n + T + k)
    K = torch.as_tensor(_spd(rng, T, n), device=cuda_device)
    Bm = torch.as_tensor(rng.normal(size=(T, n, k)), device=cuda_device)
    WL = torch.as_tensor(rng.normal(size=(T, n, n)), device=cuda_device)
    ok = torch.ones(T, dtype=torch.bool, device=cuda_device)
    if T > 1:
        K[T // 2] = -K[T // 2]
        ok[T // 2] = False
    L_k = la.k2_chol(K)
    L_p = la.cholesky_unrolled(K)
    if T > 1:
        assert torch.isnan(L_k[T // 2]).any() and torch.isnan(L_p[T // 2]).any()
    torch.testing.assert_close(L_k[ok], L_p[ok], rtol=1e-9, atol=1e-12)
    for upper_t, plain in [(False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)]:
        X = la.k2_trsm(L_k, Bm, upper_t)
        if T > 1:
            assert torch.isnan(X[T // 2]).any()
        torch.testing.assert_close(X[ok], plain(L_p[ok], Bm[ok]), rtol=1e-9, atol=1e-12)
    for fn, plain in [(la.solve_lower, la.solve_lower_unrolled),
                      (la.solve_upper_T, la.solve_upper_T_unrolled)]:
        Kt, Bt = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
        g_k = torch.autograd.grad(fn(la.chol(Kt), Bt).square().sum(), [Kt, Bt])
        Kp, Bp = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
        g_p = torch.autograd.grad(plain(la.cholesky_unrolled(Kp), Bp).square().sum(), [Kp, Bp])
        for a, b in zip(g_k, g_p):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10 * b.abs().max().item())
    L_f, X_f = la.k2_factor_solve(K, Bm)
    L_fp, X_fp = la.factor_solve_plain(K, Bm)
    if T > 1:
        assert torch.isnan(L_f[T // 2]).any() and torch.isnan(X_f[T // 2]).any()
    torch.testing.assert_close(L_f[ok], L_fp[ok], rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(X_f[ok], X_fp[ok], rtol=1e-9, atol=1e-12)
    gK, gB = la.k2_factor_solve_bwd(L_fp[ok].contiguous(), X_fp[ok].contiguous(), WL[ok].contiguous(),
                                    Bm[ok].contiguous())
    gK_p, gB_p = la.factor_solve_bwd_plain(L_fp[ok], X_fp[ok], WL[ok], Bm[ok])
    for a, b in ((gK, gK_p), (gB, gB_p)):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10 * b.abs().max().item())


# (n, T, k): the streamed design above n = 128: one row in the last panel
# (129), a whole one (160, 256), a ragged one (200), and 512 (sixteen panels);
# T = 252, more blocks than SMs; k = 251 (the extraction's: two 128-column
# tiles), 33 (ragged against the backward's 32-column chunks), 71 and 100
K2_STREAMED_CASES = [(129, 3, 71), (160, 252, 71), (160, 5, 251), (200, 3, 33), (256, 252, 71),
                     (256, 3, 100), (512, 2, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,T,k", K2_STREAMED_CASES)
def test_k2_streamed_design_matches_plain_on_card(cuda_device, n, T, k, dtype):
    """K2 above n = 128 (one block a matrix, its lower tiles in device
    memory): the lone factorisation and both solves, forward and backward
    (through ``chol`` and the solves' autograd, on at most 8 matrices: the
    plain version's autograd keeps n steps of [T, n, n]), and the fused pair,
    forward and backward, against the plain versions, relative to the
    largest reference entry: float64 to 1e-9 (gradients 1e-8), float32 to
    1e-4 (the plain float32 version rounds in another order; condition
    ~10). A non-SPD matrix gives NaN in itself and in no other matrix."""
    rng = np.random.default_rng(1000 * n + T + k)
    tol, gtol = (1e-9, 1e-8) if dtype == torch.float64 else (1e-4, 1e-4)
    close = lambda got, want, t: torch.testing.assert_close(got, want, rtol=0, atol=t * want.abs().max().item())
    K = torch.as_tensor(_spd(rng, T, n), dtype=dtype, device=cuda_device)
    Bm = torch.as_tensor(rng.normal(size=(T, n, k)), dtype=dtype, device=cuda_device)
    WL = torch.as_tensor(rng.normal(size=(T, n, n)), dtype=dtype, device=cuda_device)
    bad = T // 2
    K[bad] = -K[bad]
    ok = torch.ones(T, dtype=torch.bool, device=cuda_device)
    ok[bad] = False
    L_k = la.k2_chol(K)
    L_p = la.cholesky_unrolled(K)
    assert torch.isnan(L_k[bad]).any() and torch.isfinite(L_k[ok]).all()
    close(L_k[ok], L_p[ok], tol)
    for upper_t, plain in [(False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)]:
        X = la.k2_trsm(L_k, Bm, upper_t)
        assert torch.isnan(X[bad]).any() and torch.isfinite(X[ok]).all()
        close(X[ok], plain(L_p[ok], Bm[ok]), tol)
    few = torch.nonzero(ok).flatten()[:8]
    for fn, plain in [(la.solve_lower, la.solve_lower_unrolled),
                      (la.solve_upper_T, la.solve_upper_T_unrolled)]:
        Kt, Bt = K[few].clone().requires_grad_(), Bm[few].clone().requires_grad_()
        g_k = torch.autograd.grad(fn(la.chol(Kt), Bt).square().sum(), [Kt, Bt])
        Kp, Bp = K[few].clone().requires_grad_(), Bm[few].clone().requires_grad_()
        g_p = torch.autograd.grad(plain(la.cholesky_unrolled(Kp), Bp).square().sum(), [Kp, Bp])
        for a, b in zip(g_k, g_p):
            close(a, b, gtol)
    L_f, X_f = la.k2_factor_solve(K, Bm)
    L_fp, X_fp = la.factor_solve_plain(K, Bm)
    assert torch.isnan(L_f[bad]).any() and torch.isnan(X_f[bad]).any()
    close(L_f[ok], L_fp[ok], tol)
    close(X_f[ok], X_fp[ok], tol)
    gK, gB = la.k2_factor_solve_bwd(L_fp[ok].contiguous(), X_fp[ok].contiguous(), WL[ok].contiguous(),
                                    Bm[ok].contiguous())
    gK_p, gB_p = la.factor_solve_bwd_plain(L_fp[ok], X_fp[ok], WL[ok], Bm[ok])
    close(gK, gK_p, gtol)
    close(gB, gB_p, gtol)


@pytest.mark.cuda
def test_k2_streamed_design_on_real_grams_on_card(cuda_device):
    """K2's streamed design on the real conditioned Grams of a
    franka/industrial session at Mc = 160 (condition ~3e10), against the
    plain versions, all four entries, at the block design's real-Gram
    tolerances (``test_k2_block_design_on_real_grams_on_card``): the factor,
    the solves and the backward to 1e-9 of the largest reference entry, the
    pair's X to 1e-6."""
    K = real_grams(158).to(cuda_device)
    T, n = K.shape[0], K.shape[-1]
    rng = np.random.default_rng(160)
    Bm = torch.as_tensor(rng.normal(size=(T, n, 71)), device=cuda_device)
    WL = torch.as_tensor(rng.normal(size=(T, n, n)), device=cuda_device)
    close = lambda got, want, tol: torch.testing.assert_close(got, want, rtol=0,
                                                              atol=tol * want.abs().max().item())
    L_p = la.cholesky_unrolled(K)
    close(la.k2_chol(K), L_p, 1e-9)
    for upper_t, plain in [(False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)]:
        close(la.k2_trsm(L_p, Bm, upper_t), plain(L_p, Bm), 1e-9)
    L_f, X_f = la.k2_factor_solve(K, Bm)
    L_q, X_q = la.factor_solve_plain(K, Bm)
    close(L_f, L_q, 1e-9)
    close(X_f, X_q, 1e-6)
    gK, gB = la.k2_factor_solve_bwd(L_q, X_q, WL, Bm)
    gK_p, gB_p = la.factor_solve_bwd_plain(L_q, X_q, WL, Bm)
    close(gK, gK_p, 1e-9)
    close(gB, gB_p, 1e-9)
    assert torch.isfinite(gK).all() and torch.isfinite(X_f).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,k", [(12, 252, 1), (12, 252, 100), (12, 251, 71), (26, 253, 17),
                                   (26, 251, 100), (40, 5, 20), (64, 5, 71), (128, 5, 100)])
def test_k2_float32_matches_plain_on_card(cuda_device, n, T, k):
    """K2's float32 instantiations (the warp design at n = 12 and 26, the
    block design at 40, 64 and 128): the lone factorisation and solves, and
    the fused pair, against the plain versions in float32; 1e-4 relative (+1e-5 of the
    largest entry: float32 sums in another order on matrices of condition
    ~10). A non-positive pivot gives NaN in its own matrix and in no
    neighbour of its warp or block, as the jitter escalation needs."""
    rng = np.random.default_rng(1000 * n + T + k)
    K = torch.as_tensor(_spd(rng, T, n), dtype=torch.float32, device=cuda_device)
    Bm = torch.as_tensor(rng.normal(size=(T, n, k)), dtype=torch.float32, device=cuda_device)
    bad = T // 2
    K[bad, n - 1, n - 1] = -1.0  # the last pivot goes negative
    ok = torch.ones(T, dtype=torch.bool, device=cuda_device)
    ok[bad] = False
    before = (la.k2_chol.launches_by.get("float32", 0), la.k2_trsm.launches_by.get("float32", 0))
    L_k = la.k2_chol(K)
    L_p = la.cholesky_unrolled(K)
    assert torch.isnan(L_k[bad]).any() and torch.isnan(L_p[bad]).any()
    assert torch.isfinite(L_k[ok]).all()
    tol = lambda b: dict(rtol=1e-4, atol=1e-5 * b.abs().max().item())
    torch.testing.assert_close(L_k[ok], L_p[ok], **tol(L_p[ok]))
    for upper_t, plain in [(False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)]:
        X = la.k2_trsm(L_k, Bm, upper_t)
        assert torch.isfinite(X[ok]).all()
        want = plain(L_p[ok], Bm[ok])
        torch.testing.assert_close(X[ok], want, **tol(want))
    assert (la.k2_chol.launches_by["float32"], la.k2_trsm.launches_by["float32"]) == (
        before[0] + 1, before[1] + 2)
    L_f, X_f = la.factor_solve(K, Bm)
    L_fp, X_fp = la.factor_solve_plain(K, Bm)
    assert torch.isnan(L_f[bad]).any() and torch.isfinite(L_f[ok]).all()
    torch.testing.assert_close(L_f[ok], L_fp[ok], **tol(L_fp[ok]))
    torch.testing.assert_close(X_f[ok], X_fp[ok], **tol(X_fp[ok]))


@pytest.mark.cuda
def test_k2_block_design_on_real_grams_on_card(cuda_device):
    """K2's block design on the real conditioned Grams of a franka/industrial
    session at Mc = 40 (condition ~8e9), against the plain versions, all four
    entries. Relative to the largest reference entry: the factor to 1e-9
    (its rounding in another order, amplified by the square root of the
    condition: 4e-11 in a float64 emulation of the blocked order); the solves
    and the backward, given the same factor, to 1e-9 (4e-14 there); the
    fused pair's X = L^-1 B, whose own factor differs by that 4e-11, to 1e-6
    (the solve multiplies it by the factor's condition, ~1e5: 6e-8 there)."""
    K = mc40_grams().to(cuda_device)
    T, n = K.shape[0], K.shape[-1]
    rng = np.random.default_rng(40)
    Bm = torch.as_tensor(rng.normal(size=(T, n, 71)), device=cuda_device)
    WL = torch.as_tensor(rng.normal(size=(T, n, n)), device=cuda_device)
    close = lambda got, want, tol: torch.testing.assert_close(got, want, rtol=0,
                                                              atol=tol * want.abs().max().item())
    L_p = la.cholesky_unrolled(K)
    close(la.k2_chol(K), L_p, 1e-9)
    for upper_t, plain in [(False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)]:
        close(la.k2_trsm(L_p, Bm, upper_t), plain(L_p, Bm), 1e-9)
    L_f, X_f = la.k2_factor_solve(K, Bm)
    L_q, X_q = la.factor_solve_plain(K, Bm)
    close(L_f, L_q, 1e-9)
    close(X_f, X_q, 1e-6)
    gK, gB = la.k2_factor_solve_bwd(L_q, X_q, WL, Bm)
    gK_p, gB_p = la.factor_solve_bwd_plain(L_q, X_q, WL, Bm)
    close(gK, gK_p, 1e-9)
    close(gB, gB_p, 1e-9)
    assert torch.isfinite(gK).all() and torch.isfinite(X_f).all()


# ------------------------------------------------ K1 packed in float64, the composed K3

# the float64 packed lookup's cases: every pair hinge-active (ε = 5 m), a tail
# tile of 29 (2013 configs), and a NaN config among them
F64_PACKED_CASES = {"all_active": (5.0, 8000), "tail_tile": (0.05, 2013), "nan_config": (0.05, 2013)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(F64_PACKED_CASES))
@pytest.mark.parametrize("robot", ["franka", "ur10"])
def test_k1_packed_float64_cases_on_card(robot, case, cuda_device):
    """K1's packed lookup in float64 (phase 1 over the block, the cell by
    ``div_by``, three words in flight) against the plain version
    (``_k1_mode_check``'s float64 tolerances) with every pair active, at a
    tail tile, and with a NaN config: its cell is the clamped one on both
    sides, so its lik is the plain version's, and the other configs' lik and
    d/dq are the same bits as without it. The forward without d/dq gives the
    same lik, and the σ-gradient forward the same lik and d/dq, bit for bit,
    and h² the plain hinge squared (1e-12 relative)."""
    eps, T = F64_PACKED_CASES[case]
    spec, model = _grid_model(robot, torch.float64, cuda_device, "packed")
    model = dataclasses.replace(model, epsilon=eps)
    rng = np.random.default_rng(14)
    q = torch.as_tensor(_configs(spec, rng, (1, T)), dtype=torch.float64, device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.003, 0.008, size=(1, spec.num_spheres)), dtype=torch.float64,
                            device=cuda_device)
    q2 = q.reshape(T, spec.dof)
    if case == "nan_config":
        lik_c, dq_c, _ = col.k1_loglik(model, q2, sigma, True)
        q2 = q2.clone()
        q2[1000, 3] = float("nan")  # in the tile of configs 992..1023
        lik_n, dq_n, _ = col.k1_loglik(model, q2, sigma, True)
        rest = torch.arange(T, device=cuda_device) != 1000
        assert torch.equal(lik_n[rest], lik_c[rest]) and torch.equal(dq_n[rest], dq_c[rest])
        lik_p = col.log_prob_plain(model, q2[None], sigma)[0]
        assert torch.isfinite(lik_n[1000]) and torch.isclose(lik_n[1000], lik_p[1000], rtol=1e-12, atol=0)
        q = q2[None][:, rest]
    if case == "all_active":
        assert (model.hinge_cost(q2) > 0).all()
    close = _k1_mode_check(model, q, sigma, torch.float64)
    q2 = q.reshape(-1, spec.dof)
    lik_f, dq_f, _ = col.k1_loglik(model, q2, sigma, True)
    lik_0, _, _ = col.k1_loglik(model, q2, sigma, False)
    lik_h, dq_h, h2 = col.k1_loglik(model, q2, sigma, True, True)
    assert torch.equal(lik_0, lik_f) and torch.equal(lik_h, lik_f) and torch.equal(dq_h, dq_f)
    h = model.hinge_cost(q2)
    ok = close.reshape(-1)
    torch.testing.assert_close(h2.T[ok], (h * h)[ok], rtol=1e-12, atol=0)


def _composed_k3(robot, dtype, device, zero_capsule=False):
    """``_composed``'s small-base scene (which sphere centres leave) in
    ``dtype``, unpacked, for K3; ``zero_capsule`` makes the capsule's segment
    a point, whose distance is NaN everywhere (0/0, as JAX's)."""
    data = smooth_grid(np.random.default_rng(5), SHAPE, scale=1.0) - np.float32(0.1)
    sc = torch_scene_with_objects(data, np.array([-0.2, -0.3, 0.1]), 0.015, [0.1, 0.0, -0.05], dtype, device,
                                  packed=False)
    if zero_capsule:
        p = sc.primitives
        sc = dataclasses.replace(sc, primitives=dataclasses.replace(p, capsule_b=p.capsule_a.clone()))
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=dtype, device=device),
                                    scene=sc, epsilon=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("robot", ["franka", "wam", "ur10"])
def test_k3_composed_both_entries_on_card(robot, dtype, cuda_device):
    """The composed K3 (``primitives_min_near``: a primitive evaluated only
    where its bounds reach below the minimum so far) in both entries and
    both dtypes, on 7 joints in Craig's convention
    (franka) and the classic one (wam) and on 6 (ur10), against the plain
    versions: the clearance to 1e-5 m (1e-9 m in float64), NaN configs NaN
    on both sides, every source attaining the minimum somewhere, the
    segment counts equal but for probes within the tolerance of their floor.
    With a zero-length capsule every clearance is NaN on both sides and no
    probe is counted."""
    from vgpmp_torch import sim

    tol = 1e-9 if dtype == torch.float64 else 1e-5
    key = str(dtype).removeprefix("torch.")
    spec, model = _composed_k3(robot, dtype, cuda_device)
    q = torch.as_tensor(_configs(spec, np.random.default_rng(6), (8013,)), dtype=dtype, device=cuda_device)
    q[:5, 2] = float("nan")
    before = col.k3_min_clearance.launches_by.get(key, 0)
    got = model.min_clearance_eval(q)
    assert col.k3_min_clearance.launches_by[key] == before + 1
    want = col.min_clearance_eval_plain(model, q)
    with torch.no_grad():
        wins = source_wins(model.scene, dh.sphere_positions(model.fk, q[5:]), None, "trilinear")
    assert len(wins) == 6 and min(wins.values()) > 0, wins
    assert torch.isnan(got[:5]).all() and torch.isnan(want[:5]).all() and not torch.isnan(want[5:]).any()
    torch.testing.assert_close(got[5:], want[5:], rtol=0, atol=tol)

    rng = np.random.default_rng(12)
    B, T = 6, 15
    lo, hi = spec.joint_limits[:, 1], spec.joint_limits[:, 0]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    a, b = (mid + 0.6 * half * rng.uniform(-1, 1, (B, spec.dof)) for _ in range(2))
    w = np.linspace(0, 1, T)[None, :, None]
    traj = torch.as_tensor(a[:, None] * (1 - w) + b[:, None] * w, dtype=dtype, device=cuda_device)
    traj[5, T // 2:] = float("nan")
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj, samples_per_segment=7)
    q_s, q_g = traj[:, 0], traj[:, -1]
    plain = lambda x: col.min_clearance_eval_plain(model, x)
    depth_s, depth_g = torch.clamp(-plain(torch.cat([q_s, q_g])), min=0.0).split(B)
    args = (q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T, 0.5, 5e-3)
    before = col.k3_probe_clearance.launches_by.get(key, 0)
    clear, count = model.probe_clearance(qs, *args)
    assert col.k3_probe_clearance.launches_by[key] == before + 1
    want_clear, want_count = sim.probe_clearance_plain(plain, qs, *args)
    assert torch.equal(torch.isnan(clear), torch.isnan(want_clear)) and torch.isnan(want_clear[5]).any()
    torch.testing.assert_close(clear, want_clear, rtol=0, atol=tol, equal_nan=True)
    floor = sim._floor_from_depths(qs, q_s, q_g, depth_s, depth_g, 0.5, 5e-3)
    near = visited & ((want_clear - floor).abs() <= tol)
    far = sim._segment_count(seg_idx, visited & (want_clear < floor) & ~near, T)
    assert ((far <= count) & (count <= far + sim._segment_count(seg_idx, near, T))).all()
    assert want_count.sum() > 0

    _, zmodel = _composed_k3(robot, dtype, cuda_device, zero_capsule=True)
    assert torch.isnan(zmodel.min_clearance_eval(q)).all()
    assert torch.isnan(col.min_clearance_eval_plain(zmodel, q)).all()
    zclear, zcount = zmodel.probe_clearance(qs, *args)
    assert torch.isnan(zclear).all() and zcount.sum() == 0


def _k5_synthetic(seed, pieces, tris, dims, delta, padding):
    import chip_smoke

    return chip_smoke.synthetic_mesh(seed, pieces, tris, dims, delta, padding)


# name -> (mesh, delta, padding): the cube; 40 pieces and 640 triangles (more
# than a shared-memory tile of K5); 4 000 triangles (nine tiles); the smoke's
# mesh counts (23 pieces, 422 triangles) on a smaller grid; two cubes
# stretched along x, whose columns take two blocks
K5_MESHES = {
    "cube": (cube_mesh, 0.03, 4),
    "forty_pieces_tiled": (lambda: _k5_synthetic(1, 40, 640, (60, 52, 36), 0.025, 3), 0.025, 3),
    "nine_tiles": (lambda: _k5_synthetic(3, 150, 4000, (40, 44, 30), 0.03, 2), 0.03, 2),
    "smoke_counts": (lambda: _k5_synthetic(0, 23, 422, (85, 101, 52), 0.0187, 6), 0.0187, 6),
    "two_blocks_a_column": (lambda: two_cubes_mesh((4.0, 0.1, 0.1)), 0.01, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K5_MESHES))
def test_k5_matches_plain_on_card(name, cuda_device):
    """K5 through ``mesh_to_sdf`` on the card against the plain version on the
    same device: 1e-6 m (float64 inside, FMAs contracted on the card), the
    sign bit equal in every cell, one launch a call."""
    from vgpmp_torch.sdf import gen

    make, delta, padding = K5_MESHES[name]
    verts, tris, piece = make()
    before = gen.k5_mesh_sdf.launches
    data, origin, delta = gen.mesh_to_sdf(verts, tris, piece, delta=delta, padding=padding)
    torch.cuda.synchronize()
    assert gen.k5_mesh_sdf.launches == before + 1
    assert data.is_cuda and data.dtype == torch.float32
    t = [torch.as_tensor(x, device=cuda_device) for x in (verts, tris, piece)]
    plain = gen.sdf_grid_plain(*t, origin, delta, data.shape)
    assert torch.isfinite(data).all()
    assert (data - plain).abs().max().item() <= 1e-6
    assert torch.equal(torch.signbit(data), torch.signbit(plain))
    assert 0 < int((data < 0).sum()) < data.numel()


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take(cuda_device):
    from vgpmp_torch.sdf import gen

    verts, tris, piece = (torch.as_tensor(x, device=cuda_device) for x in cube_mesh())
    with pytest.raises(ValueError, match="T >= 1"):
        gen.k5_mesh_sdf(verts, tris[:0], piece[:0], (0.0, 0.0, 0.0), 0.1, (4, 4, 4))
    with pytest.raises(ValueError, match="dims"):
        gen.k5_mesh_sdf(verts, tris, piece, (0.0, 0.0, 0.0), 0.1, (4, 0, 4))


# K6: (name, dtype, S, N, Mc, derivative rows (the first 2), bases, rows)
K6_CASES = [
    ("wam", torch.float32, 7, 70, 26, False, 1024, 64),
    ("franka", torch.float32, 20, 50, 12, False, 1024, 64),
    ("velocity", torch.float32, 20, 50, 14, True, 1024, 16),
    ("extraction", torch.float32, 150, 150, 26, False, 1024, 8),
    ("tails", torch.float32, 9, 37, 5, True, 1000, 5),
    ("wam_f64", torch.float64, 7, 70, 26, False, 1024, 16),
    ("velocity_f64", torch.float64, 20, 150, 40, True, 1100, 8),
]


def _k6_inputs(dtype, S, N, Mc, deriv, nb, R, device, L=7, seed=0):
    """The prior's inputs as the pathwise draw makes them: the port's own
    Student-t draws over lengthscales down to 0.04 (|ω| past 50), inducing
    inputs in (0, 1) that take a gradient, a grid that takes none."""
    from vgpmp_torch.gp import pathwise

    g = torch.Generator().manual_seed(seed)
    noise = pathwise.draw_noise((R,), L, Mc, S, nb, dtype, "cpu", g)
    ls = 0.04 + 0.26 * torch.rand(R, L, dtype=dtype, generator=g)
    var = 0.5 + 1.5 * torch.rand(R, L, dtype=dtype, generator=g)
    x = torch.sort(torch.rand(R, L, Mc, dtype=dtype, generator=g), dim=-1).values
    t = {"x": x, "x_const": torch.linspace(0, 1, N, dtype=dtype).expand(R, L, N),
         "omega": noise.t / ls[..., None], "phase": noise.phase,
         "scale": torch.sqrt(2.0 * var[..., None] / nb), "w": noise.w,
         "g": torch.randn(R, S, L, Mc + N, dtype=dtype, generator=g)}
    mask = (torch.arange(Mc) < 2) if deriv else None
    return {k: v.to(device) for k, v in t.items()}, mask


def test_k6_refuses_cpu_tensors_and_the_cpu_takes_the_plain_chain():
    t, mask = _k6_inputs(torch.float64, 3, 9, 5, True, 40, 2, "cpu")
    P = 2 * 7
    with pytest.raises(ValueError):
        rff.k6_rff(t["x"].reshape(P, -1), t["omega"].reshape(P, -1), t["phase"].reshape(P, -1),
                   t["scale"].reshape(P), t["w"], None)
    before = (rff.k6_rff.launches, rff.k6_rff.plain_on_card)
    args = (t["omega"], t["phase"], t["scale"], t["w"])
    joint = rff.prior_paths(t["x"], *args, mask, x_const=t["x_const"])
    apart = torch.cat([rff.prior_paths(t["x"], *args, mask), rff.prior_paths(t["x_const"], *args)], dim=-1)
    torch.testing.assert_close(joint, apart, rtol=1e-13, atol=1e-13)
    assert (rff.k6_rff.launches, rff.k6_rff.plain_on_card) == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,S,N,Mc,deriv,nb,R", K6_CASES, ids=[c[0] for c in K6_CASES])
def test_k6_matches_plain_on_card(name, dtype, S, N, Mc, deriv, nb, R, cuda_device):
    """K6 through ``prior_paths`` (one launch for the inducing inputs and the
    grid, as the draw makes it) against the plain chain in float64 with
    autograd on the same card: the paths and the gradients of x, ω and the
    scale within 2e-5 of the largest magnitude in float32 (the argument's
    float32 rounding at |ωx| up to ~200, the SFU's sine and cosine on the
    reduced argument, sums in another order), 1e-12 in float64; one launch
    forward and one backward; the same bits on a second run."""
    t, mask = _k6_inputs(dtype, S, N, Mc, deriv, nb, R, cuda_device)
    assert t["omega"].abs().max() > 50

    def run(k6):
        d = {k: v.detach().clone() for k, v in t.items()}
        if not k6:
            d = {k: v.double() for k, v in d.items()}
        for k in ("x", "omega", "scale"):
            d[k].requires_grad_(True)
        m = None if mask is None else mask.to(cuda_device)
        out = (rff.prior_paths if k6 else rff.prior_paths_plain)(d["x"], d["omega"], d["phase"], d["scale"],
                                                                  d["w"], m, x_const=d["x_const"])
        (out * d["g"]).sum().backward()
        return [v.detach() for v in (out, d["omega"].grad, d["scale"].grad, d["x"].grad)]

    before, plain_before = rff.k6_rff.launches, rff.k6_rff.plain_on_card
    got = run(True)
    torch.cuda.synchronize()
    assert rff.k6_rff.launches == before + 2 and rff.k6_rff.plain_on_card == plain_before
    want = run(False)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    for name_, g, w in zip(("paths", "d omega", "d scale", "d x"), got, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), name_
        err = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert err <= tol, (name_, err)
    for a, b in zip(got, run(True)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_refuses_what_it_does_not_take(cuda_device):
    t, mask = _k6_inputs(torch.float32, 3, 9, 5, False, 40, 2, cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        rff.prior_paths(t["x"], t["omega"].double(), t["phase"], t["scale"], t["w"])
    with pytest.raises(ValueError, match="noise"):
        rff.prior_paths(t["x"], t["omega"], t["phase"], t["scale"], t["w"].requires_grad_(True))


# the ur10-bookshelves-b3520 cell's round 0: rows, samples, training grid, metric grid
UR10_ROUND0 = (3520, 7, 70, 150)


def _ur10_bookshelves(device):
    """The cell's session: UR10 (6 joints, standard DH, 17 spheres) on the
    real bookshelves grid, packed for training; its 55 queries tiled to the
    cell's rows."""
    from vgpmp_torch.session import PlanningSession

    sess = PlanningSession("ur10", "bookshelves", dtype=torch.float32, sdf_mode="packed", use_tuned=True,
                           device=device)
    starts, goals = sess.queries()
    idx = np.arange(UR10_ROUND0[0]) % len(starts)
    as_t = lambda x: torch.as_tensor(x[idx], dtype=torch.float32, device=device)
    return sess.model.collision, as_t(starts), as_t(goals)


@pytest.mark.cuda
def test_k1_six_joints_at_the_ur10_cells_round0_on_card(cuda_device):
    """K1 for 6 joints and standard DH on the bookshelves grid at the
    ``ur10-bookshelves-b3520`` cell's round-0 size (3 520 rows x 7 samples x
    70 points): configurations along the queries' lines with 1 rad of noise
    (about a quarter hinge-active; most of the lines alone touch a shelf),
    at the cell's σ, against the plain version on the same card, with
    ``test_k1_matches_plain_on_card``'s tolerances. Launched for (6,
    standard DH) only, and the plain version counted on the card."""
    model, s, g = _ur10_bookshelves(cuda_device)
    B, S, N, _ = UR10_ROUND0
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    frac = torch.linspace(0, 1, N, device=cuda_device)[None, None, :, None]
    q = s[:, None, None] + (g - s)[:, None, None] * frac
    q = q + torch.randn((B, S, N, 6), generator=gen, device=cuda_device)
    sigma = torch.full((B, model.fk.sphere_radii.shape[0]), 5e-4, device=cuda_device)
    col.k1_loglik.launches_by_arm, col.k1_loglik.plain_on_card = {}, 0
    qk = q.clone().requires_grad_()
    lik_k = model.log_prob(qk, sigma)
    lik_k.sum().backward()
    assert col.k1_loglik.launches_by_arm == {(6, False): 1} and col.k1_loglik.plain_on_card == 0
    qp = q.clone().requires_grad_()
    lik_p = col.log_prob_plain(model, qp, sigma)
    lik_p.sum().backward()
    assert col.k1_loglik.plain_on_card == 1
    assert 0.01 < (lik_p < 0).float().mean() < 0.5
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    assert (~close).float().mean().item() <= 1e-3
    torch.testing.assert_close(qk.grad[close], qp.grad[close], rtol=1e-3,
                               atol=1e-3 * qp.grad.abs().max().item())


@pytest.mark.cuda
def test_k3_six_joints_at_the_ur10_cells_round0_on_card(cuda_device):
    """Both K3 entries for 6 joints and standard DH on the bookshelves grid at
    the cell's round-0 size: the clearance of the round's 3 x 3 520 endpoint
    configurations, and the probes of 3 520 trajectories of 150 points along
    the queries' lines with 0.6 rad of noise (``pd_path_configs``' 9 600
    probes a row, 33.8 M in all; about half of them below 0), against
    the plain versions on the same card (the probes 440 rows at a time),
    with ``test_k3_probe_entry_matches_plain_on_card``'s tolerances.
    Launched for (6, standard DH) only."""
    from vgpmp_torch import sim

    model, s, g = _ur10_bookshelves(cuda_device)
    B, _, _, T = UR10_ROUND0
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    w = torch.linspace(0, 1, T, device=cuda_device)[None, :, None]
    traj = s[:, None] * (1 - w) + g[:, None] * w
    traj = traj + 0.6 * torch.randn((B, T, 6), generator=gen, device=cuda_device) * torch.sin(np.pi * w)
    for f in (col.k3_min_clearance, col.k3_probe_clearance):
        f.launches_by_arm = {}
    ends = torch.cat([s, g, traj[:, 0]])
    torch.testing.assert_close(model.min_clearance_eval(ends), col.min_clearance_eval_plain(model, ends),
                               rtol=0, atol=1e-5)
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj)
    depth_s, depth_g = torch.clamp(-model.min_clearance_eval(torch.cat([s, g])), min=0.0).split(B)
    args = (s, g, depth_s, depth_g, visited[:, 0], seg_idx, T, 0.5, 5e-3)
    clear, count = model.probe_clearance(qs, *args)
    assert col.k3_min_clearance.launches_by_arm == {(6, False): 2}
    assert col.k3_probe_clearance.launches_by_arm == {(6, False): 1}
    plain = lambda q: col.min_clearance_eval_plain(model, q)
    parts = [sim.probe_clearance_plain(plain, qs[r:r + 440], *(a[r:r + 440] for a in args[:6]), *args[6:])
             for r in range(0, B, 440)]
    want_clear, want_count = (torch.cat(p) for p in zip(*parts))
    assert 0.01 < (want_clear < 0).float().mean() < 0.99
    torch.testing.assert_close(clear, want_clear, rtol=0, atol=1e-5)
    floor = sim._floor_from_depths(qs, s, g, depth_s, depth_g, 0.5, 5e-3)
    near = visited & ((want_clear - floor).abs() <= 1e-5)
    far = sim._segment_count(seg_idx, visited & (want_clear < floor) & ~near, T)
    assert ((far <= count) & (count <= far + sim._segment_count(seg_idx, near, T))).all()
    assert want_count.sum() > 0


@pytest.mark.cuda
def test_ur10_round_launches_the_six_joint_builds_on_card(cuda_device):
    """A 3-step round of the ``ur10-bookshelves`` session (``make_round_solver``:
    the steps, the extraction, the metric) on the problemset's 55 queries:
    K1 and both K3 entries launched for 6 joints and standard DH, none for 7
    joints, and no plain K1, K3 or K6 on the card."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.session import PlanningSession

    sess = PlanningSession("ur10", "bookshelves", dtype=torch.float32, sdf_mode="packed", use_tuned=True,
                           device=cuda_device)
    starts, goals = sess.queries()
    arm = (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance)
    plain = (col.k1_loglik, col.k3_min_clearance, rff.k6_rff)
    for f in arm:
        f.launches_by_arm = {}
    for f in plain:
        f.plain_on_card = 0
    cfg = dataclasses.replace(sess.train_config, num_steps=3)
    params = solver.init_slots(sess.model, starts, goals, sess.planner_params, ["linear"] * len(starts))
    best, _ = solver.make_round_solver(sess.model, cfg)(params, starts, goals,
                                                        torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(best).all()
    assert col.k1_loglik.launches_by_arm.keys() == {(6, False)} and col.k1_loglik.launches_by_arm[(6, False)] >= 4
    for f in arm[1:]:
        assert f.launches_by_arm.keys() == {(6, False)}, f.__name__
    assert [f.plain_on_card for f in plain] == [0, 0, 0]
