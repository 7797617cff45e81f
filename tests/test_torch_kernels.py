"""Kernels K1 to K4 (K3 with both entries) against their plain PyTorch
versions, on the card.

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
from vgpmp_torch.ops import gather as tg
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
def test_k2_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError):
        la.chol(torch.eye(4, device=cuda_device)[None])  # float32
    with pytest.raises(ValueError):
        la.chol(torch.eye(33, dtype=torch.float64, device=cuda_device)[None])  # n > 32
    eye = torch.eye(4, dtype=torch.float64, device=cuda_device)[None]
    with pytest.raises(TypeError):
        la.factor_solve(eye.float(), eye.float())
    with pytest.raises(ValueError):
        la.factor_solve(torch.eye(33, dtype=torch.float64, device=cuda_device)[None],
                        torch.ones(1, 33, 2, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        la.factor_solve(eye, torch.ones(1, 5, 2, dtype=torch.float64, device=cuda_device))


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
    with pytest.raises(TypeError):
        model.min_clearance_eval(torch.zeros(4, spec.dof, dtype=torch.float64, device=cuda_device))
    _, model32 = _collision("franka", torch.float32, cuda_device)
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
