#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vgpmp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero before the result line:

(a) build the CUDA kernels from ``vgpmp_torch/csrc`` as one PyTorch
    extension (ninja runs one compiler per source, in parallel) and print
    the build seconds;
(b) hold every kernel against its plain PyTorch version on the card at the
    main path's shapes (franka/industrial: the real packed table and franka
    FK for K1; [252, 12, 12] Grams for K2's factorisation, solves and fused
    pair ([252, 12, 71] right-hand sides in a training step, [252, 12, 251]
    in the extraction); 36 x 6400 PD-path probes against
    the real float32 grid for K3, and for its fused entry (the floor compare
    and the per-segment count) the same paths plus a row without motion, a
    NaN row and two random rows; the gather benchmark's tables for K4, and
    K4 at one point as the timer's floor), forward and backward where there
    is one, and time kernel, plain version, library call and the bound;
(c) the main path: ``PlanningSession("franka", "industrial")``, 36 queries,
    the full 200-step batched Adam solve with linear init and again with
    zeros init, then posterior extraction (150 samples x 100 times); a
    20-step solve with jitter escalation on, the path that keeps the lone
    factorisation and solves, held against the fused path; plus a
    small-input ELBO check against the CPU's plain path;
(d) a ``torch.profiler`` window over a 20-step solve: device busy share,
    kernels by device time, host time per solver span, device launches and
    K2 launches per Adam step; and a second window over one
    ``execute_and_validate`` of the round's best trajectories: device busy
    ms, device launches, K3's device ms (run last, after (f));
(e) the scored round: ``make_round_solver`` on the 36 queries at 200 steps
    (solve, best sample, then ``execute_and_validate`` of every row: two K3
    launches, the fused probe entry and the endpoints), with the verdicts
    held against the port's CPU plain path on the same trajectories;
(f) the gather benchmark ``tools/gather_bench_torch.py`` (K4).

Prints the card's name and power limit, a ``kernels`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``. A detailed record goes to
``chiprun_out/chip_smoke.json``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 and
# float64 rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_phase(torch, sess, flush):
    """K1 against ``log_prob_plain``, which on the card is plain PyTorch end to
    end (FK, ``packed_lookup_plain``'s gather and unpack, the hinge)."""
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.sdf.grid import _packed_flat_index
    from vgpmp_torch.timing import time_ms

    model = sess.model.collision
    dev = sess.device
    starts, goals = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in sess.queries())
    B, S, N, L = starts.shape[0], 20, 50, starts.shape[1]
    gen = torch.Generator(device=dev).manual_seed(11)
    frac = torch.linspace(0, 1, N, device=dev)[None, None, :, None]
    q = starts[:, None, None] + (goals - starts)[:, None, None] * frac
    q = q + 0.15 * torch.randn((B, S, N, L), generator=gen, device=dev)
    # half the samples uniform over the joint box, so that many spheres sit
    # inside obstacles and the hinge and its gradient are exercised
    lo, hi = sess.model.limits_low, sess.model.limits_high
    q[:, S // 2:] = lo + (hi - lo) * torch.rand((B, S - S // 2, N, L), generator=gen, device=dev)
    q = torch.minimum(torch.maximum(q, lo), hi).contiguous()
    sigma = torch.full((B, model.fk.sphere_radii.shape[0]), 0.005, device=dev)

    qk = q.clone().requires_grad_()
    lik_k = model.log_prob(qk, sigma)
    (gk,) = torch.autograd.grad(lik_k.sum(), qk)
    qp = q.clone().requires_grad_()
    lik_p = col.log_prob_plain(model, qp, sigma)
    (gp,) = torch.autograd.grad(lik_p.sum(), qp)
    torch.cuda.synchronize()
    # tolerance: K1's FK may fuse multiply-adds and sum in another order, so
    # a sphere near a voxel face may land in the neighbouring voxel: at most
    # 1e-3 of the configs may differ; the rest agree to 1e-5 relative (+1e-3
    # absolute: 37-term float32 sums in another order), their gradients to
    # 1e-3 of the largest
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    share = (~close).float().mean().item()
    err = (lik_k - lik_p)[close].abs().max().item()
    gscale = gp.abs().max().item()
    gerr = (gk - gp)[close].abs().max().item()
    active = (lik_p < 0).float().mean().item()
    log(f"K1 check: {B * S * N} configs, hinge active in {active:.4f} (>= 0.2), other-voxel share "
        f"{share:.2e} (<= 1e-3), max |dlik| {err:.3e}, max |d grad| {gerr:.3e} of {gscale:.3e}")
    assert active >= 0.2, "K1 check: too few configs touch an obstacle to test the hinge"
    assert share <= 1e-3, "K1: too many configs disagree with the plain version"
    assert gerr <= 1e-3 * gscale + 1e-6, "K1: gradient disagrees with the plain version"

    q2 = q.reshape(-1, L)
    # 100 calls each: at 20 a single slow call moves the mean by a tenth
    ms = time_ms(lambda: col.k1_loglik(model, q2, sigma, True), reps=100, flush=flush)
    ms_fwd = time_ms(lambda: col.k1_loglik(model, q2, sigma, False), reps=100, flush=flush)

    def plain():
        qq = q.clone().requires_grad_()
        torch.autograd.grad(col.log_prob_plain(model, qq, sigma).sum(), qq)

    plain_ms = time_ms(plain, reps=5, flush=flush)
    with torch.no_grad():
        flat = _packed_flat_index(model.scene.base_packed,
                                  sphere_positions(model.fk, q) - model.scene.base_offset)
        sectors = torch.unique(flat.reshape(-1) // 4).numel()  # 32-byte sectors of 8-byte entries
    T, P = q2.shape[0], sigma.shape[1]
    nbytes = sectors * 32 + T * L * 4 + sigma.numel() * 4 + T * 4 + T * L * 4
    # per config: 7 DH compositions (~60 flops), per sphere position, index,
    # hinge (~30) and the 7-joint torque accumulation (~16 each)
    flops = T * (L * 60 + P * (30 + L * 16))
    b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS)
    log(f"K1 time: fwd+grad {ms:.4f} ms, fwd only {ms_fwd:.4f} ms, plain fwd+bwd {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {sectors} sectors = {sectors * 32 / 1e6:.1f} MB)")
    return {"name": "k1_collision_loglik", "route": "cuda", "source": "vgpmp_torch/csrc/k1_collision.cu",
            "replaces": "vgpmp_tpu/likelihoods/collision.py:76", "max_abs_err": err,
            "max_rel_err": err / lik_p.abs().max().item(), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "other_voxel_share": share, "hinge_active_share": active, "max_grad_err": gerr,
            "grad_scale": gscale, "ms_forward_only": ms_fwd, "sectors": sectors}


def k2_phase(torch, sess, flush):
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.timing import time_ms

    dev = sess.device
    starts, goals = sess.queries()
    pp = sess.planner_params
    params = planner.init_params_batch(sess.model, starts, goals, [0] * len(starts),
                                       0.5 * (starts + goals), pp["lengthscales"], pp["variance"],
                                       pp["sigma_obs"], pp["alpha"])
    c = planner.constrain(params, sess.model.variance_lower)
    with torch.no_grad():
        Kuu, _ = planner._gram(sess.model, c)
    real = Kuu.reshape(-1, *Kuu.shape[-2:]).contiguous()          # [252, 12, 12] real Grams
    T, n = real.shape[0], real.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(5)
    G = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64)
    rand = G @ G.mT + n * torch.eye(n, device=dev, dtype=torch.float64)  # well conditioned
    for K in (real, rand):
        K[-1] = -K[-1]  # one non-SPD matrix: NaN on both sides
    ok = torch.ones(T, dtype=torch.bool, device=dev)
    ok[-1] = False

    def errs(a, b):  # (max absolute, max absolute / largest reference entry)
        e = (a - b).abs().max().item()
        return e, e / b.abs().max().item()

    worst, worst_abs = {}, {}
    # tolerances (float64): the real Grams have condition numbers up to ~1e9,
    # so two summation orders differ by up to ~1e-7 of the largest entry —
    # held to 1e-6; the well-conditioned set is held to 1e-9, backward too
    for name, K, tol in (("real", real, 1e-6), ("random", rand, 1e-9)):
        Lk, Lp = la.chol(K), la.cholesky_unrolled(K)
        assert torch.isnan(Lk[-1]).any() and torch.isnan(Lp[-1]).any(), "K2: NaN-in, NaN-out"
        a, e = errs(Lk[ok], Lp[ok])
        worst[f"chol_{name}"], worst_abs[f"chol_{name}"] = e, a
        assert e <= tol, f"K2 chol {name}: {e}"
        for k in (1, 20, 50, 100):
            Bm = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64)
            for up in (False, True):
                fk = la.solve_upper_T if up else la.solve_lower
                fp = la.solve_upper_T_unrolled if up else la.solve_lower_unrolled
                Kt, Bt = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
                Kq, Bq = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
                W = torch.randn((int(ok.sum()), n, k), generator=gen, device=dev, dtype=torch.float64)
                xk = fk(la.chol(Kt), Bt)
                xp = fp(la.cholesky_unrolled(Kq), Bq)
                gk = torch.autograd.grad((W * xk).sum(), [Kt, Bt])
                gp = torch.autograd.grad((W * xp).sum(), [Kq, Bq])
                pairs = [(xk, xp), *zip(gk, gp)] if name == "random" else [(xk, xp)]
                a, e = (max(v) for v in zip(*(errs(u, w) for u, w in pairs)))
                key = f"trsm_{name}_k{k}_{'upperT' if up else 'lower'}"
                worst[key], worst_abs[key] = e, a
                assert e <= tol, f"K2 trsm {name} k={k} upper_t={up}: {e}"
                xn = fk(la.chol(K), Bm)
                assert torch.isnan(xn[-1]).any(), "K2 trsm: NaN-in, NaN-out"
        # the fused pair on the same matrices: forward on both sets, and
        # through autograd (the fused backward launch) on the random set; 251
        # columns is the extraction's call, which runs without a backward
        for k in (1, 20, 71, 100, 251):
            Bm = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64)
            Ln, Xn = la.factor_solve(K, Bm)
            Lq, Xq = la.factor_solve_plain(K, Bm)
            assert all(torch.isnan(v[-1]).any() for v in (Ln, Xn, Lq, Xq)), "K2 fused: NaN-in, NaN-out"
            pairs = [(Ln[ok], Lq[ok]), (Xn[ok], Xq[ok])]
            if name == "random" and k != 251:
                WL = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64)
                WX = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64)
                Kt, Bt = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
                Kq, Bq = K[ok].clone().requires_grad_(), Bm[ok].clone().requires_grad_()
                Lf, Xf = la.factor_solve(Kt, Bt)
                Lg, Xg = la.factor_solve_plain(Kq, Bq)
                gk = torch.autograd.grad((WL[ok] * Lf).sum() + (WX[ok] * Xf).sum(), [Kt, Bt])
                gp = torch.autograd.grad((WL[ok] * Lg).sum() + (WX[ok] * Xg).sum(), [Kq, Bq])
                hp = la.factor_solve_bwd_plain(Lq[ok], Xq[ok], WL[ok], WX[ok])  # the closed formula
                pairs += [*zip(gk, gp), *zip(gk, hp)]
                gn = la.k2_factor_solve_bwd(Ln, Xn, WL, WX)
                assert all(torch.isnan(v[-1]).any() for v in gn), "K2 fused backward: NaN-in, NaN-out"
            a, e = (max(v) for v in zip(*(errs(u, w) for u, w in pairs)))
            key = f"fused_{name}_k{k}"
            worst[key], worst_abs[key] = e, a
            assert e <= tol, f"K2 fused pair {name} k={k}: {e}"
    log("K2 check (relative / absolute): "
        + ", ".join(f"{k} {v:.2e} / {worst_abs[k]:.2e}" for k, v in worst.items()))

    Kc = rand[ok].contiguous()
    L = la.k2_chol(Kc)
    chol = {"ms": time_ms(lambda: la.k2_chol(Kc), flush=flush),
            "plain_ms": time_ms(lambda: la.cholesky_unrolled(Kc), flush=flush),
            "library_ms": time_ms(lambda: torch.linalg.cholesky(Kc), flush=flush)}
    Tm = Kc.shape[0]
    chol["bound_ms"], chol["bound_by"] = bound_ms(2 * Tm * n * n * 8, Tm * n ** 3 / 3, F64_FLOPS)
    trsm = {}
    for k in (1, 20, 50, 100, 150):
        Bm = torch.randn((Tm, n, k), generator=gen, device=dev, dtype=torch.float64)
        b_ms, b_by = bound_ms((Tm * n * n + 2 * Tm * n * k) * 8, Tm * n * n * k, F64_FLOPS)
        trsm[k] = {"ms": time_ms(lambda: la.k2_trsm(L, Bm, False), flush=flush),
                   "plain_ms": time_ms(lambda: la.solve_lower_unrolled(L, Bm), flush=flush),
                   "library_ms": time_ms(lambda: torch.linalg.solve_triangular(L, Bm, upper=False),
                                         flush=flush),
                   "bound_ms": b_ms, "bound_by": b_by}
    # the fused pair at the main path's widths. A training step: the draw's 20
    # columns, the time grid's 50 and the variational mean's one. The
    # extraction (forward only): 150 draws, 100 times and the mean. The library
    # time is the two PyTorch calls that compute the forward (a yardstick
    # only; the backward has no such call)
    def library_pair(Bm):
        Ll = torch.linalg.cholesky(Kc)
        return Ll, torch.linalg.solve_triangular(Ll, Bm, upper=False)

    fused_by_k = {}
    for k in (71, 251):
        Bm = torch.randn((Tm, n, k), generator=gen, device=dev, dtype=torch.float64)
        b_ms, b_by = bound_ms((2 * Tm * n * n + 2 * Tm * n * k) * 8, Tm * (n ** 3 / 3 + n * n * k),
                              F64_FLOPS)
        fused_by_k[k] = {"ms": time_ms(lambda: la.k2_factor_solve(Kc, Bm), flush=flush),
                         "plain_ms": time_ms(lambda: la.factor_solve_plain(Kc, Bm), flush=flush),
                         "library_ms": time_ms(lambda: library_pair(Bm), flush=flush),
                         "separate_ms": time_ms(lambda: la.k2_trsm(la.k2_chol(Kc), Bm, False),
                                                flush=flush),
                         "bound_ms": b_ms, "bound_by": b_by}
    kf = 71
    fused = fused_by_k[kf]
    Bm = torch.randn((Tm, n, kf), generator=gen, device=dev, dtype=torch.float64)
    gL = torch.randn((Tm, n, n), generator=gen, device=dev, dtype=torch.float64)
    gX = torch.randn((Tm, n, kf), generator=gen, device=dev, dtype=torch.float64)
    Lf, Xf = la.k2_factor_solve(Kc, Bm)
    fused_bwd = {"ms": time_ms(lambda: la.k2_factor_solve_bwd(Lf, Xf, gL, gX), flush=flush),
                 "plain_ms": time_ms(lambda: la.factor_solve_bwd_plain(Lf, Xf, gL, gX), flush=flush),
                 "library_ms": None}
    # one substitution of k columns, the lower half of dB X^T, L^T G and two
    # substitutions of n columns
    fused_bwd["bound_ms"], fused_bwd["bound_by"] = bound_ms(
        (3 * Tm * n * n + 3 * Tm * n * kf) * 8, Tm * (2 * n * n * kf + 7 * n ** 3 / 3), F64_FLOPS)
    log(f"K2 chol [{Tm},{n},{n}]: " + json.dumps(chol))
    for k, v in trsm.items():
        log(f"K2 trsm lower [{Tm},{n},{k}]: " + json.dumps(v))
    for k, v in fused_by_k.items():
        log(f"K2 fused forward [{Tm},{n},{n}] + [{Tm},{n},{k}]: " + json.dumps(v))
    log(f"K2 fused backward, same shapes: " + json.dumps(fused_bwd))

    def worst_of(prefix):
        return {"max_abs_err": max(v for k, v in worst_abs.items() if k.startswith(prefix)),
                "max_rel_err": max(v for k, v in worst.items() if k.startswith(prefix))}

    return [
        {"name": "k2_chol", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cu",
         "replaces": "vgpmp_tpu/ops/linalg.py:30", **worst_of("chol"), **chol,
         "shape": [Tm, n, n]},
        {"name": "k2_trsm", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cu",
         "replaces": "vgpmp_tpu/ops/linalg.py:52", **worst_of("trsm"), **trsm[50],
         "shape": [Tm, n, 50], "by_k": trsm},
        {"name": "k2_factor_solve", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cu",
         "replaces": "vgpmp_tpu/ops/linalg.py:30", **worst_of("fused"), **fused,
         "shape": [Tm, n, kf], "by_k": fused_by_k},
        # the backward launch is held through autograd in the same checks
        {"name": "k2_factor_solve_bwd", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cu",
         "replaces": "vgpmp_tpu/ops/linalg.py:30", **worst_of("fused_random"), **fused_bwd,
         "shape": [Tm, n, kf]},
    ], {"relative": worst, "absolute": worst_abs}


def k3_bound(torch, model, q, extra_bytes: float, extra_flops: float):
    """K3's bound at the configs ``q [n, L]``: the distinct 32-byte sectors (8
    float32 cells) of the grid that the eight corners of every config's
    spheres touch, plus q (read) and the minima (written) and ``extra_bytes``;
    per config 7 DH compositions (~60 flops), per sphere its position (18),
    the relative position and clamps (~20) and seven lerps (3 flops each),
    plus ``extra_flops``. Returns (ms, "bytes" or "operations", sectors)."""
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.sdf.grid import _flat, trilinear_cell

    grid = model.scene.base
    _, ny, nz = grid.shape
    with torch.no_grad():
        i0, _ = trilinear_cell(grid, sphere_positions(model.fk, q) - model.scene.base_offset)
        flat = _flat(grid.shape, i0).reshape(-1)
        corners = [dx * ny * nz + dy * nz + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
        sectors = torch.unique(torch.cat([torch.unique((flat + c) // 8) for c in corners])).numel()
    n, L = q.shape
    P = model.fk.sphere_radii.shape[0]
    nbytes = sectors * 32 + n * L * 4 + n * 4 + extra_bytes
    flops = n * (L * 60 + P * 60) + extra_flops
    return (*bound_ms(nbytes, flops, F32_FLOPS), sectors)


def k3_phase(torch, sess, flush):
    """K3 against ``min_clearance_eval_plain`` on the real float32 grid: the
    main path's 36 x 6400 PD-path probes (perturbed straight lines between the
    queries), plus as many configs uniform over the joint box so that many
    spheres sit inside obstacles or outside the grid. Then K3's fused entry
    ``k3_probe_clearance`` against ``probe_clearance_plain`` on the probes of
    the same paths plus a row without motion, a NaN row and two rows of
    random waypoints (which surely collide)."""
    from functools import partial

    from vgpmp_torch import sim
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.timing import time_ms

    model = sess.model.collision
    dev = sess.device
    starts, goals = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in sess.queries())
    B, T, L = starts.shape[0], sess.train_config.time_spacing_Xnew, starts.shape[1]
    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.linspace(0, 1, T, device=dev)[None, :, None]
    traj = starts[:, None] + (goals - starts)[:, None] * w
    traj = traj + 0.3 * torch.sin(torch.pi * w) * torch.randn((B, 1, L), generator=gen, device=dev)
    lo, hi = sess.model.limits_low, sess.model.limits_high
    traj = torch.minimum(torch.maximum(traj, lo), hi)
    q_path = sim.pd_path_configs(traj)[0].reshape(-1, L).contiguous()    # [36 * 6400, 7]
    q_box = lo + (hi - lo) * torch.rand(q_path.shape, generator=gen, device=dev)
    q = torch.cat([q_path, q_box])

    got = model.min_clearance_eval(q)
    want = col.min_clearance_eval_plain(model, q)
    torch.cuda.synchronize()
    # tolerance: trilinear interpolation is continuous, so a sphere centre
    # that differs by a few float32 ulps moves the value by as little; K3
    # differs from the plain version by fused multiply-adds only: 1e-5 m
    err = (got - want).abs().max().item()
    negative = (want < 0).float().mean().item()
    log(f"K3 check: {q.shape[0]} configs ({q_path.shape[0]} PD-path probes + {q_box.shape[0]} uniform), "
        f"max |d clearance| {err:.3e} m (<= 1e-5), negative clearance in {negative:.4f} (>= 0.1), "
        f"range [{want.min().item():.4f}, {want.max().item():.4f}] m")
    assert torch.isfinite(got).all(), "K3: non-finite clearance"
    assert err <= 1e-5, "K3 disagrees with the plain version"
    assert negative >= 0.1, "K3 check: too few configs touch an obstacle"
    nan_q = q_path[:64].clone()
    nan_q[::2, 3] = float("nan")
    nan_out = col.k3_min_clearance(model, nan_q)
    assert torch.isnan(nan_out[::2]).all() and torch.isfinite(nan_out[1::2]).all(), "K3: NaN in, NaN out"

    ms = time_ms(lambda: col.k3_min_clearance(model, q_path), flush=flush)
    plain_ms = time_ms(lambda: col.min_clearance_eval_plain(model, q_path), reps=5, flush=flush)
    b_ms, b_by, sectors = k3_bound(torch, model, q_path, 0, 0)
    log(f"K3 time at {q_path.shape[0]} configs: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {sectors} sectors = {sectors * 32 / 1e6:.1f} MB)")
    k3 = {"name": "k3_min_clearance", "route": "cuda", "source": "vgpmp_torch/csrc/k3_clearance.cu",
          "replaces": "vgpmp_tpu/likelihoods/collision.py:59", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "negative_share": negative, "sectors": sectors, "configs_checked": q.shape[0],
          "configs_timed": q_path.shape[0]}

    # the fused entry on the round's shape: the 36 paths, a row without
    # motion, a row that turns NaN half way, and two rows of random waypoints
    rows = [traj, traj[:1, :1].expand(1, T, L), traj[1:2].clone(),
            lo + (hi - lo) * torch.rand((2, T, L), generator=gen, device=dev)]
    rows[2][0, T // 2:] = float("nan")
    traj2 = torch.cat(rows)
    B2 = traj2.shape[0]
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj2)
    q_s = torch.cat([starts, traj2[B:, 0]])
    q_g = torch.cat([goals, traj2[B:B + 1, -1], goals[1:2], traj2[B + 2:, -1]])
    plain = partial(col.min_clearance_eval_plain, model)
    depth_s, depth_g = torch.clamp(-plain(torch.cat([q_s, q_g])), min=0.0).split(B2)
    radius, slack = 0.5, 5e-3
    args = (q_s, q_g, depth_s, depth_g, visited[:, 0], seg_idx, T, radius, slack)
    clear_k, count_k = col.k3_probe_clearance(model, qs, *args)
    clear_p, count_p = sim.probe_clearance_plain(plain, qs, *args)
    floor = sim._floor_from_depths(qs, q_s, q_g, depth_s, depth_g, radius, slack)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(clear_k), torch.isnan(clear_p)
    ok = ~nan_p
    perr = (clear_k[ok] - clear_p[ok]).abs().max().item()
    # a probe within 1e-5 m of its floor may fall either way (K3's clearance
    # is held to 1e-5 m); every other probe must count as the plain version
    # counts it, so per segment far <= count <= far + near
    near = visited & ((clear_p - floor).abs() <= 1e-5)
    far = sim._segment_count(seg_idx, visited & (clear_p < floor) & ~near, T)
    near_n = sim._segment_count(seg_idx, near, T)
    differ = (count_k > 0) != (count_p > 0)
    responsible = int(near_n[differ].sum())
    log(f"K3 probe entry check: {qs.shape[0]} rows x {qs.shape[1]} probes, max |d clearance| {perr:.3e} m "
        f"(<= 1e-5), NaN probes {int(nan_p.sum())} on both sides: {bool(torch.equal(nan_k, nan_p))}; "
        f"violated probes {int(count_p.sum())} (plain) / {int(count_k.sum())} (kernel) in "
        f"{int((count_p > 0).sum())} / {int((count_k > 0).sum())} segments; segment flags differ in "
        f"{int(differ.sum())}, explained by {responsible} probes within 1e-5 m of their floor")
    assert torch.equal(nan_k, nan_p) and nan_p[B + 1].any() and not nan_p[:B].any(), "K3 probe: NaN in, NaN out"
    assert perr <= 1e-5, "K3 probe entry: clearance disagrees with the plain version"
    assert ((far <= count_k) & (count_k <= far + near_n)).all(), "K3 probe entry: counts disagree"
    assert bool((near_n[differ] > 0).all()), "K3 probe entry: a flag differs with no probe at its floor"
    assert count_p.sum() > 0 and count_k[B].sum() == 0 and not visited[B].any(), "K3 probe check: cases"

    pms = time_ms(lambda: col.k3_probe_clearance(model, qs, *args), flush=flush)
    pplain_ms = time_ms(lambda: sim.probe_clearance_plain(plain, qs, *args), reps=5, flush=flush)
    n = qs.shape[0] * qs.shape[1]
    # beyond K3's bytes: the segment index (8 B) a probe read, the per-row
    # inputs read, the counts written; about 20 operations a probe for the
    # distances, the ramps and the compare
    pb_ms, pb_by, psectors = k3_bound(torch, model, qs.reshape(-1, L), n * 8 + B2 * (2 * L + 3) * 4
                                      + B2 * T * 4, n * 20)
    log(f"K3 probe entry time at {n} probes: kernel {pms:.4f} ms, plain {pplain_ms:.4f} ms, "
        f"bound {pb_ms:.4f} ms ({pb_by}: {psectors} sectors)")
    k3p = {"name": "k3_probe_clearance", "route": "cuda", "source": "vgpmp_torch/csrc/k3_clearance.cu",
           "replaces": "vgpmp_tpu/engine/validator.py:211", "max_abs_err": perr, "ms": pms,
           "plain_ms": pplain_ms, "bound_ms": pb_ms, "bound_by": pb_by, "library_ms": None,
           "sectors": psectors, "probes": n, "violated_plain": int(count_p.sum()),
           "violated_kernel": int(count_k.sum()), "segment_flags_differ": int(differ.sum()),
           "probes_at_floor_responsible": responsible}
    return k3, k3p


def k4_phase(torch, sess, flush):
    """K4 against the plain indexing (exact) and ``torch.index_select``, both
    entry widths at the gather benchmark's three table sizes."""
    import gather_bench_torch as gb

    cases = []
    for entry_bytes in (4, 8):
        for ncells in gb.TABLE_CELLS:
            c = gb.gather_case(ncells, entry_bytes, gb.NPTS, sess.device, flush)
            c["bound_ms"], c["bound_by"] = bound_ms(
                c["npts"] * (4 + entry_bytes) + c["sectors_touched"] * 32, 0.0, F32_FLOPS)
            cases.append(c)
            log(f"K4 {entry_bytes}-byte entries, {ncells} cells ({c['table_mb']:.1f} MB), {c['npts']} points: "
                f"equal {c['equal']}, kernel {c['k4_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                f"index_select {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                f"({c['sectors_touched']} sectors)")
    # the timer's floor: K4 gathering one point, timed as every row is timed
    # (a launch between two events after an L2 flush)
    from vgpmp_torch.ops.gather import k4_gather
    from vgpmp_torch.timing import time_ms

    table = torch.arange(1024, dtype=torch.int32, device=sess.device)
    one = torch.zeros(1, dtype=torch.int32, device=sess.device)
    floor_ms = time_ms(lambda: k4_gather(table, one), reps=100, flush=flush)
    log(f"timer floor: K4 at one point, {floor_ms:.4f} ms (a launch between two events, L2 flushed)")
    log("K4 no slower than index_select in all six cases: "
        f"{all(c['k4_ms'] <= c['library_ms'] for c in cases)}")
    # the row of the kernels line: what the Pallas kernel gathers (4-byte
    # entries) at its larger table; the other cases are in the record
    head = next(c for c in cases if c["entry_bytes"] == 4 and c["ncells"] == 1_048_576)
    return {"name": "k4_gather", "route": "cuda", "source": "vgpmp_torch/csrc/k4_gather.cu",
            "replaces": "tools/gather_bench.py:100", "max_abs_err": 0.0, "ms": head["k4_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": [head["ncells"], head["npts"]], "cases": cases,
            "timer_floor_ms": floor_ms}


def small_input_check(torch, sess, cpu):
    """ELBO and its gradient on the card (K1, K2) against the plain path of the
    CPU session ``cpu`` on the same model, params and draws: 4 problems, S=4, N=16.
    Tolerance 1e-3 relative: float32 bulk tensors on both, summed in other
    orders, and a rare sphere in a neighbouring voxel."""
    from vgpmp_torch.gp.pathwise import draw_noise
    from vgpmp_torch.models import vgpmp as planner

    starts, goals = (x[:4] for x in sess.queries())
    pp = sess.planner_params
    out = []
    for s in (sess, cpu):
        m = dataclasses.replace(s.model, num_samples=4)
        params = planner.init_params_batch(m, starts, goals, [0, 1, 2, 0], 0.5 * (starts + goals),
                                           pp["lengthscales"], pp["variance"], pp["sigma_obs"],
                                           pp["alpha"])
        for k in ("q_mu", "q_sqrt", "lengthscales_u", "variance_u"):
            getattr(params, k).requires_grad_(True)
        noise = draw_noise((4,), 7, m.num_inducing + 2, 4, m.num_bases, torch.float32, "cpu",
                           torch.Generator().manual_seed(3))
        noise = type(noise)(*(x.to(s.device) for x in noise))
        X = torch.linspace(0, 1, 16, device=s.device)
        val = planner.elbo(params, m, torch.as_tensor(starts, dtype=torch.float32, device=s.device),
                           torch.as_tensor(goals, dtype=torch.float32, device=s.device), X, noise=noise)
        grads = torch.autograd.grad(val.sum(), [params.q_mu, params.lengthscales_u])
        out.append([val.detach().cpu()] + [g.cpu() for g in grads])
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*out)]
    log(f"small-input ELBO check (card vs CPU plain path): rel errors {errs}")
    assert all(torch.isfinite(x).all() for x in out[0]), "non-finite ELBO on the card"
    assert max(errs) <= 1e-3, f"ELBO on the card disagrees with the CPU plain path: {errs}"
    return errs


def main_path(torch, sess):
    from vgpmp_torch.engine import solver
    from vgpmp_torch.likelihoods.collision import k1_loglik
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la

    starts, goals = sess.queries()
    pp, cfg = sess.planner_params, sess.train_config
    solve = solver.make_batch_solver(sess.model, cfg)
    B = len(starts)
    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mode_name, mode in (("linear", 0), ("zeros", 1)):
        params = planner.init_params_batch(sess.model, starts, goals, [mode] * B,
                                           0.5 * (starts + goals), pp["lengthscales"],
                                           pp["variance"], pp["sigma_obs"], pp["alpha"])
        gen = torch.Generator(device=sess.device).manual_seed(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained, res = solve(params, starts, goals, gen)
        torch.cuda.synchronize()
        runs[mode_name] = (time.perf_counter() - t0, trained, res)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    # extraction alone, timed after the counted run
    _, trained, _ = runs["linear"]
    Xnew = torch.linspace(0, 1, cfg.time_spacing_Xnew, device=sess.device)
    st = torch.as_tensor(starts, dtype=torch.float32, device=sess.device)
    gl = torch.as_tensor(goals, dtype=torch.float32, device=sess.device)
    ext = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            planner.sample_from_posterior(trained, sess.model, st, gl, Xnew, cfg.num_posterior_samples,
                                          torch.Generator(device=sess.device).manual_seed(9))
        torch.cuda.synchronize()
        ext.append(time.perf_counter() - t0)
    t_ext = min(ext)

    summary = {}
    for mode_name, (t_solve, _, res) in runs.items():
        e = res.elbo_history
        first, last = e[:, 0].mean().item(), e[:, -1].mean().item()
        ok_rows = int((torch.isfinite(e).all(dim=1) & torch.isfinite(res.best).flatten(1).all(dim=1)).sum())
        summary[mode_name] = {
            "solve_s": t_solve, "ms_per_adam_step": (t_solve - t_ext) * 1e3 / cfg.num_steps,
            "elbo_first_mean": first, "elbo_last_mean": last, "finite_rows": ok_rows,
            "failed_rows": int(res.failed.sum()), "best_shape": list(res.best.shape)}
        log(f"main path ({mode_name} init): B={B} steps={cfg.num_steps} solve {t_solve:.3f} s, "
            f"{summary[mode_name]['ms_per_adam_step']:.3f} ms/step, ELBO mean {first:.4g} -> {last:.4g}, "
            f"finite rows {ok_rows}/{B}")
        assert ok_rows == B, f"{mode_name}: non-finite ELBO or trajectory"
        assert last > first, f"{mode_name}: ELBO did not rise"
        assert list(res.best.shape) == [B, cfg.time_spacing_Xnew, 7]
    log(f"extraction ({cfg.num_posterior_samples} samples x {cfg.time_spacing_Xnew} times, B={B}): "
        f"{t_ext:.4f} s; peak memory {peak / 2**20:.1f} MiB; launches {launches}")
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"
    return summary, launches, t_ext, peak


def escalation_phase(torch, sess, steps: int = 20):
    """The solve with jitter escalation on (``jitter_escalations=1``): the
    factor may be replaced per row after the first attempt, so this path keeps
    the lone factorisation (``k2_chol``) and solves (``k2_trsm``). Every Gram
    of the main path is SPD, so nothing escalates and the first ELBO must be
    the fused path's on the same draws. Tolerance 1e-3 relative: the two
    paths round the float64 island differently, and in float32 a last-bit
    change can move a sphere into the neighbouring voxel."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la

    starts, goals = sess.queries()
    pp = sess.planner_params
    cfg = dataclasses.replace(sess.train_config, num_steps=steps)
    params = planner.init_params_batch(sess.model, starts, goals, [0] * len(starts),
                                       0.5 * (starts + goals), pp["lengthscales"], pp["variance"],
                                       pp["sigma_obs"], pp["alpha"])
    counters = (la.k2_chol, la.k2_trsm, la.k2_factor_solve)
    first, launches = {}, {}
    for name, esc in (("fused", 0), ("escalating", 1)):
        solve = solver.make_batch_solver(dataclasses.replace(sess.model, jitter_escalations=esc), cfg)
        for c in counters:
            c.launches = 0
        _, res = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(2))
        torch.cuda.synchronize()
        launches[name] = {c.__name__: c.launches for c in counters}
        first[name] = res.elbo_history[:, 0]
        assert torch.isfinite(res.elbo_history).all() and torch.isfinite(res.best).all(), name
    err = ((first["escalating"] - first["fused"]).abs() / first["fused"].abs()).max().item()
    log(f"escalation path, {steps} steps: launches {launches['escalating']} (fused path: "
        f"{launches['fused']}), first ELBO differs from the fused path's by {err:.2e} relative (<= 1e-3)")
    assert err <= 1e-3, "the escalation path disagrees with the fused path"
    assert launches["escalating"]["k2_factor_solve"] == 0 and launches["fused"]["k2_chol"] == 0
    return {"launches": launches["escalating"], "first_elbo_rel_err": err}


def profile_phase(torch, sess, steps: int = 20):
    """Where a step's time goes: ``torch.profiler`` over a ``steps``-step solve
    of the main path (B=36) after a warm-up solve; the same solve is also
    timed without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la

    starts, goals = sess.queries()
    pp = sess.planner_params
    cfg = dataclasses.replace(sess.train_config, num_steps=steps)
    solve = solver.make_batch_solver(sess.model, cfg)
    params = planner.init_params_batch(sess.model, starts, goals, [0] * len(starts),
                                       0.5 * (starts + goals), pp["lengthscales"], pp["variance"],
                                       pp["sigma_obs"], pp["alpha"])
    k2 = (la.k2_chol, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd)

    def k2_count(fn):
        for c in k2:
            c.launches = 0
        fn()
        return sum(c.launches for c in k2)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(1))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # K2 launches of one Adam step: a solve's, less its one extraction's
    st = torch.as_tensor(starts, dtype=torch.float32, device=sess.device)
    gl = torch.as_tensor(goals, dtype=torch.float32, device=sess.device)
    Xnew = torch.linspace(0, 1, cfg.time_spacing_Xnew, device=sess.device)

    def extract():
        with torch.no_grad():
            planner.sample_from_posterior(params, sess.model, st, gl, Xnew, cfg.num_posterior_samples,
                                          torch.Generator(device=sess.device).manual_seed(9))

    k2_per_step = (k2_count(run) - k2_count(extract)) / steps
    plain_wall = min(run() for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run()
    from torch.autograd import DeviceType

    ev = prof.key_averages()
    # kernel rows only (device-side annotations and the host ops that launch
    # kernels carry the same time again)
    dev = [e for e in ev if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:15]
    spans = {e.key: e.cpu_time_total / 1e3 for e in ev if e.device_type == DeviceType.CPU
             and e.key in ("elbo_forward", "elbo_backward", "adam_update", "extract")}
    launches = sum(e.count for e in dev)
    rec = {"steps": steps, "wall_s_unprofiled": plain_wall, "wall_s_profiled": wall,
           "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / wall,
           "device_busy_share_of_unprofiled_wall": busy_us / 1e6 / plain_wall,
           "device_kernel_launches": launches, "device_launches_per_step": launches / steps,
           "k2_launches_per_step": k2_per_step, "span_cpu_ms": spans,
           "top_kernels": [{"name": e.key[:90], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3} for e in top]}
    log(f"(d) profile of a {steps}-step solve + extraction, B={len(starts)}: wall {plain_wall:.3f} s "
        f"unprofiled, {wall:.3f} s profiled; device busy {busy_us / 1e3:.2f} ms "
        f"({rec['device_busy_share']:.3f} of the profiled wall, "
        f"{rec['device_busy_share_of_unprofiled_wall']:.3f} of the unprofiled), {launches} kernel launches, "
        f"{launches / steps:.1f} per step with the extraction's (about 670 with the factorisation and "
        f"solves as separate launches, on an NVIDIA H100 80GB HBM3); K2 launches per Adam step "
        f"{k2_per_step:g} (13 with separate launches, of them 6 for the KL); spans (host ms) {json.dumps({k: round(v, 1) for k, v in spans.items()})}")
    for t in rec["top_kernels"]:
        log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    assert k2_per_step <= 8, f"K2 launches per Adam step: {k2_per_step}"
    return rec


def round_phase(torch, sess, cpu):
    """(e) the scored round at full width, and its verdicts against the port's
    plain path on the CPU session ``cpu`` (float32 on both)."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la

    starts, goals = sess.queries()
    pp, cfg = sess.planner_params, sess.train_config
    B = len(starts)
    solve = solver.make_round_solver(sess.model, cfg)
    params = planner.init_params_batch(sess.model, starts, goals, [0] * B, 0.5 * (starts + goals),
                                       pp["lengthscales"], pp["variance"], pp["sigma_obs"], pp["alpha"])
    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd, k3_min_clearance,
                k3_probe_clearance)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, rep = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    # again, timed only: the first round also loads the metric's PyTorch
    # kernels (searchsorted, cumsum, scatter_add) for the first time
    t0 = time.perf_counter()
    solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
    torch.cuda.synchronize()
    t_round2 = time.perf_counter() - t0

    m = sess.model
    st = torch.as_tensor(starts, dtype=torch.float32, device=sess.device)
    gl = torch.as_tensor(goals, dtype=torch.float32, device=sess.device)
    t_metric = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            execute_and_validate(m.collision, best, st, gl, m.limits_low, m.limits_high)
        torch.cuda.synchronize()
        t_metric.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    with torch.no_grad():
        ref = execute_and_validate(cpu.model.collision, best.cpu(), st.cpu(), gl.cpu(),
                                   cpu.model.limits_low, cpu.model.limits_high)
    t_cpu = time.perf_counter() - t0

    counts = {k: int(getattr(rep, k).sum()) for k in
              ("executed", "success", "collision_free", "endpoints_ok", "limits_ok")}
    clear = rep.min_clearance.cpu()
    agree = {k: int((getattr(rep, k).cpu() == getattr(ref, k)).sum()) for k in ("executed", "success")}
    clear_err = (clear - ref.min_clearance).abs().max().item()
    log(f"(e) scored round, B={B} steps={cfg.num_steps}: {t_round:.3f} s, again {t_round2:.3f} s; "
        f"execute_and_validate alone "
        f"{min(t_metric):.4f} s (CPU plain path {t_cpu:.2f} s); of {B} rows: " + ", ".join(
            f"{k} {v}" for k, v in counts.items())
        + f"; min_clearance smallest {clear.min().item():.4f} m, median {clear.median().item():.4f} m; "
        f"launches {launches}")
    log(f"    card vs CPU plain path on the same trajectories: executed agrees on {agree['executed']}/{B}, "
        f"success on {agree['success']}/{B}, max |d min_clearance| {clear_err:.3e} m")
    assert list(best.shape) == [B, cfg.time_spacing_Xnew, 7]
    for name, v in rep._asdict().items():
        assert v.shape == (B,) and torch.isfinite(v.float()).all(), f"report field {name}: {v}"
    # the solver clamps the endpoints and the sigmoid keeps the limits
    assert counts["endpoints_ok"] == B and counts["limits_ok"] == B, counts
    assert counts["executed"] >= 1, "no row of the round was executed"
    # float32 on both sides: a row that sits on a threshold (ceil of the step
    # count, a probe at the floor) may fall the other way
    assert min(agree.values()) >= B - 2, f"verdicts disagree with the CPU plain path: {agree}"
    assert clear_err <= 1e-4, f"min_clearance disagrees with the CPU plain path: {clear_err}"
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"
    # K3 per round: the probes with the floor compare fused in, and the [3B]
    # endpoints (start, goal, first waypoint) in one launch
    assert launches["k3_min_clearance"] == 1 and launches["k3_probe_clearance"] == 1, launches
    return best, {"round_s": t_round, "round_again_s": t_round2, "metric_s": min(t_metric), "metric_cpu_plain_s": t_cpu, "counts": counts,
            "min_clearance_smallest": clear.min().item(), "min_clearance_median": clear.median().item(),
            "agree_with_cpu": agree, "min_clearance_max_err_vs_cpu": clear_err, "launches": launches}


def metric_profile_phase(torch, sess, best):
    """A second ``torch.profiler`` window: one ``execute_and_validate`` of the
    round's best trajectories at B = 36 (after the round's own calls warmed
    it): device busy ms, device launches, K3's device ms, the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vgpmp_torch.engine.validator import execute_and_validate

    m = sess.model
    st = torch.as_tensor(sess.queries()[0], dtype=torch.float32, device=sess.device)
    gl = torch.as_tensor(sess.queries()[1], dtype=torch.float32, device=sess.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            execute_and_validate(m.collision, best, st, gl, m.limits_low, m.limits_high)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in dev)
    k3_us = sum(e.self_device_time_total for e in dev if "clearance_tile_kernel" in e.key)
    launches = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    rec = {"wall_s_profiled": wall, "device_busy_ms": busy_us / 1e3, "device_launches": launches,
           "k3_device_ms": k3_us / 1e3,
           "top_kernels": [{"name": e.key[:90], "count": e.count, "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    log(f"(d) profile of one execute_and_validate, B={best.shape[0]}: wall {wall:.4f} s profiled, device busy "
        f"{busy_us / 1e3:.3f} ms, {launches} device launches, K3 {k3_us / 1e3:.4f} ms of device time")
    for t in rec["top_kernels"]:
        log(f"  {t['device_ms']:9.4f} ms  x{t['count']:<6d} {t['name']}")
    assert k3_us > 0, "the metric's profile shows no K3 launch"
    return rec


def gather_phase(torch):
    """(f) the gather benchmark's own entry point, with K4's launches counted."""
    import gather_bench_torch as gb
    from vgpmp_torch.ops.gather import k4_gather

    k4_gather.launches = 0
    t0 = time.perf_counter()
    out = gb.main()
    torch.cuda.synchronize()
    launches = k4_gather.launches
    log(f"(f) gather benchmark: {time.perf_counter() - t0:.2f} s, K4 launches {launches}")
    assert all(c["equal"] for c in out["gathers"]) and len(out["gathers"]) == 6
    assert launches > 0, "K4 was not launched"
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]  # the package, and gather_bench_torch
    try:
        from vgpmp_torch import _build
        from vgpmp_torch.session import PlanningSession
    except ImportError as exc:
        print(f"chip_smoke: the vgpmp_torch package is not beside this script ({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    secs = _build.build()
    log(f"(a) build of {', '.join(_build.SOURCES)} (one extension, ninja in parallel): {secs:.2f} s")

    t0 = time.perf_counter()
    sess = PlanningSession("franka", "industrial")
    log(f"session on {sess.device}: {time.perf_counter() - t0:.2f} s "
        f"(scene {tuple(sess.sdf.data.shape)}, packed table {tuple(sess.scene.base_packed.words.shape)})")
    from vgpmp_torch.timing import l2_flush_buffer

    flush = l2_flush_buffer(sess.device)
    t0 = time.perf_counter()
    cpu = PlanningSession("franka", "industrial", overrides=sess.overrides, device="cpu")
    log(f"the same session on the CPU (float32, plain path), for the cross-checks: "
        f"{time.perf_counter() - t0:.2f} s")

    log("(b) kernels against their plain versions")
    k1 = k1_phase(torch, sess, flush)
    k2, k2_errs = k2_phase(torch, sess, flush)
    k3, k3p = k3_phase(torch, sess, flush)
    k4 = k4_phase(torch, sess, flush)
    small = small_input_check(torch, sess, cpu)
    del flush

    log("(c) main path")
    summary, launches, t_ext, peak = main_path(torch, sess)
    escalating = escalation_phase(torch, sess)

    best, scored = round_phase(torch, sess, cpu)
    gather, k4["launches"] = gather_phase(torch)

    # the profile comes last: once a profiler has traced the process, its
    # kernel launches stay slower, which would inflate the round's seconds
    prof = profile_phase(torch, sess)
    metric_prof = metric_profile_phase(torch, sess, best)

    k1["launches"] = launches["k1_loglik"]
    k2[0]["launches"] = escalating["launches"]["k2_chol"]
    k2[1]["launches"] = launches["k2_trsm"]
    k2[2]["launches"] = launches["k2_factor_solve"]
    k2[3]["launches"] = launches["k2_factor_solve_bwd"]
    k3["launches"] = scored["launches"]["k3_min_clearance"]
    k3p["launches"] = scored["launches"]["k3_probe_clearance"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = [{k: v for k, v in d.items() if k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "max_rel_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")} for d in [k1, *k2, k3, k3p, k4]]
    assert all(k["launches"] > 0 for k in kernels), "a kernel of a driven path was not launched"
    record = {"card": smi, "build_s": secs, "kernels": [k1, *k2, k3, k3p, k4], "k2_errors": k2_errs,
              "escalation_path": escalating,
              "small_input_rel_errors": small, "main_path": summary, "extraction_s": t_ext,
              "peak_memory_bytes": peak, "launches": launches, "profile": prof,
              "metric_profile": metric_prof,
              "scored_round": scored, "gather_bench": gather,
              "total_s": time.perf_counter() - t_start}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['total_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
