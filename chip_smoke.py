#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vgpmp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero before the result line:

(a) build the CUDA kernels from ``vgpmp_torch/csrc`` as one PyTorch
    extension (ninja runs one compiler per source, in parallel) and print
    the build seconds;
(b) hold every kernel against its plain PyTorch version on the card at the
    main path's shapes (franka/industrial: the real packed table and franka
    FK for K1; [252, 12, 12] Grams for K2), forward and backward, and time
    kernel, plain version, library call and the bound;
(c) the main path: ``PlanningSession("franka", "industrial")``, 36 queries,
    the full 200-step batched Adam solve with linear init and again with
    zeros init, then posterior extraction (150 samples x 100 times); plus a
    small-input ELBO check against the CPU's plain path;
(d) a ``torch.profiler`` window over a 20-step solve: device busy share,
    kernels by device time, host time per solver span.

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


def time_ms(torch, fn, reps: int = 20, flush=None) -> float:
    """Mean CUDA-event time of ``fn`` per call; ``flush`` (a large buffer) is
    rewritten between calls so the 50 MB L2 starts cold, as each Adam step
    finds it."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def k1_phase(torch, sess, flush):
    """K1 against ``log_prob_plain``, which on the card is plain PyTorch end to
    end (FK, ``packed_lookup_plain``'s gather and unpack, the hinge)."""
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.sdf.grid import _packed_flat_index

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
    ms = time_ms(torch, lambda: col.k1_loglik(model, q2, sigma, True), flush=flush)
    ms_fwd = time_ms(torch, lambda: col.k1_loglik(model, q2, sigma, False), flush=flush)

    def plain():
        qq = q.clone().requires_grad_()
        torch.autograd.grad(col.log_prob_plain(model, qq, sigma).sum(), qq)

    plain_ms = time_ms(torch, plain, reps=5, flush=flush)
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
    log("K2 check (relative / absolute): "
        + ", ".join(f"{k} {v:.2e} / {worst_abs[k]:.2e}" for k, v in worst.items()))

    Kc = rand[ok].contiguous()
    L = la.k2_chol(Kc)
    chol = {"ms": time_ms(torch, lambda: la.k2_chol(Kc), flush=flush),
            "plain_ms": time_ms(torch, lambda: la.cholesky_unrolled(Kc), flush=flush),
            "library_ms": time_ms(torch, lambda: torch.linalg.cholesky(Kc), flush=flush)}
    Tm = Kc.shape[0]
    chol["bound_ms"], chol["bound_by"] = bound_ms(2 * Tm * n * n * 8, Tm * n ** 3 / 3, F64_FLOPS)
    trsm = {}
    for k in (1, 20, 50, 100, 150):
        Bm = torch.randn((Tm, n, k), generator=gen, device=dev, dtype=torch.float64)
        b_ms, b_by = bound_ms((Tm * n * n + 2 * Tm * n * k) * 8, Tm * n * n * k, F64_FLOPS)
        trsm[k] = {"ms": time_ms(torch, lambda: la.k2_trsm(L, Bm, False), flush=flush),
                   "plain_ms": time_ms(torch, lambda: la.solve_lower_unrolled(L, Bm), flush=flush),
                   "library_ms": time_ms(torch, lambda: torch.linalg.solve_triangular(L, Bm, upper=False),
                                         flush=flush),
                   "bound_ms": b_ms, "bound_by": b_by}
    log(f"K2 chol [{Tm},{n},{n}]: " + json.dumps(chol))
    for k, v in trsm.items():
        log(f"K2 trsm lower [{Tm},{n},{k}]: " + json.dumps(v))

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
    ], {"relative": worst, "absolute": worst_abs}


def small_input_check(torch, sess):
    """ELBO and its gradient on the card (K1, K2) against the CPU's plain path
    on the same model, params and draws: 4 problems, S=4, N=16.
    Tolerance 1e-3 relative: float32 bulk tensors on both, summed in other
    orders, and a rare sphere in a neighbouring voxel."""
    from vgpmp_torch.gp.pathwise import draw_noise
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.session import PlanningSession

    cpu = PlanningSession("franka", "industrial", overrides=sess.overrides, device="cpu")
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
    counters = (k1_loglik, la.k2_chol, la.k2_trsm)
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


def profile_phase(torch, sess, steps: int = 20):
    """Where a step's time goes: ``torch.profiler`` over a ``steps``-step solve
    of the main path (B=36) after a warm-up solve; the same solve is also
    timed without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner

    starts, goals = sess.queries()
    pp = sess.planner_params
    cfg = dataclasses.replace(sess.train_config, num_steps=steps)
    solve = solver.make_batch_solver(sess.model, cfg)
    params = planner.init_params_batch(sess.model, starts, goals, [0] * len(starts),
                                       0.5 * (starts + goals), pp["lengthscales"], pp["variance"],
                                       pp["sigma_obs"], pp["alpha"])

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(1))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
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
           "device_kernel_launches": launches, "span_cpu_ms": spans,
           "top_kernels": [{"name": e.key[:90], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3} for e in top]}
    log(f"(d) profile of a {steps}-step solve + extraction, B={len(starts)}: wall {plain_wall:.3f} s "
        f"unprofiled, {wall:.3f} s profiled; device busy {busy_us / 1e3:.2f} ms "
        f"({rec['device_busy_share']:.3f} of the profiled wall, "
        f"{rec['device_busy_share_of_unprofiled_wall']:.3f} of the unprofiled), {launches} kernel launches; "
        f"spans (host ms) {json.dumps({k: round(v, 1) for k, v in spans.items()})}")
    for t in rec["top_kernels"]:
        log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
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
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=sess.device)

    log("(b) kernels against their plain versions")
    k1 = k1_phase(torch, sess, flush)
    k2, k2_errs = k2_phase(torch, sess, flush)
    small = small_input_check(torch, sess)
    del flush

    log("(c) main path")
    summary, launches, t_ext, peak = main_path(torch, sess)

    prof = profile_phase(torch, sess)

    k1["launches"] = launches["k1_loglik"]
    k2[0]["launches"] = launches["k2_chol"]
    k2[1]["launches"] = launches["k2_trsm"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = [{k: v for k, v in d.items() if k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "max_rel_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")} for d in [k1, *k2]]
    record = {"card": smi, "build_s": secs, "kernels": [k1, *k2], "k2_errors": k2_errs,
              "small_input_rel_errors": small, "main_path": summary, "extraction_s": t_ext,
              "peak_memory_bytes": peak, "launches": launches, "profile": prof,
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
