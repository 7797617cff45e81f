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
    in the extraction; the lone solves timed at the extraction's 1 and 100
    columns, lower and transposed, and both lone kernels at the widest
    problemset's n = 26); 36 x 6400 PD-path probes against
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
    K2 launches per Adam step; a second window over one
    ``execute_and_validate`` of the round's best trajectories: device busy
    ms, device launches, K3's device ms; and a third over lone launches of
    ``k2_chol``, ``k2_trsm`` (k = 1 and 100, lower and transposed), K4 at
    one point, and (i)'s ``k1_dsigma`` and (t1)'s K1-trilinear (with d/dq
    and forward only) at their shapes: each kernel's device-only time
    beside its event time (run last, after (g));
(e) the scored round: ``make_round_solver`` on the 36 queries at 200 steps
    (solve, best sample, then ``execute_and_validate`` of every row: two K3
    launches, the fused probe entry and the endpoints), with the verdicts
    held against the port's CPU plain path on the same trajectories;
(f) the gather benchmark ``tools/gather_bench_torch.py`` (K4);
(g) the bench's own configuration: ``solve_adaptive`` on the 36 queries from
    the tuned inits (round 0 from ``frand5``), 8 rounds at most, one bucket of
    36 slots, seed 0; the merged verdicts held against the CPU plain path on
    the same trajectories, and the free-space probe behind ``frand5`` held
    against the CPU plain path on round 0's 36 x 64 candidates, and the lone
    K2 launches per round counted (run before the profiles of (d));
(h) every other combo of the matrix (``benchmarking_torch.ALL_COMBOS``: kuka,
    wam and ur10 FK through K1 and K3, M up to 24, which is Mc 26 in K2's
    fused pair, the bookshelves and lab grids, B up to 91): the tuned packed
    session, one ``make_round_solver`` round at the problemset's own B, steps,
    S, N and M from its first tuned init, its verdicts held against the CPU
    plain path on the same trajectories;
(i) ``PlanningSession.from_config`` on a reference-schema YAML with σ_obs and
    alpha trainable: K1's d/dσ (the forward that also writes h², then
    ``k1_dsigma``) held against its plain version at 36 000 x 37 and timed
    beside the frozen forward, then a 200-step B = 36 solve through it,
    whose σ_obs and alpha must move and stay finite;
(j) the scored round of (e) with ``randomize_timesteps`` (each row's own
    sorted uniform training grid);
(k) the velocity-constrained GP through the session overlay: K2's fused pair
    on the real velocity Grams (n = 14 here, n = 28 at franka/bookshelves'
    M = 24) against its plain version and timed, then a 200-step B = 36
    solve: finite ELBO, both ends of every best trajectory at rest, a draw's
    latent paths clamped in position and velocity at both ends, 2 K2
    launches a step, verdicts against the CPU plain path;
(l) the same 200-step solve as 4 chunks of 50 with ``save_train_state`` /
    ``restore_train_state`` between them, against one chunk of 200 from the
    same generator seed, bit for bit;
(m) ``run_receding_horizon`` at B = 36 (200 steps, then 40-step replans, 3
    cycles advancing 20 waypoints), without and with a 0.15 rad disturbance,
    each cycle timed;
(n) ``make_ensemble_solver`` over the 6 tuned inits (216 rows in one solve
    and one metric), its chosen inits against the CPU plain metric's argmax
    on the card's member trajectories, and its peak memory;
(o) a scene with objects: ``SceneBuilder`` puts the table, the duck, the
    pringles can and the boxes scene's grid (``OBJECTS``) on the industrial
    base; K1 and K3 (both entries) on it against their plain versions at the
    main path's shapes, with each source's count of hinge-active wins and
    the configs whose d/dq is NaN (a sphere centre inside the table, as in
    JAX); the bench's adaptive solve on it at full width (launch counts, no
    plain log_prob on CUDA, the row-steps the guard skipped, verdicts
    against the CPU plain metric on all 36 rows); then ``move_object`` and a
    round that reads the new pose with nothing rebuilt.

(p) the parallel layer (``vgpmp_torch.parallel``) at the bench's
    configuration: (p1) a world of one over NCCL on this card, where
    ``make_sharded_solver`` must give ``make_batch_solver``'s result bit for
    bit (both timed, with the cost of the whole-batch draw every rank makes)
    and ``make_sharded_round_solver`` inside ``solve_adaptive`` (g)'s rounds,
    k_eff and executed rows; (p2) two ranks as processes of this script
    (``--p2-rank``; a card each over NCCL where there are two, else both on
    this card over gloo): dp = 2 against (p1) (verdicts equal, trajectories
    within 1e-5 rad), dp = 1 x sp = 2 (the best trajectory and every step's
    averaged likelihood bit-equal on both ranks, verdicts against the CPU
    plain path), the collectives counted; then
    ``tools/launch_multihost_torch.py --processes 2 --device cuda``.
(t) the CUDA envelope, after (p): (t1) K1's nearest-cell and trilinear
    lookups on the real float32 grid at 36 000 x 37 against their plain
    versions (value, d/dq, d/dσ through ``k1_dsigma``), timed, and a 20-step
    solve on the trilinear lookup; (t2) the reference-parity protocol,
    ``benchmarking_torch.run_combo("franka", "industrial", 1, "nearest", 0,
    use_tuned=False)`` at full width through K1-nearest (once a step, no
    plain ``log_prob`` on the card), its verdicts against the CPU plain path
    and its executed count beside JAX's ``RESULTS_r05_parity.json``; (t3) K2
    at n = 40, 64 and 128 (the block design: panels of 32, the float64
    products on the tensor cores) and in float32 at n = 12, 26, 40, 64 and
    128 against the plain versions, timed beside ``torch.linalg``; 20-step
    solves at Mc = 40 (fused, and with ``jitter_escalations=1``), and a
    20-step float32-island solve (``solve_dtype`` float32, jitter 1e-6, 3
    escalations: ``k2_chol`` and ``k2_trsm`` in float32), its first ELBO
    against the CPU plain path on the same draws; above n = 128 (the
    streamed design, its lower tiles in device memory) the four entries at n
    = 129, 160 and 256 in float64 and 160 and 256 in float32 and on the real
    Mc = 160 Grams, timed beside ``torch.linalg``, then 20-step solves at
    the bench's full width at Mc = 160 (``num_inducing=158``: fused on draws
    made on the CPU, and with ``jitter_escalations=1``) and Mc = 256, 36
    finite rows each and their K2 launches at n > 128 counted, and the Mc =
    160 solve's first ELBO against one ELBO of the CPU plain path on the
    same draws; (t4) a float64 session: K1 and both K3 entries against
    their plain versions, a 20-step solve against the CPU float64 plain path
    on the same draws, and a scored round whose verdicts are held against
    the CPU plain path, K1 and K3 launched in float64.

(u) mesh -> SDF, after (t): ``vgpmp_torch.sdf.gen.mesh_to_sdf`` on a
    synthetic mesh with the industrial scene mesh's counts (23 closed convex
    pieces, boxes and fan-capped prisms, overlapping, 422 triangles; made
    from seed 0 by ``synthetic_mesh``) at the industrial grid's voxel edge
    and a padding of 25 cells: 337 x 401 x 205 cells, voxelized by K5
    (``csrc/k5_mesh_sdf.cuh``) and held against ``sdf_grid_plain`` on the
    card (1e-6 m, the sign bit equal in every cell), timed beside the plain
    version and the bound; then the grid as an object of a franka/industrial
    session (``SceneBuilder.add_object(..., grid=...)``): a 20-step solve and
    a scored round of 20 steps through the composed K1 and K3, every row
    finite.

(v) the RFF prior's paths, after (u): K6 (``csrc/k6_rff.cuh``) at wam's and
    franka's round-0 shapes (1 024 x 7 x (26 + 70) and 512 x 7 x (12 + 50)
    points x 1 024 bases, S 7 and 20), forward and forward with backward,
    against the plain chain on the card (L2 flushed, 20 calls) and the
    bound of ``benchmark/work/rff.py``'s count; the paths and the gradients
    of x, ω and the scale against the float64 plain chain; the peak memory
    of one step of each cell's configuration at its rows, plain chain and
    K6; a 3-step solve with extraction through K6, none of the plain chain
    on the card (``k6_rff.plain_on_card``).

(w) the UR10 on the bookshelves, after (v): the ``ur10-bookshelves-b3520``
    cell's round-0 shape (the problemset's 55 queries tiled to 3 520 rows;
    6 joints, standard DH, 17 spheres). First the 6-joint kernels against
    their plain versions on the same card inputs: K1's likelihood and d/dq
    at 3 520 x 7 x 70 configurations along the queries' lines with 1 rad of
    noise (about a quarter hinge-active), K3's clearance of the round's
    3 x 3 520 endpoints and its probes of 3 520 trajectories of 150 points
    (``pd_path_configs``' 9 600 probes a row), at the card tests'
    tolerances. Then ``make_round_solver`` at 3 steps: training, the
    extraction and the metric. K1 and both K3 entries launched for 6 joints
    and standard DH only (``launches_by_arm``), none of the plain K1, K3 or
    K6 on the card (``plain_on_card``), every row finite; the card's peak
    memory and the round's seconds.

(q) ``tools/diagnose_failures_torch.py`` on wam/industrial (seed 0, 3
    adaptive rounds): a classed row for each problem not executed, and the
    failure profile (the packed training lookup along the densified best
    trajectory) on the card against the CPU plain path on the same
    trajectories;
(r) ``tools/batch_scaling_torch.py`` at B = 36 and 256 (one steady call, a
    child process a size): no failed size, a finite peak memory, every kernel
    of the solve and the metric launched in each child;
(s) ``tools/profile_breakdown_torch.py`` at B = 36 (10 calls a stage) in a
    process of its own: stream and device ms and launches per stage of an
    Adam step, K1 among the ``log_prob`` stages' kernels.

(d)'s profiles run after (r), and (s) after them: a child's profiling
session on the card makes this process's later profiler windows drop kernel
records. Prints one JSON line for each of (k)–(s), the
card's name and power limit, a ``kernels`` JSON line (K1 and its d/dσ pair,
K2 with the fused pair's velocity shapes, K3, K4, K1 and K3 on (o)'s
scene, and (t)'s rows: K1-nearest, K1-trilinear, K1 and K3 in float64, K2's
block design at n = 40 (``[n=40]``, ``"design": "blocked"``, with n = 64 and 128
in the record), its streamed design at n = 160 (``[n=160]``, ``"design":
"streamed"``, with n = 129 and 256, and float32 at 160 and 256, in the record)
and its float32 ``k2_chol`` and ``k2_trsm``; each K1 row
names its design, ``one-pass`` or ``split``, and its bound counts, in
nearest mode, the neighbours of the hinge-active pairs only, with the count
of every pair's neighbours beside it in the record; each K3 row names its
design, ``one-grid`` on the base grid alone or ``culled`` on a scene with
objects; and (u)'s K5, its bound counted over every (cell, triangle) pair
and every (column, triangle) ray test; (v)'s K6 at wam's shape), and as
the last line
``{"ok": true, "device": {...}}``. A detailed record goes to
``chiprun_out/chip_smoke.json``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 and
# float64 rates outside the tensor cores, and float64 on the tensor cores
# (DMMA), where K2's block design runs its products.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
F64_TC_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound(entry: str, T: int, n: int, k: int, itemsize: int, peak_flops: float):
    """The bound of a K2 entry on ``T`` matrices from what each must move and
    compute (``vgpmp_torch.ops.linalg.k2_work``: triangular inputs read as
    their lower triangles)."""
    from vgpmp_torch.ops.linalg import k2_work

    values, ops = k2_work(entry, n, k)
    return bound_ms(T * values * itemsize, T * ops, peak_flops)


def k1_inputs(torch, sess):
    """K1's inputs at the main path's shape: configs ``[B, S, N, L]`` near
    the straight lines between the queries, half of the samples uniform over
    the joint box (so that many spheres sit inside obstacles and the hinge and
    its gradient are exercised), clipped to the limits; in the session's
    dtype (the draws in float32)."""
    dev = sess.device
    starts, goals = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in sess.queries())
    B, S, N, L = starts.shape[0], 20, 50, starts.shape[1]
    gen = torch.Generator(device=dev).manual_seed(11)
    frac = torch.linspace(0, 1, N, device=dev)[None, None, :, None]
    q = starts[:, None, None] + (goals - starts)[:, None, None] * frac
    q = q + 0.15 * torch.randn((B, S, N, L), generator=gen, device=dev)
    lo, hi = sess.model.limits_low, sess.model.limits_high
    q[:, S // 2:] = lo.float() + (hi - lo).float() * torch.rand((B, S - S // 2, N, L), generator=gen,
                                                                 device=dev)
    return torch.minimum(torch.maximum(q.to(lo.dtype), lo), hi).contiguous()


def grid_sectors(torch, sc, pos, mode: str, need=None) -> int:
    """The distinct 32-byte sectors that a K1 lookup in ``mode`` touches at
    the world points ``pos [..., 3]`` in each grid of the scene ``sc``:
    ``packed`` the cell's 8-byte word (four a sector), ``nearest`` the cell
    and, for the gradient, its six clipped neighbours (the central
    difference) where ``need`` (a bool mask of ``pos``'s leading shape per
    grid, base first: :func:`gradient_pairs`) holds, or everywhere where it
    is None, ``trilinear`` the eight corners, in the grid's dtype (8 float32
    or 4 float64 values a sector)."""
    from vgpmp_torch.sdf.grid import _cell_index, _flat, _packed_flat_index, trilinear_cell

    if mode == "packed":
        pairs = [(sc.base_packed, sc.base_offset),
                 *zip(sc.extra_packed, sc.extra_offsets if sc.extra_packed else [])]
        return sum(torch.unique(_packed_flat_index(g, pos - off).reshape(-1) // 4).numel()
                   for g, off in pairs)
    total = 0
    grids = [(sc.base, sc.base_offset), *zip(sc.extra_grids, sc.extra_offsets if sc.extra_grids else [])]
    for k, (g, off) in enumerate(grids):
        per = 32 // g.data.element_size()
        p = pos - off
        if mode == "nearest":
            i = _cell_index(g.shape, g.origin, g.delta, p)
            flats = [_flat(g.shape, i).reshape(-1)]
            ni = i.reshape(-1, 3) if need is None else i[need[k]]
            nmax = torch.tensor([s - 1 for s in g.shape], device=p.device)
            for a in range(3):
                e = torch.zeros(3, dtype=torch.int64, device=p.device)
                e[a] = 1
                flats += [_flat(g.shape, torch.minimum(torch.clamp(ni + d, min=0), nmax)).reshape(-1)
                          for d in (e, -e)]
        else:
            _, ny, nz = g.shape
            flat = _flat(g.shape, trilinear_cell(g, p)[0]).reshape(-1)
            flats = [flat + dx * ny * nz + dy * nz + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
        total += torch.unique(torch.cat([torch.unique(f // per) for f in flats])).numel()
    return total


def gradient_pairs(torch, model, pos):
    """The hinge-active sphere evaluations (h > 0) at the centres ``pos
    [..., P, 3]`` of ``model``'s scene, and per grid (base first) those
    whose d/dq reads that grid's gradient: the active ones where the grid
    attains the composed minimum (the minimum's gradient gives no weight to
    a source above it). Bool masks of ``pos``'s leading shape."""
    srcs = [d for _, d in model.scene.sources(pos)]
    dmin = torch.stack(srcs).amin(0)
    active = model.epsilon - (dmin - model.fk.sphere_radii) > 0
    return active, [active & (d == dmin) for d in srcs[:1 + len(model.scene.extra_grids)]]


def k1_bound(torch, model, q, sigma, grad=True, h2=False, recount=True):
    """K1's bound at the configs ``q [..., L]`` with ``sigma``, σ a row as K1
    takes it: the distinct 32-byte sectors
    that the spheres' lookups touch in each grid of the scene
    (:func:`grid_sectors`, in the scene's mode; in nearest mode a cell's
    neighbours only where :func:`gradient_pairs` needs them, or with
    ``recount`` False, the earlier count, for every sphere; none without
    ``grad``), q and σ read and lik (and d/dq with ``grad``, h² with ``h2``)
    written once (in q's dtype); per config 7 DH compositions (~60 flops),
    per sphere its position, index and hinge (~30, ~40 more for the
    trilinear interpolation) and per extra source its index (~15 a grid) or
    its analytic value and gradient (~15 a sphere, ~50 a box, ~35 a
    capsule), and with ``grad`` per hinge-active pair the 7-joint torque
    accumulation (~16 each) and the lookup's gradient (~25 for the central
    difference), at the float32 or float64 peak. Returns (ms, "bytes" or
    "operations", sectors, bytes, flops)."""
    from vgpmp_torch.kinematics.dh import sphere_positions

    sc = model.scene
    L, P = q.shape[-1], model.fk.sphere_radii.shape[0]
    T = q.numel() // L
    with torch.no_grad():
        pos = sphere_positions(model.fk, q)
        active, need = gradient_pairs(torch, model, pos)
        if not grad:
            need = [torch.zeros_like(active)] * len(need)
        elif not recount:
            need = None
        sectors = grid_sectors(torch, sc, pos, sc.mode, need)
    es = q.element_size()
    Ks, Kb, Kc = model.tables.counts
    extra = 15 * len(sc.extra_grids) + 15 * Ks + 50 * Kb + 35 * Kc
    value = 30 + (40 if sc.mode == "trilinear" else 0) + extra
    gradient = L * 16 + (25 if sc.mode == "nearest" else 0)
    written = T * (1 + (L if grad else 0) + (P if h2 else 0))
    nbytes = sectors * 32 + (T * L + sigma.numel() + written + model.tables.prims.numel()) * es
    flops = T * (L * 60 + P * value) + (int(active.sum()) * gradient if grad else 0)
    peak = F64_FLOPS if q.dtype == torch.float64 else F32_FLOPS
    return (*bound_ms(nbytes, flops, peak), sectors, nbytes, flops)


def k1_agreement(torch, lik_k, gk, lik_p, gp, trilinear=False):
    """K1's (lik, d/dq) against the plain version's on the same configs.
    Tolerance: K1's FK may fuse multiply-adds and sum in another order, so a
    sphere near a voxel face may land in the neighbouring voxel: at most 1e-3
    of the configs may differ; the rest agree to 1e-5 relative (+1e-3
    absolute: 37-term float32 sums in another order), their gradients to
    1e-3 of the largest; in float64 to 1e-9 relative (+1e-9) and 1e-8. In
    trilinear mode the value is continuous across a face but its gradient is
    not, so there a config whose gradient differs counts in the same share.
    A config with a sphere centre inside or on a box has a NaN d/dq (as
    JAX's): the pattern must agree but for 1e-3 of the configs (a centre
    within a rounding of a box face). Asserts all that; returns the configs
    that agree and the record's numbers."""
    rtol, atol, gtol = (1e-9, 1e-9, 1e-8) if lik_k.dtype == torch.float64 else (1e-5, 1e-3, 1e-3)
    close = torch.isclose(lik_k, lik_p, rtol=rtol, atol=atol)
    nan_k, nan_p = torch.isnan(gk).any(-1), torch.isnan(gp).any(-1)
    nan_differ = (nan_k != nan_p).float().mean().item()
    if trilinear:
        finite = ~nan_k & ~nan_p
        close &= ((gk - gp).abs() <= gtol * gp[finite].abs().max()).all(-1) | ~finite
    share = (~close).float().mean().item()
    err = (lik_k - lik_p)[close].abs().max().item()
    both = close & ~nan_k & ~nan_p
    gscale = gp[both].abs().max().item()
    gerr = (gk - gp)[both].abs().max().item()
    assert share <= 1e-3, "K1: too many configs disagree with the plain version"
    assert gerr <= gtol * gscale + 1e-6, "K1: gradient disagrees with the plain version"
    assert nan_differ <= 1e-3, "K1: the NaN pattern of d/dq disagrees with the plain version"
    return close, {"max_abs_err": err, "max_rel_err": err / lik_p.abs().max().item(), "other_voxel_share": share,
                   "max_grad_err": gerr, "grad_scale": gscale, "nan_dq_configs": int(nan_p.sum()),
                   "nan_pattern_differs": nan_differ}


def k1_phase(torch, sess, flush, label="", model=None):
    """K1 against ``log_prob_plain``, which on the card is plain PyTorch end to
    end (FK, the scene's lookup: ``packed_lookup_plain``'s gather and unpack,
    or the nearest cell and its central difference, or the trilinear
    interpolation; on a scene with objects each extra grid's and the
    primitives' too, the hinge), in the session's dtype. ``model`` replaces
    the session's collision model (another lookup mode of its scene)."""
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.timing import time_ms

    model = model or sess.model.collision
    dev = sess.device
    q = k1_inputs(torch, sess)
    B, S, N, L = q.shape
    sigma = torch.full((B, model.fk.sphere_radii.shape[0]), 0.005, dtype=q.dtype, device=dev)

    qk = q.clone().requires_grad_()
    lik_k = model.log_prob(qk, sigma)
    (gk,) = torch.autograd.grad(lik_k.sum(), qk)
    qp = q.clone().requires_grad_()
    lik_p = col.log_prob_plain(model, qp, sigma)
    (gp,) = torch.autograd.grad(lik_p.sum(), qp)
    torch.cuda.synchronize()
    active = (lik_p < 0).float().mean().item()
    assert active >= 0.2, "K1 check: too few configs touch an obstacle to test the hinge"
    _, agree = k1_agreement(torch, lik_k, gk, lik_p, gp, model.scene.mode == "trilinear")
    log(f"K1{label} check: {B * S * N} configs, hinge active in {active:.4f} (>= 0.2), other-voxel share "
        f"{agree['other_voxel_share']:.2e} (<= 1e-3), max |dlik| {agree['max_abs_err']:.3e}, max |d grad| "
        f"{agree['max_grad_err']:.3e} of {agree['grad_scale']:.3e}; NaN d/dq in {agree['nan_dq_configs']} "
        f"configs (plain), pattern differs in {agree['nan_pattern_differs']:.2e} (<= 1e-3)")

    q2 = q.reshape(-1, L)
    # 100 calls each: at 20 a single slow call moves the mean by a tenth
    ms = time_ms(lambda: col.k1_loglik(model, q2, sigma, True), reps=100, flush=flush)
    ms_fwd = time_ms(lambda: col.k1_loglik(model, q2, sigma, False), reps=100, flush=flush)

    def plain():
        qq = q.clone().requires_grad_()
        torch.autograd.grad(col.log_prob_plain(model, qq, sigma).sum(), qq)

    plain_ms = time_ms(plain, reps=5, flush=flush)
    b_ms, b_by, sectors, nbytes, flops = k1_bound(torch, model, q, sigma)
    # the earlier count (every sphere's six neighbours in nearest mode), beside it
    old_ms, _, old_sectors, _, _ = k1_bound(torch, model, q, sigma, recount=False)
    log(f"K1{label} time: fwd+grad {ms:.4f} ms, fwd only {ms_fwd:.4f} ms, plain fwd+bwd {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {sectors} sectors = {sectors * 32 / 1e6:.1f} MB; every pair's "
        f"neighbours "
        f"{old_sectors} sectors, {old_ms:.4f} ms)")
    return {"name": "k1_collision_loglik" + label, "design": k1_design(model), "route": "cuda",
            "source": "vgpmp_torch/csrc/k1_collision.cuh",
            "replaces": "vgpmp_tpu/likelihoods/collision.py:76", **agree, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "hinge_active_share": active, "ms_forward_only": ms_fwd, "sectors": sectors, "nbytes": nbytes,
            "flops": flops, "sectors_every_pair": old_sectors, "bound_ms_every_pair": old_ms}


def k1_design(model) -> str:
    """The design of K1 that ``model``'s lookup runs
    (``csrc/k1_collision.cuh:k1_split``): ``split`` (every source's value
    first, the gradient only for hinge-active pairs) for every composed
    lookup and the nearest cell, ``one-pass`` for the base grid alone in the
    packed and trilinear lookups, in either dtype."""
    sc = model.scene
    composed = bool(sc.extra_grids) or sum(model.tables.counts) > 0
    return "split" if sc.mode == "nearest" or composed else "one-pass"


# The design of k1_dsigma (csrc/k1_collision.cuh), the label of its row in the
# kernels line and in tools/k1_designs.py's record
DSIGMA_DESIGN = "flat-warps-16B"


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

    def time_chol(K):
        """``k2_chol`` at ``[T, n, n]`` beside the plain version,
        ``torch.linalg.cholesky`` and the bound."""
        Tt, nt = K.shape[0], K.shape[-1]
        b_ms, b_by = k2_bound("chol", Tt, nt, 0, 8, F64_FLOPS)
        return {"ms": time_ms(lambda: la.k2_chol(K), flush=flush),
                "plain_ms": time_ms(lambda: la.cholesky_unrolled(K), flush=flush),
                "library_ms": time_ms(lambda: torch.linalg.cholesky(K), flush=flush),
                "bound_ms": b_ms, "bound_by": b_by}

    def time_trsm(L, k):
        """``k2_trsm`` at ``[T, n, k]``, lower and transposed, beside the plain
        version, ``solve_triangular`` and the bound."""
        Tt, nt = L.shape[0], L.shape[-1]
        Bm = torch.randn((Tt, nt, k), generator=gen, device=dev, dtype=torch.float64)
        b_ms, b_by = k2_bound("trsm", Tt, nt, k, 8, F64_FLOPS)
        return {"ms": time_ms(lambda: la.k2_trsm(L, Bm, False), flush=flush),
                "plain_ms": time_ms(lambda: la.solve_lower_unrolled(L, Bm), flush=flush),
                "library_ms": time_ms(lambda: torch.linalg.solve_triangular(L, Bm, upper=False),
                                      flush=flush),
                "upper_t_ms": time_ms(lambda: la.k2_trsm(L, Bm, True), flush=flush),
                "upper_t_plain_ms": time_ms(lambda: la.solve_upper_T_unrolled(L, Bm), flush=flush),
                "upper_t_library_ms": time_ms(
                    lambda: torch.linalg.solve_triangular(L.mT, Bm, upper=True), flush=flush),
                "bound_ms": b_ms, "bound_by": b_by}

    Kc = rand[ok].contiguous()
    Tm = Kc.shape[0]
    L = la.k2_chol(Kc)
    chol = time_chol(Kc)
    # the main path's widths: the extraction's mean (k = 1) and its grid of
    # 100 times, lower and transposed; 20, 50 and 150 beside them
    trsm = {k: time_trsm(L, k) for k in (1, 20, 50, 100, 150)}
    # the widest problemset's Mc (26, num_inducing 24), random SPD
    n26 = 26
    G26 = torch.randn((Tm, n26, n26), generator=gen, device=dev, dtype=torch.float64)
    K26 = G26 @ G26.mT + n26 * torch.eye(n26, device=dev, dtype=torch.float64)
    L26 = la.k2_chol(K26)
    at26 = {"chol": time_chol(K26), "trsm": {k: time_trsm(L26, k) for k in (1, 100)}}
    B26 = torch.randn((Tm, n26, 100), generator=gen, device=dev, dtype=torch.float64)
    err26 = max([errs(L26, la.cholesky_unrolled(K26))[1]]
                + [errs(la.k2_trsm(L26, B26, up), fp(L26, B26))[1]
                   for up, fp in ((False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled))])
    assert err26 <= 1e-9, f"K2 at n = 26: {err26}"
    at26["max_rel_err"] = err26
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
        b_ms, b_by = k2_bound("pair", Tm, n, k, 8, F64_FLOPS)
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
    fused_bwd["bound_ms"], fused_bwd["bound_by"] = k2_bound("bwd", Tm, n, kf, 8, F64_FLOPS)
    log(f"K2 chol [{Tm},{n},{n}]: " + json.dumps(chol))
    for k, v in trsm.items():
        log(f"K2 trsm [{Tm},{n},{k}] (lower, and upper_t): " + json.dumps(v))
    log(f"K2 chol [{Tm},{n26},{n26}]: " + json.dumps(at26["chol"]))
    for k, v in at26["trsm"].items():
        log(f"K2 trsm [{Tm},{n26},{k}] (lower, and upper_t): " + json.dumps(v))
    log(f"K2 at n = {n26}: max relative error {err26:.2e} (<= 1e-9)")
    for k, v in fused_by_k.items():
        log(f"K2 fused forward [{Tm},{n},{n}] + [{Tm},{n},{k}]: " + json.dumps(v))
    log(f"K2 fused backward, same shapes: " + json.dumps(fused_bwd))

    def worst_of(prefix):
        return {"max_abs_err": max(v for k, v in worst_abs.items() if k.startswith(prefix)),
                "max_rel_err": max(v for k, v in worst.items() if k.startswith(prefix))}

    return [
        {"name": "k2_chol", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cuh",
         "replaces": "vgpmp_tpu/ops/linalg.py:30", **worst_of("chol"), **chol,
         "shape": [Tm, n, n], "at_n26": at26["chol"]},
        # the row at the extraction's grid of 100 times (gp/posterior.py)
        {"name": "k2_trsm", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cuh",
         "replaces": "vgpmp_tpu/ops/linalg.py:52", **worst_of("trsm"), **trsm[100],
         "shape": [Tm, n, 100], "by_k": trsm, "at_n26": at26["trsm"]},
        {"name": "k2_factor_solve", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cuh",
         "replaces": "vgpmp_tpu/ops/linalg.py:30", **worst_of("fused"), **fused,
         "shape": [Tm, n, kf], "by_k": fused_by_k},
        # the backward launch is held through autograd in the same checks
        {"name": "k2_factor_solve_bwd", "route": "cuda", "source": "vgpmp_torch/csrc/k2_linalg.cuh",
         "replaces": "vgpmp_tpu/ops/linalg.py:30", **worst_of("fused_random"), **fused_bwd,
         "shape": [Tm, n, kf]},
    ], {"relative": worst, "absolute": worst_abs}


K3_CULL_MARGIN = 1e-3  # csrc/k3_clearance.cuh:K3_CULL_MARGIN


def k3_primitive_work(torch, model, pos):
    """What the culled K3 (``csrc/k3_clearance.cuh:primitives_min_near``)
    does with the scene's primitives at the sphere centres ``pos [..., P,
    3]``: from the minimum over the grids, each primitive in the kernel's
    order (spheres, boxes, capsules) has its bounding sphere tested against
    the minimum so far, a box whose sphere passes its thinnest slab too, and
    is evaluated only where both pass; the minimum takes what is evaluated.
    Returns (bounding-sphere tests, slab tests, evaluations per kind [Ks, Kb,
    Kc], the minimum over the grids and the evaluated primitives)."""
    sc, pr = model.scene, model.scene.primitives
    srcs = sc.sources(pos, mode_override="trilinear")[:1 + len(sc.extra_grids)]
    d = srcs[0][1]
    for _, s in srcs[1:]:
        d = torch.minimum(d, s)
    if pr is None:
        return 0, 0, [0, 0, 0], d
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    tests = slabs = 0
    evals = [0, 0, 0]

    def fold(kind, c, radius, value, slab=None):
        nonlocal d, tests, slabs
        x = pos - c
        t = torch.fmax(d, zero) + radius + K3_CULL_MARGIN
        keep = ~((x * x).sum(-1) > t * t)
        tests += d.numel()
        if slab is not None:
            row, h = slab
            slabs += int(keep.sum())
            keep &= ~((x @ row).abs() - h > torch.fmax(d, zero) + K3_CULL_MARGIN)
        evals[kind] += int(keep.sum())
        d = torch.where(keep, torch.minimum(d, value(x)), d)

    for c, r in zip(pr.sphere_centers, pr.sphere_radii):
        fold(0, c, r, lambda x, r=r: x.norm(dim=-1) - r)
    for c, rot, h in zip(pr.box_centers, pr.box_rotations, pr.box_half_extents):
        def box(x, rot=rot, h=h):
            qb = (x @ rot.T).abs() - h
            return qb.clamp(min=0).norm(dim=-1) + qb.amax(-1).clamp(max=0)
        a = int(h.argmin())
        fold(1, c, h.norm(), box, (rot[a], h[a]))
    for a, b, r in zip(pr.capsule_a, pr.capsule_b, pr.capsule_radii):
        ab = b - a
        length = ab.norm()

        def capsule(x, ab=ab, r=r):  # x from the midpoint
            ap = x + 0.5 * ab
            t = ((ap * ab).sum(-1) / (ab * ab).sum()).clamp(0, 1)
            return (ap - t[..., None] * ab).norm(dim=-1) - r
        fold(2, a + 0.5 * ab, 0.5 * length + r if length > 0 else float("inf"), capsule)
    return tests, slabs, evals, d


def k3_bound(torch, model, q, extra_bytes: float, extra_flops: float):
    """K3's bound at the configs ``q [n, L]``: the distinct 32-byte sectors (8
    float32 or 4 float64 cells) of each grid of the scene that the eight
    corners of every config's spheres touch, plus q (read) and the minima
    (written) in q's dtype and ``extra_bytes``; per config 7 DH compositions (~60 flops), per sphere its
    position (18), the relative position and clamps (~20) and seven lerps (3
    flops each), as much again per extra grid, and the primitives as the
    culled K3 needs them at these configs (:func:`k3_primitive_work`): ~12
    flops a bounding-sphere or slab test, and ~10 an evaluated analytic
    sphere, ~40 a box and ~30 a capsule, plus ``extra_flops``, at the float32
    or float64 peak. Returns (ms, "bytes" or "operations", sectors)."""
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.sdf.grid import _flat, trilinear_cell

    sc = model.scene
    sectors = 0
    with torch.no_grad():
        pos = sphere_positions(model.fk, q)
        tests, slabs, ev, _ = k3_primitive_work(torch, model, pos)
        for grid, off in [(sc.base, sc.base_offset),
                          *zip(sc.extra_grids, sc.extra_offsets if sc.extra_grids else [])]:
            _, ny, nz = grid.shape
            i0, _ = trilinear_cell(grid, pos - off)
            flat = _flat(grid.shape, i0).reshape(-1)
            corners = [dx * ny * nz + dy * nz + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
            per = 32 // grid.data.element_size()
            sectors += torch.unique(torch.cat([torch.unique((flat + c) // per) for c in corners])).numel()
    n, L = q.shape
    P = model.fk.sphere_radii.shape[0]
    es = q.element_size()
    nbytes = sectors * 32 + (n * L + n + model.tables.prims.numel()) * es + extra_bytes
    flops = (n * (L * 60 + P * 60 * (1 + len(sc.extra_grids))) + 12 * (tests + slabs)
             + 10 * ev[0] + 40 * ev[1] + 30 * ev[2] + extra_flops)
    peak = F64_FLOPS if q.dtype == torch.float64 else F32_FLOPS
    return (*bound_ms(nbytes, flops, peak), sectors)


def k3_probe_bound(torch, model, qs, T: int):
    """K3's fused entry's bound on the probes ``qs [B, G, L]`` with ``T``
    segments a row: K3's (``k3_bound``) and beyond it the segment index (8 B)
    a probe read, the per-row inputs read, the counts written, and about 20
    operations a probe for the distances, the ramps and the compare."""
    B, G, L = qs.shape
    n = B * G
    return k3_bound(torch, model, qs.reshape(-1, L), n * 8 + B * (2 * L + 3) * qs.element_size() + B * T * 4,
                    n * 20)


def k3_design(model) -> str:
    """The design of K3 that ``model``'s scene runs
    (``csrc/k3_clearance.cuh``): ``culled`` on a scene with extras (a
    primitive evaluated only where its bounds reach below the minimum so
    far, ``primitives_min_near``), ``one-grid`` on the base grid alone."""
    composed = bool(model.scene.extra_grids) or sum(model.tables.counts) > 0
    return "culled" if composed else "one-grid"


def k3_inputs(torch, sess):
    """K3's inputs at the main path's shapes, in the session's dtype: the 36 x
    6400 PD-path probes ``q_path [230 400, L]`` (perturbed straight lines
    between the queries) and as many configs ``q_box`` uniform over the joint
    box (many spheres inside obstacles or outside the grid); and the fused
    entry's ``probe = (qs [40, 6400, L], args)``, ``args`` the rest of
    ``k3_probe_clearance``'s arguments: the same paths plus a row without
    motion, a row that turns NaN half way and two rows of random waypoints
    (which surely collide), their depths from the plain clearance; the
    probes' ``visited [40, 6400]`` and ``seg_idx``, and ``B`` the 36 query
    rows among the 40."""
    from functools import partial

    from vgpmp_torch import sim
    from vgpmp_torch.likelihoods import collision as col

    model = sess.model.collision
    dev = sess.device
    starts, goals = (torch.as_tensor(x, dtype=sess.dtype, device=dev) for x in sess.queries())
    B, T, L = starts.shape[0], sess.train_config.time_spacing_Xnew, starts.shape[1]
    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.linspace(0, 1, T, device=dev)[None, :, None]
    traj = starts[:, None] + (goals - starts)[:, None] * w
    traj = traj + 0.3 * torch.sin(torch.pi * w) * torch.randn((B, 1, L), generator=gen, device=dev)
    lo, hi = sess.model.limits_low, sess.model.limits_high
    traj = torch.minimum(torch.maximum(traj, lo), hi)
    q_path = sim.pd_path_configs(traj)[0].reshape(-1, L).contiguous()    # [36 * 6400, 7]
    q_box = lo + (hi - lo) * torch.rand(q_path.shape, generator=gen, device=dev)

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
    return {"q_path": q_path, "q_box": q_box, "probe": (qs, args), "visited": visited, "seg_idx": seg_idx,
            "B": B}


def k3_probe_agreement(torch, qs, args, clear_k, count_k, clear_p, count_p, visited, seg_idx, B):
    """K3's fused entry (``clear_k``, ``count_k``) against the plain version's
    on the probes ``qs`` (``k3_inputs``), asserted: the clearance to 1e-5 m
    (1e-9 m in float64), NaN where the plain version's is, and every
    segment's count between the probes below their floor by more than the
    tolerance and those within it (a probe within the tolerance of its floor
    may fall either way). Returns the record."""
    from vgpmp_torch import sim

    tol = 1e-9 if qs.dtype == torch.float64 else 1e-5
    q_s, q_g, depth_s, depth_g, _, _, T, radius, slack = args
    floor = sim._floor_from_depths(qs, q_s, q_g, depth_s, depth_g, radius, slack)
    nan_k, nan_p = torch.isnan(clear_k), torch.isnan(clear_p)
    ok = ~nan_p
    perr = (clear_k[ok] - clear_p[ok]).abs().max().item()
    near = visited & ((clear_p - floor).abs() <= tol)
    far = sim._segment_count(seg_idx, visited & (clear_p < floor) & ~near, T)
    near_n = sim._segment_count(seg_idx, near, T)
    differ = (count_k > 0) != (count_p > 0)
    responsible = int(near_n[differ].sum())
    assert torch.equal(nan_k, nan_p) and nan_p[B + 1].any() and not nan_p[:B].any(), \
        "K3 probe: NaN in, NaN out"
    assert perr <= tol, "K3 probe entry: clearance disagrees with the plain version"
    assert ((far <= count_k) & (count_k <= far + near_n)).all(), "K3 probe entry: counts disagree"
    assert bool((near_n[differ] > 0).all()), "K3 probe entry: a flag differs with no probe at its floor"
    assert count_p.sum() > 0 and count_k[B].sum() == 0 and not visited[B].any(), "K3 probe check: cases"
    return {"max_abs_err": perr, "tol": tol, "nan_probes": int(nan_p.sum()),
            "nan_equal": bool(torch.equal(nan_k, nan_p)), "violated_plain": int(count_p.sum()),
            "violated_kernel": int(count_k.sum()), "segments_plain": int((count_p > 0).sum()),
            "segments_kernel": int((count_k > 0).sum()), "segment_flags_differ": int(differ.sum()),
            "probes_at_floor_responsible": responsible}


def k3_phase(torch, sess, flush, label=""):
    """K3 against ``min_clearance_eval_plain`` on the real float32 grid at
    ``k3_inputs``: the main path's PD-path probes plus as many uniform
    configs. Then K3's fused entry ``k3_probe_clearance`` against
    ``probe_clearance_plain`` on ``k3_inputs``' probe rows
    (``k3_probe_agreement``). ``label`` names a scene with objects, or a
    float64 session, in the log and the records; a float64 session is held
    to 1e-9 m where a float32 one is held to 1e-5 m."""
    from functools import partial

    from vgpmp_torch import sim
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.timing import time_ms

    model = sess.model.collision
    tol = 1e-9 if sess.dtype == torch.float64 else 1e-5
    inp = k3_inputs(torch, sess)
    q_path, q_box, L = inp["q_path"], inp["q_box"], inp["q_path"].shape[1]
    q = torch.cat([q_path, q_box])

    got = model.min_clearance_eval(q)
    want = col.min_clearance_eval_plain(model, q)
    torch.cuda.synchronize()
    # tolerance: trilinear interpolation is continuous, so a sphere centre
    # that differs by a few float32 ulps moves the value by as little; K3
    # differs from the plain version by fused multiply-adds only: 1e-5 m
    # (1e-9 m in float64)
    err = (got - want).abs().max().item()
    negative = (want < 0).float().mean().item()
    log(f"K3{label} check: {q.shape[0]} configs ({q_path.shape[0]} PD-path probes + {q_box.shape[0]} uniform), "
        f"max |d clearance| {err:.3e} m (<= {tol:g}), negative clearance in {negative:.4f} (>= 0.1), "
        f"range [{want.min().item():.4f}, {want.max().item():.4f}] m")
    assert torch.isfinite(got).all(), "K3: non-finite clearance"
    assert err <= tol, "K3 disagrees with the plain version"
    assert negative >= 0.1, "K3 check: too few configs touch an obstacle"
    nan_q = q_path[:64].clone()
    nan_q[::2, 3] = float("nan")
    nan_out = col.k3_min_clearance(model, nan_q)
    assert torch.isnan(nan_out[::2]).all() and torch.isfinite(nan_out[1::2]).all(), "K3: NaN in, NaN out"

    ms = time_ms(lambda: col.k3_min_clearance(model, q_path), flush=flush)
    plain_ms = time_ms(lambda: col.min_clearance_eval_plain(model, q_path), reps=5, flush=flush)
    b_ms, b_by, sectors = k3_bound(torch, model, q_path, 0, 0)
    log(f"K3{label} time at {q_path.shape[0]} configs: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {sectors} sectors = {sectors * 32 / 1e6:.1f} MB)")
    k3 = {"name": "k3_min_clearance" + label, "design": k3_design(model), "route": "cuda",
          "source": "vgpmp_torch/csrc/k3_clearance.cuh",
          "replaces": "vgpmp_tpu/likelihoods/collision.py:59", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "negative_share": negative, "sectors": sectors, "configs_checked": q.shape[0],
          "configs_timed": q_path.shape[0]}

    # the fused entry on the round's shape
    qs, args = inp["probe"]
    B, T = inp["B"], args[6]
    plain = partial(col.min_clearance_eval_plain, model)
    clear_k, count_k = col.k3_probe_clearance(model, qs, *args)
    clear_p, count_p = sim.probe_clearance_plain(plain, qs, *args)
    torch.cuda.synchronize()
    pa = k3_probe_agreement(torch, qs, args, clear_k, count_k, clear_p, count_p, inp["visited"],
                            inp["seg_idx"], B)
    perr, differ = pa["max_abs_err"], pa["segment_flags_differ"]
    responsible = pa["probes_at_floor_responsible"]
    log(f"K3{label} probe entry check: {qs.shape[0]} rows x {qs.shape[1]} probes, max |d clearance| {perr:.3e} m "
        f"(<= {tol:g}), NaN probes {pa['nan_probes']} on both sides: {pa['nan_equal']}; "
        f"violated probes {pa['violated_plain']} (plain) / {pa['violated_kernel']} (kernel) in "
        f"{pa['segments_plain']} / {pa['segments_kernel']} segments; segment flags differ in "
        f"{differ}, explained by {responsible} probes within {tol:g} m of their floor")

    pms = time_ms(lambda: col.k3_probe_clearance(model, qs, *args), flush=flush)
    pplain_ms = time_ms(lambda: sim.probe_clearance_plain(plain, qs, *args), reps=5, flush=flush)
    n = qs.shape[0] * qs.shape[1]
    pb_ms, pb_by, psectors = k3_probe_bound(torch, model, qs, T)
    log(f"K3{label} probe entry time at {n} probes: kernel {pms:.4f} ms, plain {pplain_ms:.4f} ms, "
        f"bound {pb_ms:.4f} ms ({pb_by}: {psectors} sectors)")
    k3p = {"name": "k3_probe_clearance" + label, "design": k3_design(model), "route": "cuda",
           "source": "vgpmp_torch/csrc/k3_clearance.cuh",
           "replaces": "vgpmp_tpu/engine/validator.py:211", "max_abs_err": perr, "ms": pms,
           "plain_ms": pplain_ms, "bound_ms": pb_ms, "bound_by": pb_by, "library_ms": None,
           "sectors": psectors, "probes": n, "violated_plain": pa["violated_plain"],
           "violated_kernel": pa["violated_kernel"], "segment_flags_differ": differ,
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


def adaptive_phase(torch, sess, cpu):
    """(g) the adaptive restart engine at full width, as ``bench_torch.py``
    runs its real-set phase, with every round's executed count recorded."""
    import numpy as np

    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance
    from vgpmp_torch.ops import linalg as la

    starts, goals = sess.queries()
    B = len(starts)
    inits = tuple(sess.planner_params["q_mu_inits"])
    assert inits[0] == "frand5", inits
    round_solve = solver.make_round_solver(sess.model, sess.train_config)
    executed_by_round = []

    def solve(params, s, g, generator):
        best, rep = round_solve(params, s, g, generator)
        executed_by_round.append(rep.executed)  # read after the call: no sync inside a round
        return best, rep

    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd, k3_min_clearance,
                k3_probe_clearance)
    for c in (*counters, la.k2_chol):
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, reps, info = solver.solve_adaptive(sess.model, sess.train_config, starts, goals,
                                             sess.planner_params, inits=inits, max_rounds=8, seed=0,
                                             solve=solve, round_sizes=(B,))
    t_adaptive = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    # the lone factorisation and solves a round: the extraction's three solves,
    # and no factorisation (only the escalation path launches one)
    lone_per_round = {c.__name__: c.launches / info["rounds"] for c in (la.k2_trsm, la.k2_chol)}
    by_round = [int(e.sum()) for e in executed_by_round]
    executed, success = int(reps.executed.sum()), int(reps.success.sum())

    with torch.no_grad():
        ref = execute_and_validate(cpu.model.collision, torch.as_tensor(best),
                                   torch.as_tensor(starts, dtype=torch.float32),
                                   torch.as_tensor(goals, dtype=torch.float32),
                                   cpu.model.limits_low, cpu.model.limits_high)
    agree = {k: int((getattr(reps, k) == getattr(ref, k).numpy()).sum()) for k in ("executed", "success")}
    log(f"(g) solve_adaptive, B={B}, inits {list(inits)}, max_rounds 8: {info['rounds']} rounds in "
        f"{t_adaptive:.3f} s, k_eff {info['k_eff']:.3f}, restarts per problem "
        f"{info['restarts_per_problem']}; executed {executed}/{B} (by round, of the round's slots: "
        f"{by_round}), success {success}/{B}; launches {launches}; lone K2 launches per round "
        f"{lone_per_round}")
    log(f"    card vs CPU plain path on the merged trajectories: executed agrees on {agree['executed']}/{B}, "
        f"success on {agree['success']}/{B}")

    # the free-space probe of round 0's frand5 draw (36 x 64 candidates) on the
    # card against the CPU plain path. The lookup is the packed nearest cell:
    # a sphere centre a float32 rounding from a cell face may land in the
    # neighbouring cell, so such configs are counted (their share held to
    # 1e-3, as K1's check holds it) and the rest held to 1e-5 m. A pick may
    # differ only in a row where a candidate lies within 1e-5 m of the 0.03 m
    # margin, where the two clearest non-clearing candidates lie within 1e-5 m
    # of each other, or where a candidate's cell differs.
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.sdf.grid import _packed_flat_index

    cand, ref_cfg = solver.restart_candidates(sess.model, starts, goals, "frand5")
    n_cand, L = cand.shape[1], cand.shape[2]
    flat = cand.reshape(-1, L)
    cells, clears = [], []
    for s in (sess, cpu):
        q = torch.as_tensor(flat, dtype=torch.float32, device=s.device)
        col = s.model.collision
        with torch.no_grad():
            cells.append(_packed_flat_index(col.scene.base_packed,
                                            sphere_positions(col.fk, q) - col.scene.base_offset).cpu())
        clears.append(solver.min_clearance_probe(col, q).cpu().numpy().astype(np.float64))
    other = (cells[0] != cells[1]).any(dim=-1).numpy()
    clear_d, clear_c = clears
    perr = float(np.abs(clear_d - clear_c)[~other].max())
    picks = [solver.pick_via_points(cand, c.reshape(B, n_cand), ref_cfg) for c in clears]
    differ = (picks[0] != picks[1]).any(axis=-1)
    cc = clear_c.reshape(B, n_cand)
    near_margin = (np.abs(cc - 0.03) <= 1e-5).any(axis=1)
    top2 = np.sort(cc, axis=1)[:, -2:]
    near_tie = (top2[:, 1] < 0.03 + 1e-5) & (top2[:, 1] - top2[:, 0] <= 1e-5)
    explained = near_margin | near_tie | other.reshape(B, n_cand).any(axis=1)
    same_as_engine = bool(np.array_equal(solver.restart_waypoints(sess.model, starts, goals, "frand5"),
                                         picks[0]))
    log(f"    frand5 probe, {flat.shape[0]} candidates: max |d clearance| {perr:.3e} m (<= 1e-5) over those "
        f"in the same cells; candidates in another cell {int(other.sum())} (share <= 1e-3); rows with a "
        f"candidate within 1e-5 m of the margin {int(near_margin.sum())}, with a near tie "
        f"{int(near_tie.sum())}; picks differ in {int(differ.sum())} rows, all explained: "
        f"{bool((explained | ~differ).all())}; rows clearing the margin "
        f"{int((cc >= 0.03).any(axis=1).sum())}/{B}; restart_waypoints gives the card's picks: {same_as_engine}")

    assert best.shape == (B, sess.train_config.time_spacing_Xnew, 7) and np.isfinite(best).all()
    assert info["spent"] == info["rounds"] * B and len(by_round) == info["rounds"]
    # the merge keeps each problem's best restart, so no round-0 row is lost
    assert executed >= by_round[0], (executed, by_round)
    assert executed >= B - 2, f"the adaptive engine executed {executed} of {B} rows"
    assert min(agree.values()) >= B - 2, f"verdicts disagree with the CPU plain path: {agree}"
    assert perr <= 1e-5, "the free-space probe disagrees with the CPU plain path"
    assert other.mean() <= 1e-3, "too many candidates in another cell than on the CPU"
    assert bool((explained | ~differ).all()) and same_as_engine, "frand5 picks differ unexplained"
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"
    return {"adaptive_s": t_adaptive, "info": info, "executed": executed, "success": success,
            "executed_rows": reps.executed.tolist(),
            "executed_by_round": by_round, "agree_with_cpu": agree, "launches": launches,
            "lone_k2_launches_per_round": lone_per_round,
            "probe": {"candidates": int(flat.shape[0]), "max_abs_err_same_cell": perr,
                      "other_cell": int(other.sum()), "rows_near_margin": int(near_margin.sum()),
                      "rows_near_tie": int(near_tie.sum()), "picks_differ": int(differ.sum()),
                      "rows_clearing_margin": int((cc >= 0.03).any(axis=1).sum())}}


def combos_phase(torch):
    """(h) every other robot x environment combo of the matrix at full width,
    one scored round each: the tuned, packed session, one
    ``make_round_solver`` round at the problemset's own B, steps, S, N and M
    from its first tuned init (seed 0), its verdicts held against the port's
    CPU plain path on the same trajectories. The CPU session skips the packed
    table (``sdf_mode="nearest"``): the metric reads only the trilinear grid."""
    from benchmarking_torch import ALL_COMBOS
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.session import PlanningSession

    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd, k3_min_clearance,
                k3_probe_clearance)
    rec = {}
    for robot, ps in ALL_COMBOS[1:]:
        t0 = time.perf_counter()
        sess = PlanningSession(robot, ps)
        torch.cuda.synchronize()
        t_sess = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = PlanningSession(robot, ps, sdf_mode="nearest", device="cpu")
        t_cpu_sess = time.perf_counter() - t0
        starts, goals = sess.queries()
        B, pp, cfg, m = len(starts), sess.planner_params, sess.train_config, sess.model
        init = pp["q_mu_inits"][0]
        params = solver.init_slots(m, starts, goals, pp, [init] * B)
        solve = solver.make_round_solver(m, cfg)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best, rep = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
        torch.cuda.synchronize()
        t_round = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        st, gl = (torch.as_tensor(x, dtype=torch.float32) for x in (starts, goals))
        with torch.no_grad():
            ref = execute_and_validate(cpu.model.collision, best.cpu(), st, gl, cpu.model.limits_low,
                                       cpu.model.limits_high)
        counts = {k: int(getattr(rep, k).sum()) for k in
                  ("executed", "success", "collision_free", "endpoints_ok", "limits_ok")}
        agree = {k: int((getattr(rep, k).cpu() == getattr(ref, k)).sum()) for k in ("executed", "success")}
        clear_err = (rep.min_clearance.cpu() - ref.min_clearance).abs().max().item()
        shape = dict(B=B, steps=cfg.num_steps, S=m.num_samples, N=cfg.time_spacing_X, M=m.num_inducing,
                     Xnew=cfg.time_spacing_Xnew, dof=m.num_latent,
                     spheres=int(m.collision.fk.sphere_radii.shape[0]),
                     sigma_anneal=cfg.sigma_anneal, epsilon=m.collision.epsilon)
        log(f"(h) {robot}/{ps} {json.dumps(shape)}: session {t_sess:.2f} s (CPU twin {t_cpu_sess:.2f} s), "
            f"round from {init} {t_round:.3f} s; of {B} rows: "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; card vs CPU plain path: executed agrees on {agree['executed']}/{B}, success on "
            f"{agree['success']}/{B}, max |d min_clearance| {clear_err:.3e} m; launches {launches}")
        assert list(best.shape) == [B, cfg.time_spacing_Xnew, m.num_latent] and torch.isfinite(best).all()
        assert counts["endpoints_ok"] == B and counts["limits_ok"] == B, counts
        assert counts["executed"] >= 1, f"{robot}/{ps}: no row of the round was executed"
        assert min(agree.values()) >= B - 2, f"{robot}/{ps}: verdicts disagree with the CPU plain path: {agree}"
        assert clear_err <= 1e-4, f"{robot}/{ps}: min_clearance disagrees with the CPU plain path: {clear_err}"
        assert launches["k1_loglik"] >= cfg.num_steps and all(v > 0 for v in launches.values()), launches
        assert launches["k3_min_clearance"] == 1 and launches["k3_probe_clearance"] == 1, launches
        rec[f"{robot}/{ps}"] = {"shape": shape, "init": init, "session_s": t_sess, "cpu_session_s": t_cpu_sess,
                                "round_s": t_round, "counts": counts, "agree_with_cpu": agree,
                                "min_clearance_max_err_vs_cpu": clear_err, "launches": launches}
        del sess, cpu, m, solve, params, best, rep
        torch.cuda.empty_cache()
    return rec


# A reference-schema parameters.yaml: franka in the industrial scene, benchmark
# mode, with the likelihood variance (sigma_obs) and alpha trainable.
TRAINABLE_YAML = """\
- robot:
    robot_name: "franka"
- scene:
    position: [0.0, 0.0, 0.0]
    orientation: [0.0, 0.0, 0.0, 1.0]
    environment_name: "industrial"
    environment_file_name: "industrial"
    sdf_file_name: "industrial"
    objects: []
    benchmark: True
    benchmark_attributes:
      problemset_name: "industrial"
    non_benchmark_attributes:
- trainable_params:
    q_mu: True
    q_sqrt: True
    lengthscales: True
    kernel_variance: True
    sigma_obs: True
    inducing_variable: False
    alpha: True
- graphics:
    visuals: False
"""


def trainable_phase(torch, flush, k1, profiled=None):
    """(i) the YAML entry with σ_obs and alpha trainable: K1's d/dσ (the
    forward that also writes h², then ``k1_dsigma``) held against its plain
    version at the main path's 36 000 x 37, timed beside the frozen forward,
    then a 200-step B = 36 solve from ``PlanningSession.from_config``.
    ``profiled`` (a list) gets ``k1_dsigma``'s case for the last profiler
    window (:func:`kernel_profile_phase`), which gives its device-only time."""
    import tempfile

    from vgpmp_torch.engine import solver
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import time_ms

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "parameters.yaml"
        path.write_text(TRAINABLE_YAML)
        t0 = time.perf_counter()
        sess = PlanningSession.from_config(path)
        t_sess = time.perf_counter() - t0
    assert sess.trainable["sigma_obs_u"] and sess.trainable["alpha_u"], sess.trainable
    model, dev = sess.model.collision, sess.device
    q = k1_inputs(torch, sess)
    B, S, N, L = q.shape
    P = model.fk.sphere_radii.shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    sigma = 0.003 + 0.005 * torch.rand((B, P), generator=gen, device=dev)
    g = torch.randn((B, S, N), generator=gen, device=dev)

    def grads(fn, weight):
        qq, ss = q.clone().requires_grad_(), sigma.clone().requires_grad_()
        lik = fn(qq, ss)
        return (lik.detach(), *torch.autograd.grad((weight * lik).sum(), [qq, ss]))

    lik_k, dq_k, ds_k = grads(model.log_prob, g)
    lik_p, dq_p, _ = grads(lambda a, b: col.log_prob_plain(model, a, b), g)
    # as in (b): a config whose sphere lands in the neighbouring voxel on one
    # side only is left out (weight 0) of the d/dσ comparison
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    gm = g * close
    _, _, ds_km = grads(model.log_prob, gm)
    _, _, ds_pm = grads(lambda a, b: col.log_prob_plain(model, a, b), gm)
    q2, g2 = q.reshape(-1, L), gm.reshape(-1)
    lik_h, dq_h, h2 = col.k1_loglik(model, q2, sigma, True, True)
    lik_f, dq_f, _ = col.k1_loglik(model, q2, sigma, True)
    torch.cuda.synchronize()
    same_forward = bool(torch.equal(lik_h, lik_f) and torch.equal(dq_h, dq_f))
    # the reduction alone: the kernel on its own h² against the float64 sum of
    # the same terms; tolerance 1e-5 of Σ|g| h² / (2σ²), the float32 sum of
    # 1 000 terms of either sign in another order
    ds_dev = col.k1_dsigma(g2, h2, sigma)
    ref64 = col.dsigma_plain(g2.double(), h2.double(), sigma.double())
    scale = col.dsigma_plain(g2.abs().double(), h2.double(), sigma.double())
    red_err = ((ds_dev.double() - ref64).abs() / scale.clamp(min=1e-30)).max().item()
    # end to end against autograd through the plain version (float32 both):
    # 1e-4 of the same scale (h from float32 FK in both, summed in other orders)
    e2e_err = ((ds_km - ds_pm).abs().double() / scale.clamp(min=1e-30)).max().item()
    err = (lik_k - lik_p)[close].abs().max().item()
    gerr = (dq_k - dq_p)[close].abs().max().item()
    gscale = dq_p.abs().max().item()
    no_contact = int((scale == 0).all(dim=1).sum())
    log(f"(i) K1 d/dσ check at {B * S * N} x {P}: forward with h² equal to the frozen forward (lik and "
        f"d/dq): {same_forward}; max |dlik| {err:.3e}, max |d grad_q| {gerr:.3e} of {gscale:.3e} "
        f"(other-voxel share {(~close).float().mean().item():.2e}); d/dσ: reduction vs float64 "
        f"{red_err:.2e} of the absolute sum (<= 1e-5), end to end vs the plain version {e2e_err:.2e} "
        f"(<= 1e-4), max |dσ| {ds_km.abs().max().item():.4e}, rows without contact {no_contact}")
    assert same_forward, "K1's σ-grad forward differs from the frozen forward"
    assert (~close).float().mean().item() <= 1e-3 and gerr <= 1e-3 * gscale + 1e-6
    assert torch.isfinite(ds_k).all() and torch.isfinite(ds_dev).all()
    assert red_err <= 1e-5, f"k1_dsigma disagrees with the float64 sum: {red_err}"
    assert e2e_err <= 1e-4, f"K1's d/dσ disagrees with the plain version: {e2e_err}"

    T = q2.shape[0]
    ms = time_ms(lambda: col.k1_dsigma(g2, h2, sigma), reps=100, flush=flush)
    plain_ms = time_ms(lambda: col.dsigma_plain(g2, h2, sigma), flush=flush)
    ms_h2 = time_ms(lambda: col.k1_loglik(model, q2, sigma, True, True), reps=100, flush=flush)
    ms_frozen = time_ms(lambda: col.k1_loglik(model, q2, sigma, True), reps=100, flush=flush)

    def plain_fwd_bwd():
        qq, ss = q.clone().requires_grad_(), sigma.clone().requires_grad_()
        torch.autograd.grad(col.log_prob_plain(model, qq, ss).sum(), [qq, ss])

    plain_h2_ms = time_ms(plain_fwd_bwd, reps=5, flush=flush)
    # k1_dsigma reads h² and g once and writes [B, P]; 2 operations a term
    b_ms, b_by = bound_ms((T * P + T + 2 * B * P) * 4, 2 * T * P, F32_FLOPS)
    # the σ-grad forward: K1's bytes and operations plus h² written
    bh_ms, bh_by = bound_ms(k1["nbytes"] + T * P * 4, k1["flops"], F32_FLOPS)
    log(f"(i) K1 d/dσ time: k1_dsigma {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{(T * P + T) * 4 / 1e6:.2f} MB read); forward with h² {ms_h2:.4f} ms against the frozen forward "
        f"{ms_frozen:.4f} ms (plain forward and backward with σ {plain_h2_ms:.4f} ms, bound {bh_ms:.4f} ms "
        f"by {bh_by}: {T * P * 4 / 1e6:.2f} MB of h² written)")

    # the solve: 200 steps at B = 36 from the linear init, the file's mask
    starts, goals = sess.queries()
    pp, cfg = sess.planner_params, sess.train_config
    params = solver.init_batch(sess.model, starts, goals, pp)
    solve = solver.make_batch_solver(sess.model, cfg, sess.trainable)
    counters = (col.k1_loglik, col.k1_dsigma, la.k2_factor_solve, la.k2_factor_solve_bwd)
    for c in counters:
        c.launches = 0
    col.k1_loglik.launches_h2 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, res = solve(params, starts, goals, torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    launches["k1_loglik_h2"] = col.k1_loglik.launches_h2
    c0 = planner.constrain(params, sess.model.variance_lower)
    c1 = planner.constrain(trained, sess.model.variance_lower)
    s_rel = (c1["sigma_obs"] / c0["sigma_obs"] - 1).abs()
    a_rel = (c1["alpha"] / c0["alpha"] - 1).abs()
    e = res.elbo_history
    finite = bool(torch.isfinite(e).all() and torch.isfinite(c1["sigma_obs"]).all()
                  and torch.isfinite(c1["alpha"]).all() and torch.isfinite(res.best).all())
    rows_moved = int((s_rel > 0).any(dim=1).sum())
    log(f"(i) from_config session {t_sess:.2f} s; {cfg.num_steps}-step solve at B={len(starts)} with σ_obs "
        f"and alpha trainable: {t_solve:.3f} s, ELBO mean {e[:, 0].mean().item():.6g} -> "
        f"{e[:, -1].mean().item():.6g}, all finite {finite}; σ_obs moved in {rows_moved}/{len(starts)} rows, "
        f"|σ/σ0 - 1| max {s_rel.max().item():.3e} median {s_rel.median().item():.3e}; |alpha/alpha0 - 1| "
        f"max {a_rel.max().item():.3e}; failed rows {int(res.failed.sum())}; launches {launches}")
    assert finite, "non-finite ELBO, σ_obs, alpha or trajectory in the trainable solve"
    assert rows_moved == len(starts) and a_rel.max() > 0, "σ_obs or alpha did not move"
    assert launches["k1_loglik_h2"] == cfg.num_steps and launches["k1_dsigma"] == cfg.num_steps, launches
    dsig = {"name": "k1_dsigma", "design": DSIGMA_DESIGN, "route": "cuda",
            "source": "vgpmp_torch/csrc/k1_collision.cuh",
            "replaces": "vgpmp_tpu/likelihoods/collision.py:85", "launches": launches["k1_dsigma"],
            "max_abs_err": (ds_dev.double() - ref64).abs().max().item(), "max_rel_err": red_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "e2e_rel_err": e2e_err, "shape": [T, P, B]}
    fwd = {"name": "k1_collision_loglik_h2", "design": k1_design(model), "route": "cuda",
           "source": "vgpmp_torch/csrc/k1_collision.cuh",
           "replaces": "vgpmp_tpu/likelihoods/collision.py:76", "launches": launches["k1_loglik_h2"],
           "max_abs_err": err, "ms": ms_h2, "plain_ms": plain_h2_ms, "bound_ms": bh_ms, "bound_by": bh_by,
           "library_ms": None, "frozen_forward_ms": ms_frozen, "equal_to_frozen_forward": same_forward,
           "max_grad_err": gerr}
    if profiled is not None:
        profiled.append((f"(i) k1_dsigma [{B}, {P}] from h² [{P}, {T}]", "dsigma_kernel",
                         lambda: col.k1_dsigma(g2, h2, sigma), ms, dsig, "device_ms"))
    return dsig, fwd, {"session_s": t_sess, "solve_s": t_solve, "launches": launches, "finite": finite,
                       "elbo_first_mean": e[:, 0].mean().item(), "elbo_last_mean": e[:, -1].mean().item(),
                       "sigma_rel_change_max": s_rel.max().item(),
                       "sigma_rel_change_median": s_rel.median().item(),
                       "alpha_rel_change_max": a_rel.max().item(), "failed_rows": int(res.failed.sum()),
                       "no_contact_rows_in_check": no_contact}


def randomize_phase(torch, sess, cpu):
    """(j) ``randomize_timesteps``: the scored round of (e) (linear init, seed
    0, 200 steps at B = 36) with each row training on its own sorted uniform
    grid, and its verdicts against the CPU plain path."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik

    starts, goals = sess.queries()
    B = len(starts)
    cfg = dataclasses.replace(sess.train_config, randomize_timesteps=True)
    solve = solver.make_round_solver(sess.model, cfg)
    params = solver.init_batch(sess.model, starts, goals, sess.planner_params)
    k1_loglik.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, rep = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    launches = k1_loglik.launches
    st, gl = (torch.as_tensor(x, dtype=torch.float32) for x in (starts, goals))
    with torch.no_grad():
        ref = execute_and_validate(cpu.model.collision, best.cpu(), st, gl, cpu.model.limits_low,
                                   cpu.model.limits_high)
    counts = {k: int(getattr(rep, k).sum()) for k in ("executed", "success", "endpoints_ok", "limits_ok")}
    agree = {k: int((getattr(rep, k).cpu() == getattr(ref, k)).sum()) for k in ("executed", "success")}
    log(f"(j) randomize_timesteps round, B={B} steps={cfg.num_steps}: {t_round:.3f} s; of {B} rows: "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f"; verdicts agree with the CPU plain path on {agree}; K1 launches {launches}")
    assert torch.isfinite(best).all() and counts["endpoints_ok"] == B and counts["limits_ok"] == B, counts
    assert counts["executed"] >= 1 and min(agree.values()) >= B - 2, (counts, agree)
    assert launches >= cfg.num_steps, launches
    return {"round_s": t_round, "counts": counts, "agree_with_cpu": agree, "k1_launches": launches}


def velocity_grams(torch, robot: str, ps: str):
    """The velocity-constrained Grams of a combo's queries at the tuned
    init, ``[B·L, 2C+M, 2C+M]`` float64, and the columns of a training step's
    fused solve (S draws, N times and the mean)."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.session import PlanningSession

    s = PlanningSession(robot, ps, overrides={"velocity_constrained": True})
    starts, goals = s.queries()
    params = solver.init_batch(s.model, starts, goals, s.planner_params)
    with torch.no_grad():
        K, _ = planner._gram(s.model, planner.constrain(params, s.model.variance_lower))
    cols = s.model.num_samples + s.train_config.time_spacing_X + 1
    return K.reshape(-1, *K.shape[-2:]).contiguous(), cols


def velocity_phase(torch, sess, cpu, flush):
    """(k) the velocity-constrained GP (``velocity_constrained`` through the
    session overlay): K2's fused pair on the real velocity Grams (n = 14 at
    the bench's M = 10, n = 28 at franka/bookshelves' M = 24) against its
    plain version and timed, then a 200-step B = 36 solve, its endpoint
    clamps and its verdicts against the CPU plain path."""
    import numpy as np

    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import time_ms

    dev = sess.device
    gen = torch.Generator(device=dev).manual_seed(29)
    shapes = {}
    # tolerance: the real Grams' condition numbers reach ~1e10 at n = 28, so
    # two summation orders differ by up to ~1e-7 of the largest entry; held
    # to 1e-6, the existing K2 phase's bound on real Grams
    for label, (robot, ps) in (("n14", ("franka", "industrial")), ("n28", ("franka", "bookshelves"))):
        K, k = velocity_grams(torch, robot, ps)
        T, n = K.shape[0], K.shape[-1]
        Bm = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64)
        Lk, Xk = la.k2_factor_solve(K, Bm)
        Lp, Xp = la.factor_solve_plain(K, Bm)
        err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in ((Lk, Lp), (Xk, Xp)))
        assert torch.isfinite(Lk).all() and torch.isfinite(Xk).all(), f"K2 on velocity Grams {label}: NaN"
        assert err <= 1e-6, f"K2 fused pair on velocity Grams {label}: {err}"

        def library():
            Ll = torch.linalg.cholesky(K)
            return Ll, torch.linalg.solve_triangular(Ll, Bm, upper=False)

        b_ms, b_by = k2_bound("pair", T, n, k, 8, F64_FLOPS)
        shapes[label] = {"combo": f"{robot}/{ps}", "shape": [T, n, k], "max_rel_err": err,
                         "ms": time_ms(lambda: la.k2_factor_solve(K, Bm), flush=flush),
                         "plain_ms": time_ms(lambda: la.factor_solve_plain(K, Bm), flush=flush),
                         "library_ms": time_ms(library, flush=flush), "bound_ms": b_ms, "bound_by": b_by}
        log(f"(k) K2 fused pair on {robot}/{ps}'s velocity Grams [{T},{n},{n}] + [{T},{n},{k}]: "
            + json.dumps(shapes[label]))
        del K, Bm, Lk, Xk, Lp, Xp

    vsess = PlanningSession("franka", "industrial", overrides={"velocity_constrained": True})
    m, cfg = vsess.model, vsess.train_config
    assert m.velocity_constrained and m.num_inducing == 10
    starts, goals = vsess.queries()
    B = len(starts)
    params = solver.init_batch(m, starts, goals, vsess.planner_params)
    solve = solver.make_batch_solver(m, cfg)
    counters = (k1_loglik, la.k2_factor_solve, la.k2_factor_solve_bwd, la.k2_chol, la.k2_trsm)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, res = solve(params, starts, goals, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    # the extraction makes one fused forward and the posterior mean's three solves
    k2_per_step = (launches["k2_factor_solve"] - 1 + launches["k2_factor_solve_bwd"]) / cfg.num_steps
    e = res.elbo_history
    best = res.best.cpu().numpy()
    dt = 1.0 / (best.shape[1] - 1)
    v_mid = np.abs(np.diff(best, axis=1)).max(axis=(1, 2)) / dt
    v_start = np.abs(best[:, 1] - best[:, 0]).max(axis=1) / dt
    v_end = np.abs(best[:, -1] - best[:, -2]).max(axis=1) / dt
    bound = 0.35 * np.maximum(v_mid, 1e-6) + 0.05

    # one step's draw of the latent paths next to both ends, at the first step
    # and after training, held to the bounds of tests/test_velocity.py's clamp
    # test (positions 2e-2, velocities 0.12). Its one-sided difference over
    # h = 1e-3 reads f'(0) + h/2·f'', and the mean path of a real query bends
    # hard near the ends, so the velocity is read by the second-order
    # one-sided difference (error h²/3 times the third derivative); the
    # first-order one is recorded
    h = 1e-3
    X = torch.tensor([0.0, h, 2 * h, 1.0 - 2 * h, 1.0 - h, 1.0], device=dev)
    st = torch.as_tensor(starts, dtype=torch.float32, device=dev)
    gl = torch.as_tensor(goals, dtype=torch.float32, device=dev)

    def ends(p):
        with torch.no_grad():
            c = planner.constrain(p, m.variance_lower)
            q_lat = planner.query_latent(m, st, gl)
            _, _, f, _ = planner._draw_eval(m, c, planner._q_mu_full(m, c, q_lat), planner._kuf(m, c, X), X,
                                            m.num_samples, torch.Generator(device=dev).manual_seed(3), None)
        f, q_lat = f.double(), q_lat.double()
        big = lambda a, b: torch.maximum(a.abs(), b.abs()).max().item()
        return {"pos": big(f[:, :, 0] - q_lat[:, None, 0], f[:, :, 5] - q_lat[:, None, 1]),
                "vel": big((f[:, :, 1] - f[:, :, 0]) / h, (f[:, :, 5] - f[:, :, 4]) / h),
                "vel2": big((4 * f[:, :, 1] - 3 * f[:, :, 0] - f[:, :, 2]) / (2 * h),
                            (3 * f[:, :, 5] - 4 * f[:, :, 4] + f[:, :, 3]) / (2 * h))}

    first, after = ends(params), ends(trained)

    with torch.no_grad():
        rep = execute_and_validate(m.collision, res.best, st, gl, m.limits_low, m.limits_high)
        ref = execute_and_validate(cpu.model.collision, res.best.cpu(), st.cpu(), gl.cpu(),
                                   cpu.model.limits_low, cpu.model.limits_high)
    counts = {k: int(getattr(rep, k).sum()) for k in ("executed", "success", "endpoints_ok", "limits_ok")}
    agree = {k: int((getattr(rep, k).cpu() == getattr(ref, k)).sum()) for k in ("executed", "success")}
    rec = {"solve_s": t_solve, "elbo_first_mean": e[:, 0].mean().item(), "elbo_last_mean": e[:, -1].mean().item(),
           "failed_rows": int(res.failed.sum()), "launches": launches, "k2_launches_per_step": k2_per_step,
           "v_start_over_bound_max": float((v_start / bound).max()),
           "v_end_over_bound_max": float((v_end / bound).max()),
           "latent_ends_first_step": first, "latent_ends_trained": after,
           "counts": counts, "agree_with_cpu": agree, "k2_velocity_grams": shapes}
    log(f"(k) velocity-constrained solve, B={B} steps={cfg.num_steps} (Mc = {2 * 2 + m.num_inducing}): "
        f"{t_solve:.3f} s, ELBO mean {rec['elbo_first_mean']:.6g} -> {rec['elbo_last_mean']:.6g}, failed rows "
        f"{rec['failed_rows']}; K2 launches per step {k2_per_step:g}, launches {launches}; best's first / last "
        f"step over its bound (< 1): {rec['v_start_over_bound_max']:.3f} / {rec['v_end_over_bound_max']:.3f}; "
        f"latent draw at the ends (position error, velocity to second order (< 2e-2, 0.12), to first "
        f"order): first step {first['pos']:.3e}, {first['vel2']:.3e}, {first['vel']:.3e}; trained "
        f"{after['pos']:.3e}, {after['vel2']:.3e}, {after['vel']:.3e}; of {B} rows "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f"; verdicts agree with the CPU plain path on {agree}")
    assert torch.isfinite(e).all(), "velocity mode: non-finite ELBO"
    assert (v_start < bound).all() and (v_end < bound).all(), "velocity mode: an endpoint is not at rest"
    for r in (first, after):
        assert r["pos"] < 2e-2 and r["vel2"] < 0.12, f"velocity mode: the latent paths do not clamp: {r}"
    assert k2_per_step == 2 and launches["k2_chol"] == 0, f"velocity mode escalated: {launches}"
    assert launches["k1_loglik"] >= cfg.num_steps, launches
    assert min(agree.values()) >= B - 2, f"velocity verdicts disagree with the CPU plain path: {agree}"
    del vsess, trained, res
    torch.cuda.empty_cache()
    return rec


def resumable_phase(torch, sess):
    """(l) the 200-step B = 36 solve as 4 chunks of 50 steps, the state and
    the generator's written and read back between chunks, against one chunk
    of 200 from the same seed: ELBO history and best trajectories bit for
    bit. Where they are not, the largest differences are reported, the ops
    that PyTorch flags as nondeterministic on the first step are named, and
    the ELBO history is held to 1e-6 relative."""
    import tempfile
    import warnings

    from vgpmp_torch.engine import solver
    from vgpmp_torch.utils.checkpoint import restore_train_state, save_train_state

    dev = sess.device
    starts, goals = sess.queries()
    cfg = sess.train_config
    params = solver.init_batch(sess.model, starts, goals, sess.planner_params)
    init_state, train_chunk, extract = solver.make_resumable_solver(sess.model, cfg)

    def run(chunks, tmp=None):
        gen = torch.Generator(device=dev).manual_seed(6)
        state, hist = init_state(params, gen), []
        for i, n in enumerate(chunks):
            state, h, _ = train_chunk(state, starts, goals, gen, n=n)
            hist.append(h)
            if tmp is not None:
                path = Path(tmp) / f"chunk{i}.pt"
                save_train_state(path, state, gen)
                gen = torch.Generator(device=dev)
                state = restore_train_state(path, device=dev, generator=gen)
        hist = torch.cat(hist, dim=1)
        return hist, extract(state, starts, goals, gen, elbo_history=hist).best

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h1, b1 = run([cfg.num_steps])
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        h4, b4 = run([cfg.num_steps // 4] * 4, tmp)
        torch.cuda.synchronize()
        t_chunked = time.perf_counter() - t0
        ckpt_bytes = (Path(tmp) / "chunk0.pt").stat().st_size
    equal = bool(torch.equal(h1, h4) and torch.equal(b1, b4))
    rec = {"one_chunk_s": t_one, "four_chunks_s": t_chunked, "checkpoint_bytes": ckpt_bytes,
           "bit_equal": equal, "elbo_max_abs_diff": (h1 - h4).abs().max().item(),
           "elbo_max_rel_diff": ((h1 - h4).abs() / h1.abs()).max().item(),
           "best_max_abs_diff": (b1 - b4).abs().max().item()}
    if not equal:
        first = torch.nonzero((h1 != h4).any(dim=0)).flatten()
        rec["first_differing_step"] = int(first[0]) if len(first) else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            run([1])
            torch.use_deterministic_algorithms(False)
        rec["nondeterministic_ops"] = sorted({str(w.message).split(" does not")[0] for w in caught
                                              if "deterministic" in str(w.message)})
    log(f"(l) resumable: one chunk of {cfg.num_steps} steps {t_one:.3f} s, 4 chunks with a checkpoint "
        f"({ckpt_bytes} bytes) between them {t_chunked:.3f} s; bit for bit equal: {equal}; ELBO max |d| "
        f"{rec['elbo_max_abs_diff']:.3e} ({rec['elbo_max_rel_diff']:.3e} relative), best max |d| "
        f"{rec['best_max_abs_diff']:.3e}" + ("" if equal else f"; first differing step "
                                            f"{rec['first_differing_step']}, nondeterministic ops "
                                            f"{rec['nondeterministic_ops']}"))
    assert torch.isfinite(h1).all() and torch.isfinite(b1).all()
    assert equal or rec["elbo_max_rel_diff"] <= 1e-6, "chunked run differs from the one-shot run"
    return rec


def replan_phase(torch, sess):
    """(m) ``run_receding_horizon`` at B = 36: the tuned 200-step solve, then
    40-step warm-started replans, 3 cycles executing 20 waypoints each, with
    no disturbance and with 0.15 rad. Every cycle is timed (a synchronised
    wrapper of the replanner), and its executed prefix checked against its
    best trajectory."""
    from vgpmp_torch.engine import replan, solver
    from vgpmp_torch.likelihoods.collision import k1_loglik

    dev = sess.device
    starts, goals = sess.queries()
    B = len(starts)
    full = sess.train_config
    quick = dataclasses.replace(full, num_steps=40)
    cycles, advance, tol = 3, 20, 0.05
    made = replan.make_replanner
    rec = {}
    for noise_scale in (0.0, 0.15):
        cycle_s, bests, currents = [], [], []

        def timed(model, cfg, trainable=None):
            solve = made(model, cfg, trainable)

            def run(params, current, g, generator=None, noise=None):
                currents.append(current)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = solve(params, current, g, generator, noise)
                torch.cuda.synchronize()
                cycle_s.append(time.perf_counter() - t0)
                bests.append(out[1].best)
                return out

            return run

        params = solver.init_batch(sess.model, starts, goals, sess.planner_params)
        k1_loglik.launches = 0
        replan.make_replanner = timed
        try:
            t0 = time.perf_counter()
            res = replan.run_receding_horizon(sess.model, full, quick, params, starts, goals,
                                              torch.Generator(device=dev).manual_seed(8), cycles=cycles,
                                              advance=advance, goal_tol=tol, noise_scale=noise_scale)
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
        finally:
            replan.make_replanner = made
        path, T = res.executed, bests[0].shape[1]
        gap = 1 if noise_scale > 0 else 0
        prefix_ok, pos = True, 1
        for c, best in enumerate(bests):
            upto = T if c == cycles - 1 else advance + 1
            prefix_ok &= bool(torch.equal(path[:, pos:pos + upto - 1].nan_to_num(7.0),
                                          best[:, 1:upto].nan_to_num(7.0)))
            pos += upto - 1 + (gap if c < cycles - 1 else 0)
        st = torch.as_tensor(starts, dtype=path.dtype, device=dev)
        reached = int(res.reached_goal.sum())
        # a reached state on a joint limit (a disturbance clipped onto it, or
        # a float32 sigmoid that saturates there) puts that joint's latent
        # start at ±inf (the sigmoid's inverse), in JAX as here: the row's
        # later plans are NaN
        lo, hi = sess.model.limits_low, sess.model.limits_high
        on_limit = torch.zeros(B, dtype=torch.bool, device=dev)
        for cur in currents[1:]:
            on_limit |= ((cur == lo) | (cur == hi)).any(dim=1)
        nonfinite = ~torch.isfinite(path).flatten(1).all(dim=1)
        r = {"total_s": t_all, "cycle_s": cycle_s, "reached_goal": reached,
             "final_error_max_finite": res.final_error[~nonfinite].max().item(),
             "nonfinite_rows": int(nonfinite.sum()), "rows_reaching_a_joint_limit": int(on_limit.sum()),
             "path_shape": list(path.shape), "k1_launches": k1_loglik.launches,
             "elbo_last_mean_finite": res.elbo_last[~nonfinite].mean(dim=0).tolist()}
        rec[f"noise_{noise_scale}"] = r
        log(f"(m) receding horizon, B={B}, {cycles} cycles ({full.num_steps}, then {quick.num_steps} steps), "
            f"advance {advance}, noise {noise_scale}: {t_all:.3f} s, cycles "
            + ", ".join(f"{s:.3f}" for s in cycle_s) + f" s; reached goal {reached}/{B}, final error max "
            f"{r['final_error_max_finite']:.3e} over the finite rows; rows with a NaN path "
            f"{r['nonfinite_rows']}, rows whose reached state lies on a joint limit "
            f"{r['rows_reaching_a_joint_limit']}; path "
            f"{r['path_shape']}; K1 launches {r['k1_launches']}")
        assert pos == path.shape[1] and prefix_ok, "an executed prefix is not its cycle's best trajectory"
        assert torch.equal(path[:, 0], st), "the stitched path does not start at the starts"
        assert len(cycle_s) == cycles and not (nonfinite & ~on_limit).any(), "a NaN path without a cause"
        assert noise_scale > 0 or reached == int((~nonfinite).sum()), "a finite row missed its goal"
        assert bool((res.final_error[res.reached_goal] <= tol).all())
        assert k1_loglik.launches >= full.num_steps + (cycles - 1) * quick.num_steps
    return rec


def ensemble_phase(torch, sess, cpu):
    """(n) ``make_ensemble_solver`` over the overlay's 6 tuned inits at
    B = 36 (216 rows in one solve, one ``execute_and_validate``): the chosen
    inits against the argmax of ``ensemble_score`` over the members' reports
    recomputed by the CPU plain metric on the card's member trajectories."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance

    dev = sess.device
    starts, goals = sess.queries()
    B = len(starts)
    inits = tuple(sess.planner_params["q_mu_inits"])
    members = []
    validate = solver.execute_and_validate

    def recording(collision, best, *args):
        members.append(best)
        return validate(collision, best, *args)

    t0 = time.perf_counter()
    params = solver.init_ensemble(sess.model, starts, goals, sess.planner_params, inits)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    counters = (k1_loglik, k3_min_clearance, k3_probe_clearance)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    solve = solver.make_ensemble_solver(sess.model, sess.train_config, keep_member_reports=True)
    solver.execute_and_validate = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best, rep, chosen, reps_kb = solve(params, starts, goals, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
    finally:
        solver.execute_and_validate = validate
    peak = torch.cuda.max_memory_allocated()
    launches = {c.__name__: c.launches for c in counters}
    K = len(inits)
    st = torch.as_tensor(starts, dtype=torch.float32).repeat(K, 1)
    gl = torch.as_tensor(goals, dtype=torch.float32).repeat(K, 1)
    with torch.no_grad():
        ref = execute_and_validate(cpu.model.collision, members[0].cpu(), st, gl, cpu.model.limits_low,
                                   cpu.model.limits_high)
    ref_score = solver.ensemble_score(ref.executed, ref.success, ref.min_clearance).reshape(K, B)
    ref_chosen = torch.argmax(ref_score, dim=0)
    agree = int((ref_chosen == chosen.cpu()).sum())
    by_init = torch.bincount(chosen.cpu(), minlength=K).tolist()
    executed = int(rep.executed.sum())
    rec = {"inits": list(inits), "rows": K * B, "init_s": t_init, "solve_s": t_solve, "executed": executed,
           "success": int(rep.success.sum()), "members_executed": reps_kb.executed.sum(dim=1).tolist(),
           "chosen_by_init": by_init, "chosen_agree_with_cpu": agree, "peak_memory_bytes": peak,
           "launches": launches}
    log(f"(n) ensemble of {K} inits {list(inits)} at B={B} ({K * B} rows, {sess.train_config.num_steps} steps): "
        f"init {t_init:.3f} s, solve + metric {t_solve:.3f} s, peak memory {peak / 2**20:.1f} MiB; executed "
        f"{executed}/{B}, success {rec['success']}/{B}; executed per member {rec['members_executed']}; chosen "
        f"per init {by_init}; chosen equal to the CPU plain metric's argmax on {agree}/{B}; launches {launches}")
    assert best.shape == (B, sess.train_config.time_spacing_Xnew, 7) and torch.isfinite(best).all()
    assert len(members) == 1 and members[0].shape[0] == K * B
    assert agree == B, "a chosen init is not the argmax of the CPU plain metric's scores"
    assert torch.equal(rep.executed, reps_kb.executed.any(dim=0)), "executed is not 'some member executed'"
    assert launches["k3_min_clearance"] == 1 and launches["k3_probe_clearance"] == 1, launches
    assert launches["k1_loglik"] >= sess.train_config.num_steps, launches
    return rec


# (o): objects placed by the port's SceneBuilder (library names, and the boxes
# scene's grid as a grid object), at world positions in metres chosen where
# the straight-line paths of franka/industrial's 36 queries sweep, so that
# each of the five sources (the base grid, the boxes grid, the duck's sphere,
# the table's box, the pringles' capsule) attains the minimum at hinge-active
# spheres. The table's top (z 0.345-0.405) holds no sphere centre of a query's
# start or goal; the duck then moves to DUCK_MOVED.
OBJECTS = (("table", (0.9, 0.0, -0.25)), ("duck", (0.5, 0.3, 0.5)), ("pringles", (0.4, -0.4, 0.4)),
           ("boxes", (0.3, 0.5, 0.4)))
DUCK_MOVED = (0.45, -0.1, 0.45)


def object_session(s):
    """A ``SceneBuilder`` on the base grid of the session ``s`` holding
    OBJECTS, and franka/industrial's session on ``s``'s device and in its
    dtype with the built scene's extras."""
    from vgpmp_torch.robots import ASSET_DIR
    from vgpmp_torch.scene import SceneBuilder
    from vgpmp_torch.sdf.grid import SdfGrid
    from vgpmp_torch.session import PlanningSession

    dt = s.sdf.data.dtype
    b = SceneBuilder(base=s.sdf, base_offset=s.scene_offset, dtype=dt, device=s.device)
    for name, pos in OBJECTS:
        grid = (SdfGrid.load(ASSET_DIR / "scenes" / "boxes.npz", dt, device=s.device)
                if name == "boxes" else None)
        b.add_object(name, pos, grid=grid)
    sc = b.build()
    return b, PlanningSession("franka", "industrial", extra_grids=sc.extra_grids, extra_offsets=sc.extra_offsets,
                              primitives=sc.primitives, device=s.device, dtype=dt)


def object_sessions(sess, cpu):
    """:func:`object_session` of the card's session ``sess`` and of ``cpu``."""
    return [object_session(s) for s in (sess, cpu)]


def hinge_active_wins(torch, model, q):
    """Per source of ``model``'s scene, how many hinge-active sphere
    evaluations at the configs ``q`` it attains the minimum at (the plain
    lookups, K1's packed nearest cell)."""
    from vgpmp_torch.kinematics.dh import sphere_positions

    with torch.no_grad():
        names, ds = zip(*model.scene.sources(sphere_positions(model.fk, q)))
        d = torch.stack(ds)
        active = model.epsilon - (d.amin(0) - model.fk.sphere_radii) > 0
        win = d.argmin(0)[active]
        return {n: int((win == i).sum()) for i, n in enumerate(names)}


def objects_phase(torch, sess, cpu, flush):
    """(o) a scene with objects on the card: K1 and K3 on it against their
    plain versions (which source wins where, how many configs have a NaN d/dq
    from a sphere centre inside the table), the bench's adaptive solve on it
    at full width with its verdicts against the CPU plain metric on all 36
    rows, then ``move_object`` and a round that reads the new pose."""
    import numpy as np

    from vgpmp_torch import _build
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.models import vgpmp as planner

    t0 = time.perf_counter()
    (builder, osess), (cbuilder, ocpu) = object_sessions(sess, cpu)
    t_sessions = time.perf_counter() - t0
    model = osess.model.collision
    log(f"(o) scene with objects {[n for n, _ in OBJECTS]} at {[p for _, p in OBJECTS]}: sessions on the "
        f"card and the CPU {t_sessions:.2f} s; extras {model.tables.counts} (spheres, boxes, capsules), "
        f"grids {[tuple(g.shape) for g in osess.scene.extra_grids]}")
    wins = hinge_active_wins(torch, model, k1_inputs(torch, osess))
    log(f"    hinge-active sphere evaluations won, per source, at K1's inputs: {wins}")
    assert len(wins) == 5 and min(wins.values()) > 0, f"a source never attains the minimum: {wins}"
    k1o = k1_phase(torch, osess, flush, "[objects]")
    k3o, k3po = k3_phase(torch, osess, flush, "[objects]")
    assert k1o["nan_dq_configs"] > 0, "no config of K1's check has a sphere centre inside the table"

    # the bench's adaptive solve, counting the Adam steps that the per-row
    # guard skipped (on the device, read once) and plain log_prob calls on CUDA
    starts, goals = osess.queries()
    B = len(starts)
    inits = tuple(osess.planner_params["q_mu_inits"])
    round_solve = solver.make_round_solver(osess.model, osess.train_config)
    skipped = torch.zeros((), dtype=torch.int64, device=osess.device)
    adam_step, plain_log_prob, plain_on_cuda = solver.BatchedAdam.step, col.log_prob_plain, [0]

    def counting_step(self, params, grads):
        before = self.count
        out = adam_step(self, params, grads)
        skipped.add_((self.count == before).sum())
        return out

    def counting_plain(m, configs, sigma):
        plain_on_cuda[0] += int(configs.is_cuda)
        return plain_log_prob(m, configs, sigma)

    solver.BatchedAdam.step, col.log_prob_plain = counting_step, counting_plain
    counters = (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, reps, info = solver.solve_adaptive(osess.model, osess.train_config, starts, goals,
                                             osess.planner_params, inits=inits, max_rounds=8, seed=0,
                                             solve=round_solve, round_sizes=(B,))
    torch.cuda.synchronize()
    t_adaptive = time.perf_counter() - t0
    solver.BatchedAdam.step, col.log_prob_plain = adam_step, plain_log_prob
    launches = {c.__name__: c.launches for c in counters}
    n_skipped = int(skipped)
    executed, success = int(reps.executed.sum()), int(reps.success.sum())
    st, gl = (torch.as_tensor(x, dtype=torch.float32) for x in (starts, goals))
    with torch.no_grad():
        ref = execute_and_validate(ocpu.model.collision, torch.as_tensor(best), st, gl,
                                   ocpu.model.limits_low, ocpu.model.limits_high)
    agree = {k: int((getattr(reps, k) == getattr(ref, k).numpy()).sum()) for k in ("executed", "success")}
    steps = info["rounds"] * B * osess.train_config.num_steps
    log(f"    solve_adaptive, B={B}, inits {list(inits)}: {info['rounds']} rounds in {t_adaptive:.3f} s, "
        f"k_eff {info['k_eff']:.3f}; executed {executed}/{B}, success {success}/{B}; Adam steps skipped by "
        f"the guard (a NaN gradient) {n_skipped} of {steps} row-steps; launches {launches}, plain "
        f"log_prob on CUDA {plain_on_cuda[0]}; verdicts against the CPU plain metric: executed agrees on "
        f"{agree['executed']}/{B}, success on {agree['success']}/{B}")
    assert best.shape == (B, osess.train_config.time_spacing_Xnew, 7) and np.isfinite(best).all()
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"
    assert plain_on_cuda[0] == 0, "the plain log_prob ran on CUDA"
    assert agree == {"executed": B, "success": B}, f"verdicts disagree with the CPU plain metric: {agree}"

    # move the duck: the model's pose tables are rewritten in place, and the
    # next K1 launch reads the new pose (nothing rebuilt: the same extension
    # module, model and table storage)
    q = k1_inputs(torch, osess)
    sigma = torch.full((B, model.fk.sphere_radii.shape[0]), 0.005, device=osess.device)
    ext, ptrs = _build.load(), (model.tables.grid_f.data_ptr(), model.tables.prims.data_ptr())
    with torch.no_grad():
        before = model.log_prob(q, sigma)
        for b, s in ((builder, osess), (cbuilder, ocpu)):
            b.move_object("duck", DUCK_MOVED)
            s.model.collision.move_objects(b.build())
        after = model.log_prob(q, sigma)
        plain = col.log_prob_plain(model, q, sigma)
    torch.cuda.synchronize()
    same_storage = _build.load() is ext and ptrs == (model.tables.grid_f.data_ptr(),
                                                    model.tables.prims.data_ptr())
    changed = int((after != before).sum())
    far = (~torch.isclose(after, plain, rtol=1e-5, atol=1e-3)).float().mean().item()
    params = planner.init_params_batch(osess.model, starts, goals, [0] * B, 0.5 * (starts + goals),
                                       *(osess.planner_params[k] for k in
                                         ("lengthscales", "variance", "sigma_obs", "alpha")))
    col.k1_loglik.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mbest, mrep = round_solve(params, starts, goals, torch.Generator(device=osess.device).manual_seed(1))
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    with torch.no_grad():
        mref = execute_and_validate(ocpu.model.collision, mbest.cpu(), st, gl, ocpu.model.limits_low,
                                    ocpu.model.limits_high)
    magree = {k: int((getattr(mrep, k).cpu() == getattr(mref, k)).sum()) for k in ("executed", "success")}
    log(f"    move_object('duck', {DUCK_MOVED}): K1 values changed in {changed} of {after.numel()} configs, "
        f"other-voxel share against the plain version on the moved scene {far:.2e} (<= 1e-3); extension, "
        f"model and tables kept: {same_storage}; a round on the moved scene {t_round:.3f} s, {col.k1_loglik.launches} "
        f"K1 launches, executed {int(mrep.executed.sum())}/{B}, verdicts against the CPU plain metric "
        f"{magree}")
    assert changed > 0 and far <= 1e-3 and same_storage, "K1 did not read the moved duck"
    assert col.k1_loglik.launches > 0 and min(magree.values()) == B, magree
    return k1o, k3o, k3po, launches, {
        "objects": [list(o) for o in OBJECTS], "duck_moved": DUCK_MOVED, "sessions_s": t_sessions,
        "hinge_active_wins": wins, "adaptive_s": t_adaptive, "info": info, "executed": executed,
        "success": success, "skipped_row_steps": n_skipped, "row_steps": steps, "launches": launches,
        "plain_log_prob_on_cuda": plain_on_cuda[0], "agree_with_cpu": agree,
        "moved": {"k1_values_changed": changed, "other_voxel_share": far, "round_s": t_round,
                  "executed": int(mrep.executed.sum()), "agree_with_cpu": magree}}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _count_collectives(torch, in_step: dict):
    """Wrap ``all_reduce`` and ``broadcast`` of ``torch.distributed`` so that
    each call is recorded as ``(op, bytes, in a step's ELBO)``, the last read
    from ``in_step["on"]``; returns the list."""
    import torch.distributed as dist

    calls = []
    for name in ("all_reduce", "broadcast"):
        fn = getattr(dist, name)

        def counted(tensor, *args, _fn=fn, _name=name, **kw):
            calls.append((_name, tensor.numel() * tensor.element_size(), in_step["on"]))
            return _fn(tensor, *args, **kw)

        setattr(dist, name, counted)
    return calls


def _collective_summary(calls, steps: int) -> dict:
    """``{"<op> <bytes> B": count}`` of the whole solve, and of the Adam steps'
    ELBO collectives per step."""
    out: dict = {}
    per_step: dict = {}
    for op, nbytes, step in calls:
        key = f"{op} {nbytes} B"
        out[key] = out.get(key, 0) + 1
        if step:
            per_step[key] = per_step.get(key, 0) + 1 / steps
    return {"calls": out, "per_step": per_step,
            "bytes_per_step": sum(int(k.split()[1]) * v for k, v in per_step.items())}


def p2_rank_main(argv) -> int:
    """One rank of phase (p2), started by :func:`parallel_phase` as
    ``chip_smoke.py --p2-rank RANK PORT BACKEND DEVICE OUT``: a dp = 2 solve,
    then a dp = 1 x sp = 2 solve, at the bench's configuration; writes
    ``OUT/rank<RANK>.npz``."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path[:0] = [str(ROOT)]
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods.collision import k1_loglik
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.parallel import init_distributed, make_mesh, make_sharded_solver
    from vgpmp_torch.session import PlanningSession

    rank, port, backend, device, out_dir = int(argv[0]), argv[1], argv[2], argv[3], Path(argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend, device)
    sess = PlanningSession("franka", "industrial", device=device)
    starts, goals = sess.queries()
    cfg, B = sess.train_config, len(starts)
    params = solver.init_batch(sess.model, starts, goals, sess.planner_params)
    in_step = {"on": False}
    calls = _count_collectives(torch, in_step)
    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd)
    out = {}
    sample_mean = planner.sample_mean
    averaged = []  # each step's averaged likelihood, hashed after the timed solve

    def recording(x, group):
        in_step["on"] = True
        y = sample_mean(x, group)
        in_step["on"] = False
        averaged.append(y.detach().clone())
        return y

    planner.sample_mean = recording
    for name, sp in (("dp2", 1), ("sp2", 2)):
        mesh = make_mesh(sp, device=device)
        solve = make_sharded_solver(sess.model, cfg, mesh)
        seconds = []
        for _ in range(2):  # the first call of a process loads its kernels; the second is timed alike
            calls.clear()
            averaged.clear()
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, metrics = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out[f"{name}_s"] = np.array(seconds)
        out[f"{name}_collectives"] = json.dumps(_collective_summary(calls, cfg.num_steps))
        out[f"{name}_launches"] = json.dumps({c.__name__: c.launches for c in counters})
        out[f"{name}_best"] = res.best.cpu().numpy()
        out[f"{name}_elbo_history"] = res.elbo_history.cpu().numpy()
        out[f"{name}_success"] = metrics["success"].cpu().numpy()
        out[f"{name}_metrics"] = json.dumps({k: float(v) for k, v in metrics.items() if v.ndim == 0})
        out[f"{name}_lik_mean_sha256"] = np.array([hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
                                                    for y in averaged])
        with torch.no_grad():
            rep = execute_and_validate(sess.model.collision, res.best,
                                       torch.as_tensor(starts, dtype=torch.float32, device=sess.device),
                                       torch.as_tensor(goals, dtype=torch.float32, device=sess.device),
                                       sess.model.limits_low, sess.model.limits_high)
        out[f"{name}_executed"] = rep.executed.cpu().numpy()
        out[f"{name}_validated"] = rep.success.cpu().numpy()
    out["backend"] = np.array(dist.get_backend())
    np.savez(out_dir / f"rank{rank}.npz", B=B, **out)
    dist.destroy_process_group()
    return 0


def parallel_phase(torch, sess, cpu, adaptive):
    """(p) the parallel layer (``vgpmp_torch.parallel``) at the bench's
    configuration.

    (p1) a world of one over NCCL on this card: ``make_sharded_solver`` at
    dp = sp = 1 against ``make_batch_solver`` from the same seed (bit for bit;
    its success count against the validator's), both timed; the cost of the
    whole-batch draw each rank makes; ``make_sharded_round_solver`` as
    ``solve_adaptive``'s ``solve=`` against (g)'s rounds, k_eff and executed
    rows. (p2) two ranks as processes (one a card over NCCL where there are
    two cards, else both on this card over gloo): dp = 2 against (p1), then
    dp = 1 x sp = 2 (both ranks' best trajectory and every step's averaged
    likelihood bit-equal, verdicts against the CPU plain path), the
    collectives counted; then ``tools/launch_multihost_torch.py``."""
    import numpy as np
    import torch.distributed as dist

    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate, validate_trajectory
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.parallel import make_mesh, make_sharded_round_solver, make_sharded_solver
    from vgpmp_torch.parallel.sharded import draw_rows
    from vgpmp_torch.timing import time_ms

    starts, goals = sess.queries()
    cfg, model, B = sess.train_config, sess.model, len(starts)
    params = solver.init_batch(model, starts, goals, sess.planner_params)
    gen = lambda seed: torch.Generator(device=sess.device).manual_seed(seed)
    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd, k3_min_clearance,
                k3_probe_clearance)
    rec = {}

    # (p1)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device=sess.device)
        batch = solver.make_batch_solver(model, cfg)
        solvers = {"batch": lambda *a: (None, batch(*a)[1]),
                   "sharded": make_sharded_solver(model, cfg, mesh),
                   "sharded_unvalidated": make_sharded_solver(model, cfg, mesh, validate=False)}
        times, runs = {}, {}
        # in turns, so that the host's drift within the call falls on each alike
        for name in ("batch", "sharded", "sharded_unvalidated", "batch", "sharded_unvalidated", "sharded") * 2:
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name] = solvers[name](params, starts, goals, gen(0))
            torch.cuda.synchronize()
            times.setdefault(name, []).append(time.perf_counter() - t0)
            if name == "sharded":
                sharded_launches = {c.__name__: c.launches for c in counters}
        res, metrics = runs["sharded"]
        want = runs["batch"][1]
        bits = lambda x: x.contiguous().view(torch.int32)
        equal = {"best": torch.equal(bits(res.best), bits(want.best)),
                 "elbo_history": torch.equal(bits(res.elbo_history), bits(want.elbo_history))}
        with torch.no_grad():
            vrep = validate_trajectory(model.collision, want.best,
                                       torch.as_tensor(starts, dtype=torch.float32, device=sess.device),
                                       torch.as_tensor(goals, dtype=torch.float32, device=sess.device),
                                       model.limits_low, model.limits_high)
        n_success, n_valid = float(metrics["success_rate"] * metrics["num_problems"]), int(vrep.success.sum())
        t_draw = time_ms(lambda: draw_rows(model, model.num_samples, False, B, slice(0, B // 2), gen(1)))
        t_half = time_ms(lambda: draw_rows(model, model.num_samples, False, B // 2, slice(0, B // 2), gen(1)))
        log(f"(p1) world of one over {dist.get_backend()} on {sess.device}: make_sharded_solver "
            f"{min(times['sharded']):.3f} s (runs {times['sharded']}), without its validation "
            f"{min(times['sharded_unvalidated']):.3f} s (runs {times['sharded_unvalidated']}), make_batch_solver "
            f"{min(times['batch']):.3f} s (runs {times['batch']}); bit-equal {equal}; success "
            f"{n_success:.0f} of {B}, validator {n_valid}; sharded launches {sharded_launches}; a step's "
            f"whole-batch draw ({B} rows) {t_draw:.4f} ms against {t_half:.4f} ms for a {B // 2}-row draw")
        assert all(equal.values()), f"the world-of-one solve differs from make_batch_solver: {equal}"
        assert n_success == n_valid, (n_success, n_valid)
        assert all(sharded_launches[c.__name__] > 0 for c in counters[:4]), sharded_launches

        round_solvers = {"sharded": make_sharded_round_solver(model, cfg, mesh),
                         "unsharded": solver.make_round_solver(model, cfg)}
        t_rounds = {}
        for name in ("sharded", "unsharded", "unsharded", "sharded"):
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best_a, reps_a, info = solver.solve_adaptive(model, cfg, starts, goals, sess.planner_params,
                                                         inits=tuple(sess.planner_params["q_mu_inits"]),
                                                         max_rounds=8, seed=0, solve=round_solvers[name],
                                                         round_sizes=(B,))
            t_rounds.setdefault(name, []).append(time.perf_counter() - t0)
            if name == "sharded":
                round_launches = {c.__name__: c.launches for c in counters}
        t_adaptive = min(t_rounds["sharded"])
        same = {"rounds": info["rounds"] == adaptive["info"]["rounds"],
                "k_eff": info["k_eff"] == adaptive["info"]["k_eff"],
                "executed_rows": reps_a.executed.tolist() == adaptive["executed_rows"]}
        log(f"    make_sharded_round_solver in solve_adaptive: {info['rounds']} rounds, k_eff "
            f"{info['k_eff']:.3f}, executed {int(reps_a.executed.sum())}/{B} in {t_adaptive:.3f} s (runs "
            f"{t_rounds['sharded']}; make_round_solver in turns with it {t_rounds['unsharded']}, "
            f"in (g) {adaptive['adaptive_s']:.3f} s); equal to (g): {same}; launches {round_launches}")
        assert all(same.values()), f"the sharded adaptive run differs from (g): {same}"
        assert all(v > 0 for v in round_launches.values()), round_launches
    finally:
        dist.destroy_process_group()
    rec["p1"] = {"sharded_s": times["sharded"], "batch_s": times["batch"],
                 "sharded_unvalidated_s": times["sharded_unvalidated"], "bit_equal": equal,
                 "success": n_success, "validator_success": n_valid, "launches": sharded_launches,
                 "draw_ms_whole_batch": t_draw, "draw_ms_half_batch": t_half,
                 "adaptive_s": t_rounds["sharded"], "adaptive_unsharded_s": t_rounds["unsharded"],
                 "adaptive_g_s": adaptive["adaptive_s"], "adaptive_info": info,
                 "adaptive_equal_to_g": same, "adaptive_launches": round_launches}

    # (p2)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    devices = ["cuda:0", "cuda:1"] if cards >= 2 else ["cuda:0", "cuda:0"]
    out_dir = ROOT / "chiprun_out" / "p2"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--p2-rank", str(r), str(port),
                               backend, devices[r], str(out_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            stdout, _ = p.communicate(timeout=420)
            assert p.returncode == 0, f"(p2) rank {r} exited {p.returncode}:\n{stdout[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_ranks = time.perf_counter() - t0
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]
    p1_best = res.best.cpu().numpy()
    p1_success = metrics["success"].cpu().numpy()
    dp_best = ranks[0]["dp2_best"]
    dp_err = float(np.abs(dp_best - p1_best).max())
    dp_bits = bool(np.array_equal(dp_best.view(np.int32), p1_best.view(np.int32)))
    dp_agree = int((ranks[0]["dp2_success"] == p1_success).sum())
    ranks_same = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ("dp2_best", "dp2_success", "sp2_best"))
    sp_best = ranks[0]["sp2_best"]
    lik_equal = bool(np.array_equal(ranks[0]["sp2_lik_mean_sha256"], ranks[1]["sp2_lik_mean_sha256"]))
    with torch.no_grad():
        ref = execute_and_validate(cpu.model.collision, torch.as_tensor(sp_best),
                                   torch.as_tensor(starts, dtype=torch.float32),
                                   torch.as_tensor(goals, dtype=torch.float32),
                                   cpu.model.limits_low, cpu.model.limits_high)
    sp_agree = {"executed": int((ranks[0]["sp2_executed"] == ref.executed.numpy()).sum()),
                "success": int((ranks[0]["sp2_validated"] == ref.success.numpy()).sum())}
    coll = {n: json.loads(str(ranks[0][f"{n}_collectives"])) for n in ("dp2", "sp2")}
    log(f"(p2) two ranks over {ranks[0]['backend']} on {devices} ({t_ranks:.1f} s with start-up): "
        f"dp = 2 solve, first / second call, rank 0 {ranks[0]['dp2_s'].tolist()} s, rank 1 "
        f"{ranks[1]['dp2_s'].tolist()} s; verdicts equal "
        f"(p1)'s on {dp_agree}/{B}; max |d best| against (p1) {dp_err:.3e} rad, bit-equal {dp_bits}; "
        f"launches {str(ranks[0]['dp2_launches'])}; collectives {coll['dp2']['calls']}")
    log(f"    dp = 1 x sp = 2 solve, rank 0 {ranks[0]['sp2_s'].tolist()} s, rank 1 {ranks[1]['sp2_s'].tolist()} s; best "
        f"finite {bool(np.isfinite(sp_best).all())}, identical on both ranks {ranks_same}; averaged "
        f"likelihood bit-equal on both ranks in all {len(ranks[0]['sp2_lik_mean_sha256'])} calls {lik_equal}; "
        f"executed {int(ranks[0]['sp2_executed'].sum())}/{B}, verdicts against the CPU plain path {sp_agree}; "
        f"collectives per step {coll['sp2']['per_step']} ({coll['sp2']['bytes_per_step']} B), all "
        f"{coll['sp2']['calls']}; launches {str(ranks[0]['sp2_launches'])}")
    assert dp_agree == B, f"dp = 2 verdicts differ from (p1)'s: {dp_agree}/{B}"
    assert dp_err <= 1e-5, f"dp = 2 best trajectories differ from (p1)'s by {dp_err}"
    assert ranks_same and lik_equal, "the ranks disagree"
    assert np.isfinite(sp_best).all() and np.isfinite(ranks[0]["sp2_elbo_history"]).all()
    assert len(ranks[0]["sp2_lik_mean_sha256"]) == sess.train_config.num_steps
    assert min(sp_agree.values()) >= B - 2, f"sp = 2 verdicts disagree with the CPU plain path: {sp_agree}"

    t0 = time.perf_counter()
    launch = subprocess.run([sys.executable, str(ROOT / "tools" / "launch_multihost_torch.py"), "--processes", "2",
                             "--device", "cuda", "--backend", backend, "--timeout", "420",
                             "--json-out", str(ROOT / "chiprun_out" / "launch_multihost_torch.json")],
                            capture_output=True, text=True, timeout=900)
    assert launch.returncode == 0, launch.stdout[-2000:] + launch.stderr[-4000:]
    multihost = json.loads(launch.stdout.strip().splitlines()[-1])
    log(f"    tools/launch_multihost_torch.py --processes 2 --device cuda --backend {backend} "
        f"({time.perf_counter() - t0:.1f} s with start-up): {json.dumps(multihost)}")
    assert multihost["num_problems"] == B and multihost["num_processes"] == 2
    rec["p2"] = {"backend": str(ranks[0]["backend"]), "devices": devices, "ranks_s": t_ranks,
                 "dp2_s": [r["dp2_s"].tolist() for r in ranks], "sp2_s": [r["sp2_s"].tolist() for r in ranks],
                 "dp2_verdicts_equal_p1": dp_agree, "dp2_max_abs_err_vs_p1": dp_err, "dp2_bit_equal": dp_bits,
                 "sp2_identical_on_ranks": ranks_same, "sp2_lik_mean_bit_equal": lik_equal,
                 "sp2_executed": int(ranks[0]["sp2_executed"].sum()), "sp2_agree_with_cpu": sp_agree,
                 "collectives": coll, "launches": {n: json.loads(str(ranks[0][f"{n}_launches"]))
                                                   for n in ("dp2", "sp2")},
                 "metrics": {n: json.loads(str(ranks[0][f"{n}_metrics"])) for n in ("dp2", "sp2")},
                 "multihost": multihost}
    return rec


def diagnose_phase(torch):
    """(u) mesh -> SDF, after (t): ``vgpmp_torch.sdf.gen.mesh_to_sdf`` on a
    synthetic mesh with the industrial scene mesh's counts (23 closed convex
    pieces, boxes and fan-capped prisms, overlapping, 422 triangles; made
    from seed 0 by ``synthetic_mesh``) at the industrial grid's voxel edge
    and a padding of 25 cells: 337 x 401 x 205 cells, voxelized by K5
    (``csrc/k5_mesh_sdf.cuh``) and held against ``sdf_grid_plain`` on the
    card (1e-6 m, the sign bit equal in every cell), timed beside the plain
    version and the bound; then the grid as an object of a franka/industrial
    session (``SceneBuilder.add_object(..., grid=...)``): a 20-step solve and
    a scored round of 20 steps through the composed K1 and K3, every row
    finite.

(v) the RFF prior's paths, after (u): K6 (``csrc/k6_rff.cuh``) at wam's and
    franka's round-0 shapes (1 024 x 7 x (26 + 70) and 512 x 7 x (12 + 50)
    points x 1 024 bases, S 7 and 20), forward and forward with backward,
    against the plain chain on the card (L2 flushed, 20 calls) and the
    bound of ``benchmark/work/rff.py``'s count; the paths and the gradients
    of x, ω and the scale against the float64 plain chain; the peak memory
    of one step of each cell's configuration at its rows, plain chain and
    K6; a 3-step solve with extraction through K6, none of the plain chain
    on the card (``k6_rff.plain_on_card``).

(q) ``tools/diagnose_failures_torch.py`` on wam/industrial, seed 0, 3
    adaptive rounds: one row for each problem not executed, each classed, and
    the failure profile on the card against the CPU plain path on the same
    trajectories (the failures' and the first two rows')."""
    import numpy as np

    import diagnose_failures_torch as diag
    from vgpmp_torch.engine.validator import densify
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.likelihoods.collision import k1_loglik, k3_min_clearance, k3_probe_clearance
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.sdf.grid import _packed_flat_index
    from vgpmp_torch.session import PlanningSession

    counters = (k1_loglik, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd, k3_min_clearance,
                k3_probe_clearance)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, best, sess = diag.run("wam", "industrial", seed=0, adaptive_rounds=3)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    cpu = PlanningSession("wam", "industrial", device="cpu")
    starts, goals = sess.queries()
    failed = [r["problem"] for r in result["failures"]]

    def profile_and_cells(s, i):
        col = s.model.collision
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=s.device)
        traj, q_s, q_g = as_t(best[i]), as_t(starts[i]), as_t(goals[i])
        prof = diag.failure_profile(col, traj, q_s, q_g, 0.5)
        with torch.no_grad():
            cells = [_packed_flat_index(col.scene.base_packed, sphere_positions(col.fk, q) - col.scene.base_offset)
                     for q in (densify(traj, 8), torch.stack([q_s, q_g]))]
        return [v.cpu().numpy().astype(np.float64) for v in prof], [c.cpu().numpy() for c in cells]

    # the training lookup is the packed nearest cell: a sphere centre a float32
    # rounding from a cell face may land in the neighbouring cell, so the
    # clearances and violations of such configs (and of every config of a row
    # whose endpoints do) are left out and counted; the rest, and every
    # quantity that is plain arithmetic, are held to 1e-5
    err, other, n_cfg = 0.0, 0, 0
    for i in sorted(set(failed) | {0, 1}):
        (pc, cc), (pd, cd) = profile_and_cells(cpu, i), profile_and_cells(sess, i)
        viol, clear, dist_s, dist_g, d_s, d_g, end_err = zip(pd, pc)
        same = (cd[0] == cc[0]).all(axis=-1)
        ends_same = bool((cd[1] == cc[1]).all())
        other += int((~same).sum()) + (0 if ends_same else 2)
        n_cfg += same.size + 2
        pairs = [dist_s, dist_g, end_err, (clear[0][same], clear[1][same])]
        if ends_same:
            pairs += [d_s, d_g, (viol[0][same], viol[1][same])]
        for a, b in pairs:
            # NaN where both devices give NaN counts as agreement, on one only as a miss
            d = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
            err = max(err, float(np.nan_to_num(d, nan=np.inf).max(initial=0.0)))
    rec = {"robot": "wam", "env": "industrial", "seed": 0, "executed": result["executed"],
           "problems": result["problems"], "k_eff": result["k_eff"],
           "classes": [r["class"] for r in result["failures"]], "failed": failed,
           "profile_max_abs_err": err, "profile_other_cell": other, "profile_configs": n_cfg,
           "launches": launches, "run_s": t_run}
    log(f"(q) diagnose_failures_torch wam/industrial seed 0: {result['executed']}/{result['problems']} executed, "
        f"k_eff {result['k_eff']:.2f}, {t_run:.1f} s; failures {list(zip(failed, rec['classes']))}; profile on "
        f"the card vs CPU plain path: max abs err {err:.2e} (<= 1e-5) over {n_cfg} configs, {other} in another "
        f"cell; launches {launches}")
    assert result["problems"] == 36 and len(failed) == 36 - result["executed"]
    assert all(r["class"] in diag.CLASSES for r in result["failures"])
    assert err <= 1e-5, "the failure profile disagrees with the CPU plain path"
    assert other <= 1e-2 * n_cfg, "too many configs in another cell than on the CPU"
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"
    return rec


def scaling_phase(torch):
    """(r) ``tools/batch_scaling_torch.py`` at B = 36 and 256, one steady
    call each, one child process a size: no failed size, a finite peak, and
    every kernel of the batched solve and the metric launched in each child."""
    import math

    import batch_scaling_torch as scaling

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = scaling.sweep("franka", "industrial", [36, 256], 1, ROOT / "chiprun_out" / "smoke_scaling.json")
    rec["run_s"] = time.perf_counter() - t0
    rows = rec["rows"]
    log(f"(r) batch_scaling_torch franka/industrial, sizes 36 and 256, 1 rep ({rec['run_s']:.1f} s with the "
        f"children's start-up): " + "; ".join(
            f"B={r['batch']}: " + ("FAILED" if r.get("failed") else
                                   f"{r['steady_seconds']:.3f} s, {r['solves_per_sec']:.2f} solves/s, peak "
                                   f"{r['peak_memory_bytes']} B, executed {r['executed_share']:.4f}, "
                                   f"launches {r['launches']}") for r in rows))
    assert [r["batch"] for r in rows] == [36, 256] and not any(r.get("failed") for r in rows), rows
    assert all(r["peak_memory_bytes"] is not None and math.isfinite(r["peak_memory_bytes"])
               and r["peak_memory_bytes"] > 0 for r in rows), "no finite peak memory"
    for r in rows:
        missing = [k for k, v in r["launches"].items() if k != "k2_chol" and v == 0]
        assert not missing, f"B={r['batch']}: not launched: {missing}"
    return rec


def breakdown_phase(torch):
    """(s) ``tools/profile_breakdown_torch.py`` at B = 36, 10 calls a stage,
    in a process of its own (a profiler window slows every later launch of
    its process): every stage's device ms > 0, K1 among the ``log_prob``
    stages' kernels, and K1 and K2's pair launched."""
    out = ROOT / "chiprun_out" / "smoke_profile_breakdown.json"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # 10 calls a stage (the tool's default is 50): the profiled FK stages make
    # ~1 300 launches a call, and 50 of them took 142 s of the smoke
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "profile_breakdown_torch.py"), "--batch", "36",
                           "--reps", "10", "--json-out", str(out)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    rec = json.loads(out.read_text())
    rec["run_s"] = time.perf_counter() - t0
    log(f"(s) profile_breakdown_torch franka/industrial B=36 ({rec['run_s']:.1f} s with start-up), stream / "
        f"device ms and launches per call:")
    for name, ms in rec["stages_ms"].items():
        log(f"  {name:<42s} {ms:9.4f} / {rec['stages_device_ms'][name]:9.4f} ms, "
            f"{rec['stages_launches'][name]:7.1f} launches")
    assert all(v > 0 for v in rec["stages_device_ms"].values()), rec["stages_device_ms"]
    for name in ("FK+SDF+hinge log_prob fwd", "FK+SDF+hinge log_prob fwd+bwd"):
        assert any("loglik_tile_kernel" in k["name"] for k in rec["stages_kernels"][name]), name
    kl = rec["kernel_launches"]
    assert all(kl[k] > 0 for k in ("k1_loglik", "k2_factor_solve", "k2_factor_solve_bwd")), kl
    return rec


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


def kernel_profile_phase(torch, sess, k2, k4, reps: int = 20, profiled=()):
    """A third ``torch.profiler`` window, the last of the run: the device-only
    duration (CUPTI) of ``k2_chol`` at [251, 12, 12], ``k2_trsm`` at the main
    path's [251, 12, 1] and [251, 12, 100], lower and transposed, K4 at one
    point, and the ``profiled`` cases of (i) and (t1) (``k1_dsigma``,
    K1-trilinear: ``(label, kernel, fn, event ms, row, key)``, the device ms
    written to ``row[key]``), each launched ``reps`` times after an L2 flush,
    beside their event-timed ms, which include the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.ops.gather import k4_gather
    from vgpmp_torch.timing import l2_flush_buffer

    dev = sess.device
    gen = torch.Generator(device=dev).manual_seed(23)
    T, n = 251, 12
    G = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64)
    K = G @ G.mT + n * torch.eye(n, device=dev, dtype=torch.float64)
    L = la.k2_chol(K)
    B1, B100 = (torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64) for k in (1, 100))
    table = torch.arange(1024, dtype=torch.int32, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    trsm = k2[1]["by_k"]
    cases = [("k2_chol [251,12,12]", "chol_kernel", lambda: la.k2_chol(K), k2[0]["ms"]),
             ("k2_trsm [251,12,1] lower", "trsm_kernel", lambda: la.k2_trsm(L, B1, False), trsm[1]["ms"]),
             ("k2_trsm [251,12,1] upper_t", "trsm_kernel", lambda: la.k2_trsm(L, B1, True),
              trsm[1]["upper_t_ms"]),
             ("k2_trsm [251,12,100] lower", "trsm_kernel", lambda: la.k2_trsm(L, B100, False),
              trsm[100]["ms"]),
             ("k2_trsm [251,12,100] upper_t", "trsm_kernel", lambda: la.k2_trsm(L, B100, True),
              trsm[100]["upper_t_ms"]),
             ("k4_gather at one point", "gather_kernel", lambda: k4_gather(table, one), k4["timer_floor_ms"])]
    cases += [c[:4] for c in profiled]
    rows = {c[0]: c[4:] for c in profiled}
    flush = l2_flush_buffer(dev)
    rec = {}
    for label, kernel, fn, event_ms in cases:
        # a window that drops kernel records (PERF.md §7: a profiler window on
        # the card has lost some or all of them, with acc_events=True too) is
        # taken again, at most twice; the device time comes from a window
        # that holds every launch
        for attempt in range(3):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation and kernel in e.key]
            count = sum(e.count for e in ev)
            if count == reps:
                break
            log(f"(d) the profile of {label} dropped records: {count} launches of {kernel} of {reps}")
        device_ms = sum(e.self_device_time_total for e in ev) / 1e3 / max(count, 1)
        rec[label] = {"device_ms": device_ms, "event_ms": event_ms, "launches": count, "windows": attempt + 1}
        log(f"(d) device-only {label}: {device_ms:.4f} ms a launch over {count} launches (event-timed "
            f"{event_ms:.4f} ms with the launch)")
        assert count == reps, f"the profile of {label} shows {count} launches of {kernel}, not {reps}"
        if label in rows:
            row, key = rows[label]
            row[key] = device_ms
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


# ---------------------------------------------------------------- (t) the CUDA envelope


def mode_model(sess, mode: str):
    """The session's collision model with its scene looked up in ``mode``
    (``nearest`` or ``trilinear``: the unpacked grid of the session's dtype)."""
    from vgpmp_torch.likelihoods.collision import CollisionModel

    c = sess.model.collision
    sc = dataclasses.replace(sess.scene, mode=mode, base_packed=None, extra_packed=())
    return CollisionModel(fk=c.fk, scene=sc, epsilon=c.epsilon)


def dsigma_check(torch, model, q, label):
    """K1's d/dσ in ``model``'s mode: the forward that writes h², then
    ``k1_dsigma`` against the float64 sum of the same terms (1e-5 of
    Σ|g|h²/(2σ²): float32 sums of ~1 000 terms in another order), and end to
    end through autograd against the plain version, configs whose value
    differs (a sphere in a neighbouring cell) weighted 0 (1e-4 of the same
    scale). Returns the two relative errors."""
    from vgpmp_torch.likelihoods import collision as col

    B, S, N, L = q.shape
    P = model.fk.sphere_radii.shape[0]
    gen = torch.Generator(device=q.device).manual_seed(19)
    sigma = (0.003 + 0.005 * torch.rand((B, P), generator=gen, device=q.device)).to(q.dtype)
    g = torch.randn((B, S, N), generator=gen, device=q.device).to(q.dtype)
    q2 = q.reshape(-1, L)
    _, _, h2 = col.k1_loglik(model, q2, sigma, True, True)
    ds = col.k1_dsigma(g.reshape(-1), h2, sigma)
    ref = col.dsigma_plain(g.reshape(-1).double(), h2.double(), sigma.double())
    scale = col.dsigma_plain(g.reshape(-1).abs().double(), h2.double(), sigma.double()).clamp(min=1e-30)
    red = ((ds.double() - ref).abs() / scale).max().item()
    with torch.no_grad():
        w = g * torch.isclose(model.log_prob(q, sigma), col.log_prob_plain(model, q, sigma),
                              rtol=1e-5, atol=1e-3)
    out = []
    for fn in (model.log_prob, lambda a, b: col.log_prob_plain(model, a, b)):
        s = sigma.clone().requires_grad_()
        out.append(torch.autograd.grad((w * fn(q, s)).sum(), s)[0])
    e2e = ((out[0] - out[1]).abs().double() / scale).max().item()
    log(f"K1{label} d/dσ: reduction vs float64 {red:.2e} of the absolute sum (<= 1e-5), end to end vs "
        f"the plain version {e2e:.2e} (<= 1e-4)")
    assert red <= 1e-5 and e2e <= 1e-4, f"K1{label} d/dσ disagrees with the plain version"
    return red, e2e


def grid_modes_phase(torch, sess, flush, profiled=None):
    """(t1) K1's nearest-cell and trilinear lookups on the real
    franka/industrial float32 grid at 36 000 configs x 37 spheres, against
    the plain version (value, d/dq and d/dσ), timed beside it and the bound
    by sectors. ``profiled`` (a list) gets K1-trilinear's cases, with d/dq
    and forward only, for the last profiler window
    (:func:`kernel_profile_phase`)."""
    from vgpmp_torch.likelihoods import collision as col

    rows = {}
    q = k1_inputs(torch, sess)
    for mode in ("nearest", "trilinear"):
        model = mode_model(sess, mode)
        rows[mode] = k1_phase(torch, sess, flush, f"[{mode}]", model=model)
        rows[mode]["dsigma_rel_err"], rows[mode]["dsigma_e2e_rel_err"] = dsigma_check(
            torch, model, q, f"[{mode}]")
    if profiled is not None:
        tri, q2 = rows["trilinear"], q.reshape(-1, q.shape[-1])
        model = mode_model(sess, "trilinear")
        sigma = torch.full((q.shape[0], model.fk.sphere_radii.shape[0]), 0.005, dtype=q.dtype, device=q.device)
        for grad, event_ms, key in ((True, tri["ms"], "device_ms"),
                                    (False, tri["ms_forward_only"], "device_ms_forward_only")):
            profiled.append((f"(t1) K1-trilinear {'fwd + d/dq' if grad else 'fwd only'} [{q2.shape[0]} x "
                             f"{sigma.shape[1]}]", "loglik_tile_kernel",
                             lambda grad=grad: col.k1_loglik(model, q2, sigma, grad), event_ms, tri, key))
    return rows


def _capture_validate(captured):
    """``engine.validator.execute_and_validate`` wrapped so that each call's
    trajectories and report are kept in ``captured``; returns the original."""
    from vgpmp_torch.engine import validator

    orig = validator.execute_and_validate

    def capture(collision, best, sb, gb, lo, hi, *args, **kw):
        rep = orig(collision, best, sb, gb, lo, hi, *args, **kw)
        captured.append((best.detach().clone(), sb, gb, rep))
        return rep

    validator.execute_and_validate = capture
    return orig


def _count_k1(calls):
    """``likelihoods.collision.k1_loglik`` and ``log_prob_plain`` wrapped so
    that each K1 launch's (mode, dtype, grad) and each plain call on a CUDA
    tensor land in ``calls``; returns the originals."""
    from vgpmp_torch.likelihoods import collision as col

    k1, plain = col.k1_loglik, col.log_prob_plain

    def k1_counting(model, q, sigma, grad, h2=False):
        calls.append((model.scene.mode, str(q.dtype).removeprefix("torch."), bool(grad)))
        return k1(model, q, sigma, grad, h2)

    def plain_counting(model, configs, sigma_obs):
        if configs.is_cuda:
            calls.append(("plain", str(configs.dtype).removeprefix("torch."), True))
        return plain(model, configs, sigma_obs)

    # the original bumps its counters through the module's name, which is
    # the wrapper's while it is patched
    for a in ("launches", "launches_h2", "launches_by"):
        setattr(k1_counting, a, getattr(k1, a))
    col.k1_loglik, col.log_prob_plain = k1_counting, plain_counting
    return k1, plain


def parity_phase(torch):
    """(t2) the reference-parity protocol through its entry point:
    ``benchmarking_torch.run_combo("franka", "industrial", runs=1,
    sdf_mode="nearest", use_tuned=False)`` at full width (B = 36, 200 steps,
    S = 20, N = 50, M = 10, P = 37): K1's nearest instantiation once per
    Adam step, no plain ``log_prob`` on the card, the executed verdicts held
    against the CPU plain path on the same trajectories (>= 34 of 36), the
    executed count beside JAX's record."""
    import benchmarking_torch
    from vgpmp_torch.engine import validator
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.session import PlanningSession

    captured, calls = [], []
    orig_validate = _capture_validate(captured)
    k1, plain = _count_k1(calls)
    t0 = time.perf_counter()
    try:
        rec = benchmarking_torch.run_combo("franka", "industrial", 1, "nearest", 0, use_tuned=False)
    finally:
        validator.execute_and_validate = orig_validate
        col.k1_loglik, col.log_prob_plain = k1, plain
    t_combo = time.perf_counter() - t0
    steps = rec["budget"]["num_steps"]
    with_grad = sum(1 for c in calls if c == ("nearest", "float32", True))
    forward_only = sum(1 for c in calls if c == ("nearest", "float32", False))
    plain_cuda = sum(1 for c in calls if c[0] == "plain")
    best, sb, gb, rep = captured[-1]
    cpu = PlanningSession("franka", "industrial", sdf_mode="nearest", use_tuned=False,
                          overrides={"jitter": 1e-6}, device="cpu")
    with torch.no_grad():
        ref = orig_validate(cpu.model.collision, best.cpu(), sb.cpu(), gb.cpu(), cpu.model.limits_low,
                            cpu.model.limits_high)
    B = best.shape[0]
    agree = int((rep.executed.cpu() == ref.executed).sum())
    executed = int(rep.executed.sum())
    jax_runs = next((r["per_run_solved"] for r in json.loads((ROOT / "RESULTS_r05_parity.json").read_text())
                     if (r["robot"], r["problemset"]) == ("franka", "industrial")), None)
    log(f"(t2) parity protocol, franka/industrial (nearest, untuned, jitter {rec['jitter']}): "
        f"{executed} / {B} executed (JAX's record, RESULTS_r05_parity.json: {jax_runs}); "
        f"{rec['steady_batch_seconds']} s a run, {t_combo:.1f} s with the session; K1-nearest "
        f"launches {with_grad} with d/dq in {steps} steps (+{forward_only} forward only), plain "
        f"log_prob on the card {plain_cuda}; verdicts equal to the CPU plain path on {agree} / {B}")
    assert with_grad == steps, f"K1-nearest launched {with_grad} times with d/dq in {steps} steps"
    assert plain_cuda == 0, "log_prob_plain ran on a CUDA tensor"
    assert agree >= B - 2, f"parity verdicts disagree with the CPU plain path on {B - agree} rows"
    return {"executed": executed, "rows": B, "jax_record_executed": jax_runs, "agree_with_cpu": agree,
            "k1_nearest_launches": with_grad, "k1_nearest_forward_only": forward_only,
            "steady_s": rec["steady_batch_seconds"], "combo_s": t_combo, "record": rec}


def trilinear_solve_phase(torch, sess, steps: int = 20):
    """A ``steps``-step franka/industrial solve at full width on the
    trilinear lookup (the session's scene in ``trilinear`` mode): K1's
    trilinear instantiation once per step, no plain ``log_prob`` on the
    card, finite ELBOs and trajectories."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.models import vgpmp as planner

    model = dataclasses.replace(sess.model, collision=mode_model(sess, "trilinear"))
    starts, goals = sess.queries()
    pp = sess.planner_params
    params = planner.init_params_batch(model, starts, goals, [0] * len(starts), 0.5 * (starts + goals),
                                       pp["lengthscales"], pp["variance"], pp["sigma_obs"], pp["alpha"])
    calls = []
    k1, plain = _count_k1(calls)
    try:
        solve = solver.make_batch_solver(model, dataclasses.replace(sess.train_config, num_steps=steps))
        _, res = solve(params, starts, goals, torch.Generator(device=sess.device).manual_seed(4))
        torch.cuda.synchronize()
    finally:
        col.k1_loglik, col.log_prob_plain = k1, plain
    e = res.elbo_history
    launches = sum(1 for c in calls if c == ("trilinear", "float32", True))
    log(f"(t1) trilinear solve, {steps} steps at B = {len(starts)}: K1-trilinear launches {launches} with "
        f"d/dq, plain log_prob on the card {sum(1 for c in calls if c[0] == 'plain')}; ELBO mean "
        f"{e[:, 0].mean().item():.4g} -> {e[:, -1].mean().item():.4g}")
    assert launches == steps and not any(c[0] == "plain" for c in calls)
    assert torch.isfinite(e).all() and torch.isfinite(res.best).all()
    return launches


def _spd(torch, T, n, dtype, dev, gen):
    G = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64)
    return (G @ G.mT + n * torch.eye(n, device=dev, dtype=torch.float64)).to(dtype)


def k2_shapes_check(torch, n, dtype, dev, gen, T=252):
    """K2's four entries at ``[T, n, n]`` in ``dtype`` on random SPD matrices
    (one made non-SPD: NaN in it and in no other), forward and backward,
    against the plain versions; relative to the largest reference entry:
    1e-9 in float64 (gradients 1e-8), 1e-4 in float32 (condition ~10).
    Returns the largest absolute and relative errors."""
    from vgpmp_torch.ops import linalg as la

    tol, gtol = (1e-9, 1e-8) if dtype == torch.float64 else (1e-4, 1e-4)
    K = _spd(torch, T, n, dtype, dev, gen)
    K[-1, -1, -1] = -1.0
    ok = torch.ones(T, dtype=torch.bool, device=dev)
    ok[-1] = False
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    errs, absolute = {}, []
    diff = lambda a, b: absolute.append((a - b).abs().max().item()) or rel(a, b)
    Lk, Lp = la.k2_chol(K), la.cholesky_unrolled(K)
    assert torch.isnan(Lk[-1]).any() and torch.isfinite(Lk[ok]).all(), "K2 chol: NaN out of its matrix"
    errs["chol"] = diff(Lk[ok], Lp[ok])
    for k in (1, 100):
        Bm = torch.randn((T, n, k), generator=gen, device=dev, dtype=torch.float64).to(dtype)
        for up, fp in ((False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)):
            X = la.k2_trsm(Lk, Bm, up)
            assert torch.isfinite(X[ok]).all()
            errs[f"trsm_k{k}_{'upperT' if up else 'lower'}"] = diff(X[ok], fp(Lp[ok], Bm[ok]))
    Bm = torch.randn((T, n, 71), generator=gen, device=dev, dtype=torch.float64).to(dtype)
    Lf, Xf = la.k2_factor_solve(K, Bm)
    Lq, Xq = la.factor_solve_plain(K, Bm)
    assert torch.isnan(Lf[-1]).any() and torch.isfinite(Xf[ok]).all()
    errs["fused_L"], errs["fused_X"] = diff(Lf[ok], Lq[ok]), diff(Xf[ok], Xq[ok])
    WL = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64).to(dtype)
    WX = torch.randn((T, n, 71), generator=gen, device=dev, dtype=torch.float64).to(dtype)
    gK, gB = la.k2_factor_solve_bwd(Lq[ok].contiguous(), Xq[ok].contiguous(), WL[ok].contiguous(),
                                    WX[ok].contiguous())
    hK, hB = la.factor_solve_bwd_plain(Lq[ok], Xq[ok], WL[ok], WX[ok])
    errs["fused_bwd_K"], errs["fused_bwd_B"] = diff(gK, hK), diff(gB, hB)
    bad = {k: v for k, v in errs.items() if v > (gtol if "bwd" in k else tol)}
    assert not bad, f"K2 at n = {n} in {dtype}: {bad}"
    return max(absolute), max(errs.values())


def k2_times(torch, n, dtype, dev, gen, flush, T=252, k_trsm=100, k_fused=71):
    """``k2_chol``, ``k2_trsm`` (k columns), the fused pair and its backward
    at ``[T, n, n]`` in ``dtype``, each beside its plain version, the library
    call (``torch.linalg.cholesky``, ``solve_triangular``, both for the pair)
    and the bound (:func:`k2_bound`; the operations at the float64 tensor
    cores' peak, where the block design runs its products, or the float32
    peak)."""
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.timing import time_ms

    es = torch.finfo(dtype).bits // 8
    peak = F64_TC_FLOPS if dtype == torch.float64 else F32_FLOPS
    # above the block design: what the streamed design itself moves (GB)
    own = ((lambda entry, k: T * la.k2_work(entry, n, k, "streamed")[0] * es / 1e9)
           if n > la.KERNEL_BLOCK_MAX_N else (lambda entry, k: None))
    K = _spd(torch, T, n, dtype, dev, gen)
    L = la.k2_chol(K)
    Bt = torch.randn((T, n, k_trsm), generator=gen, device=dev, dtype=torch.float64).to(dtype)
    Bf = torch.randn((T, n, k_fused), generator=gen, device=dev, dtype=torch.float64).to(dtype)
    gL = torch.randn((T, n, n), generator=gen, device=dev, dtype=torch.float64).to(dtype)
    Lf, Xf = la.k2_factor_solve(K, Bf)
    out = {}
    b = k2_bound("chol", T, n, 0, es, peak)
    out["chol"] = {"ms": time_ms(lambda: la.k2_chol(K), flush=flush),
                   "plain_ms": time_ms(lambda: la.cholesky_unrolled(K), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch.linalg.cholesky(K), flush=flush),
                   "bound_ms": b[0], "bound_by": b[1], "streamed_gb": own("chol", 0)}
    b = k2_bound("trsm", T, n, k_trsm, es, peak)
    out["trsm"] = {"ms": time_ms(lambda: la.k2_trsm(L, Bt, False), flush=flush),
                   "plain_ms": time_ms(lambda: la.solve_lower_unrolled(L, Bt), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch.linalg.solve_triangular(L, Bt, upper=False),
                                         flush=flush),
                   "upper_t_ms": time_ms(lambda: la.k2_trsm(L, Bt, True), flush=flush),
                   "bound_ms": b[0], "bound_by": b[1], "k": k_trsm, "streamed_gb": own("trsm", k_trsm)}

    def library_pair():
        Ll = torch.linalg.cholesky(K)
        return Ll, torch.linalg.solve_triangular(Ll, Bf, upper=False)

    b = k2_bound("pair", T, n, k_fused, es, peak)
    out["factor_solve"] = {"ms": time_ms(lambda: la.k2_factor_solve(K, Bf), flush=flush),
                           "plain_ms": time_ms(lambda: la.factor_solve_plain(K, Bf), reps=5, flush=flush),
                           "library_ms": time_ms(library_pair, flush=flush),
                           "bound_ms": b[0], "bound_by": b[1], "k": k_fused,
                           "streamed_gb": own("pair", k_fused)}
    b = k2_bound("bwd", T, n, k_fused, es, peak)
    out["factor_solve_bwd"] = {
        "ms": time_ms(lambda: la.k2_factor_solve_bwd(Lf, Xf, gL, Bf), flush=flush),
        "plain_ms": time_ms(lambda: la.factor_solve_bwd_plain(Lf, Xf, gL, Bf), reps=5, flush=flush),
        "library_ms": None, "bound_ms": b[0], "bound_by": b[1], "k": k_fused,
        "streamed_gb": own("bwd", k_fused)}
    return out


def _row_noise(torch, m, cfg, B, steps, seed):
    """Injected draws of a ``steps``-step solve of ``B`` rows, made on the
    CPU (the card's and the CPU's generators differ), in the model's dtype."""
    from vgpmp_torch.engine.solver import SolveNoise
    from vgpmp_torch.gp.pathwise import draw_noise

    gen = torch.Generator().manual_seed(seed)
    Mc, L = m.num_inducing + 2, 7
    dt = m.limits_low.dtype
    mk = lambda S: draw_noise((B,), L, Mc, S, m.num_bases, dt, "cpu", gen, m.kernel, m.antithetic)
    return SolveNoise(steps=[mk(m.num_samples) for _ in range(steps)],
                      posterior=mk(cfg.num_posterior_samples))


def _noise_to(torch, noise, dev, rows=None):
    pick = (lambda x: x.to(dev)) if rows is None else (lambda x: x[:rows].to(dev))
    cast = lambda pn: type(pn)(*(pick(x) for x in pn))
    return type(noise)(steps=[cast(s) for s in noise.steps], posterior=cast(noise.posterior))


def injected_solve(torch, sess, cpu, steps: int, rows: int, seed: int):
    """A ``steps``-step solve of ``sess`` at full width from the linear init on
    draws made on the CPU, and the same solve of its first ``rows`` rows by
    each CPU session of ``cpu`` (one, or a list; the plain path) on the same
    draws. Returns the card's result, the CPU's result (a list for a list)
    and the K1 calls of the card's solve."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.models import vgpmp as planner

    starts, goals = sess.queries()
    pp = sess.planner_params
    cfg = dataclasses.replace(sess.train_config, num_steps=steps)
    noise = _row_noise(torch, sess.model, cfg, len(starts), steps, seed)
    out = []
    calls = []
    cpus = cpu if isinstance(cpu, list) else [cpu]
    for s, n in [(sess, len(starts))] + [(c, rows) for c in cpus]:
        params = planner.init_params_batch(s.model, starts[:n], goals[:n], [0] * n,
                                           0.5 * (starts[:n] + goals[:n]), pp["lengthscales"],
                                           pp["variance"], pp["sigma_obs"], pp["alpha"])
        solve = solver.make_batch_solver(s.model, cfg)
        if s is sess:
            k1, plain = _count_k1(calls)
        try:
            _, res = solve(params, starts[:n], goals[:n], noise=_noise_to(torch, noise, s.device, n))
        finally:
            if s is sess:
                col.k1_loglik, col.log_prob_plain = k1, plain
        out.append(res)
    torch.cuda.synchronize()
    return out[0], out[1:] if isinstance(cpu, list) else out[1], calls


def elbo_agreement(torch, card_res, cpu_res, rtol):
    """Rows whose first-step ELBO agrees to ``rtol`` relative (the same
    parameters and draws), and the largest relative difference of the
    last step's row-mean ELBO."""
    e_k, e_p = card_res.elbo_history[: cpu_res.elbo_history.shape[0]].cpu(), cpu_res.elbo_history
    first = ((e_k[:, 0] - e_p[:, 0]).abs() / e_p[:, 0].abs())
    last = ((e_k[:, -1].mean() - e_p[:, -1].mean()).abs() / e_p[:, -1].mean().abs()).item()
    return int((first <= rtol).sum()), first.max().item(), last


def k2_real_check(torch, K, gen, flush):
    """K2's four entries on real conditioned Grams ``K [T, n, n]`` (float64)
    against the plain versions, at the block design's real-Gram tolerances
    (``tests/test_torch_kernels.py``): relative to the largest reference
    entry, the factor, the solves and the backward (given the same factor)
    to 1e-9, the pair's X (its own factor's rounding times the factor's
    condition) to 1e-6; ``k2_chol`` and the pair timed beside
    ``torch.linalg``. Returns the errors and times."""
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.timing import time_ms

    T, n = K.shape[0], K.shape[-1]
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    mk = lambda *shape: torch.randn(shape, generator=gen, device=K.device, dtype=K.dtype)
    Bm, gL, gX = mk(T, n, 71), mk(T, n, n), mk(T, n, 71)
    Lp = la.cholesky_unrolled(K)
    errs = {"chol": rel(la.k2_chol(K), Lp),
            "trsm_lower": rel(la.k2_trsm(Lp, Bm, False), la.solve_lower_unrolled(Lp, Bm)),
            "trsm_upperT": rel(la.k2_trsm(Lp, Bm, True), la.solve_upper_T_unrolled(Lp, Bm))}
    Lf, Xf = la.k2_factor_solve(K, Bm)
    Lq, Xq = la.factor_solve_plain(K, Bm)
    errs["pair_L"], errs["pair_X"] = rel(Lf, Lq), rel(Xf, Xq)
    gK, gB = la.k2_factor_solve_bwd(Lq, Xq, gL, gX)
    hK, hB = la.factor_solve_bwd_plain(Lq, Xq, gL, gX)
    errs["bwd_K"], errs["bwd_B"] = rel(gK, hK), rel(gB, hB)
    bad = {k: v for k, v in errs.items() if not v <= (1e-6 if k == "pair_X" else 1e-9)}
    assert not bad, f"K2 on the real Mc = {n} Grams: {bad}"

    def library_pair():
        Ll = torch.linalg.cholesky(K)
        return Ll, torch.linalg.solve_triangular(Ll, Bm, upper=False)

    times = {"chol_ms": time_ms(lambda: la.k2_chol(K), flush=flush),
             "chol_library_ms": time_ms(lambda: torch.linalg.cholesky(K), flush=flush),
             "pair_ms": time_ms(lambda: la.k2_factor_solve(K, Bm), flush=flush),
             "pair_library_ms": time_ms(library_pair, flush=flush)}
    return {"max_rel_err": errs, **times}


def k2_streamed_phase(torch, sess, cpu, flush, checks, times):
    """(t3) above n = 128, the streamed design: the four entries at n = 129,
    160 and 256 in float64 and at 160 and 256 in float32 (``checks``,
    ``times``), and on the real Mc = 160 Grams; then three 20-step solves at
    the bench's full width with more than 126 inducing points, each with 36
    finite rows and its K2 launches at n > 128 counted: Mc = 160
    (``num_inducing=158``) fused, on draws made on the CPU; the same with
    ``jitter_escalations=1`` (the lone ``k2_chol`` and ``k2_trsm``); Mc = 256
    fused. The first ELBO of the Mc = 160 solve against one ELBO of the CPU
    plain path ``cpu`` on the same parameters and draws: within 1e-3
    relative on >= 34 of the 36 rows (float32 bulk tensors on both, summed
    in other orders, and a sphere that a float32 rounding moves into the
    neighbouring voxel, as the escalation check allows)."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la

    t0 = time.perf_counter()
    dev = sess.device
    gen = torch.Generator(device=dev).manual_seed(41)
    for n in (129, 160, 256):
        checks[f"f64_n{n}"] = k2_shapes_check(torch, n, torch.float64, dev, gen)
        times[f"f64_n{n}"] = k2_times(torch, n, torch.float64, dev, gen, flush)
    for n in (160, 256):
        checks[f"f32_n{n}"] = k2_shapes_check(torch, n, torch.float32, dev, gen)
        times[f"f32_n{n}"] = k2_times(torch, n, torch.float32, dev, gen, flush)
    t_kernels = time.perf_counter() - t0
    above = ("f64_n129", "f64_n160", "f64_n256", "f32_n160", "f32_n256")
    log("(t3) K2's streamed design, largest absolute / relative error: "
        + ", ".join(f"{k} {checks[k][0]:.2e} / {checks[k][1]:.2e}" for k in above))
    for k in above:
        log(f"(t3) K2 {k} [252, n, n]: " + json.dumps(times[k]))

    starts, goals = sess.queries()
    pp = sess.planner_params
    B = len(starts)
    cfg = dataclasses.replace(sess.train_config, num_steps=20)
    assert not cfg.randomize_timesteps

    def init(m):
        return planner.init_params_batch(m, starts, goals, [0] * B, 0.5 * (starts + goals), pp["lengthscales"],
                                         pp["variance"], pp["sigma_obs"], pp["alpha"])

    m160 = dataclasses.replace(sess.model, num_inducing=158)
    with torch.no_grad():
        K160, _ = planner._gram(m160, planner.constrain(init(m160), m160.variance_lower))
    real = k2_real_check(torch, K160.reshape(-1, 160, 160).contiguous(), gen, flush)
    log(f"(t3) K2 on the real Mc = 160 Grams [{K160.numel() // 160 ** 2}, 160, 160] (condition to ~3e10): "
        + json.dumps(real))

    noise = _row_noise(torch, m160, cfg, B, cfg.num_steps, seed=37)
    counters = (la.k2_chol, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd)
    solves = {}
    for name, m, draws in (("mc160_fused", m160, noise),
                           ("mc160_escalating", dataclasses.replace(m160, jitter_escalations=1), None),
                           ("mc256_fused", dataclasses.replace(sess.model, num_inducing=254), None)):
        for c in counters:
            c.launches_by_n = {}
        t1 = time.perf_counter()
        solve = solver.make_batch_solver(m, cfg)
        if draws is None:
            _, res = solve(init(m), starts, goals, torch.Generator(device=dev).manual_seed(6))
        else:
            _, res = solve(init(m), starts, goals, noise=_noise_to(torch, draws, dev))
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t1
        by_n = {c.__name__: dict(c.launches_by_n) for c in counters}
        above = {nm: sum(v for n, v in d.items() if n > la.KERNEL_BLOCK_MAX_N) for nm, d in by_n.items()}
        above = {nm: v for nm, v in above.items() if v}
        total = sum(sum(d.values()) for d in by_n.values())
        finite = torch.isfinite(res.elbo_history).all(dim=1) & torch.isfinite(res.best).flatten(1).all(dim=1)
        solves[name] = {"Mc": m.num_inducing + 2, "solve_s": t_solve, "finite_rows": int(finite.sum()),
                        "k2_launches_above_128": above, "k2_launches": total,
                        "elbo_first_mean": res.elbo_history[:, 0].mean().item(),
                        "elbo_last_mean": res.elbo_history[:, -1].mean().item()}
        log(f"(t3) 20-step solve at Mc = {m.num_inducing + 2} ({name}), B = {B}: " + json.dumps(solves[name]))
        assert solves[name]["finite_rows"] == B, f"{name}: non-finite rows"
        assert above and sum(above.values()) == total, f"{name}: K2 launches by n {by_n}"
        if name == "mc160_fused":
            first_card = res.elbo_history[:, 0].cpu()
    assert all(solves["mc160_fused"]["k2_launches_above_128"].get(k, 0) > 0
               for k in ("k2_trsm", "k2_factor_solve", "k2_factor_solve_bwd"))
    assert solves["mc160_escalating"]["k2_launches_above_128"].get("k2_chol", 0) > 0
    assert solves["mc256_fused"]["k2_launches_above_128"].get("k2_factor_solve", 0) > 0

    # (c) the first ELBO against one ELBO of the CPU plain path on the same
    # parameters and draws, at the solver's first σ_obs scale; and the same
    # ELBO evaluated on the card, which the solver's first entry must be
    t1 = time.perf_counter()
    scale0 = float(cfg.sigma_anneal) if cfg.sigma_anneal > 1.0 else 1.0
    elbos = {}
    for role, s in (("card", sess), ("cpu", cpu)):
        m = dataclasses.replace(s.model, num_inducing=158)
        X = torch.linspace(0.0, 1.0, cfg.time_spacing_X, dtype=m.dtype, device=s.device)
        as_t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=s.device)
        with torch.no_grad():
            elbos[role] = planner.elbo(
                init(m), m, as_t(starts), as_t(goals), X, None,
                type(noise.steps[0])(*(x.to(s.device) for x in noise.steps[0])), scale0).cpu()
    e_cpu = elbos["cpu"]
    first = ((first_card - e_cpu).abs() / e_cpu.abs())
    direct = ((elbos["card"] - first_card).abs() / first_card.abs()).max().item()
    agree = int((first <= 1e-3).sum())
    elbo_check = {"rows_within_1e-3": agree, "max_rel_err": first.max().item(),
                  "median_rel_err": first.median().item(), "card_direct_vs_solver": direct,
                  "cpu_elbo_s": time.perf_counter() - t1}
    log(f"(t3) Mc = 160 first ELBO against the CPU plain path on the same draws: " + json.dumps(elbo_check))
    assert direct <= 1e-6, f"the solver's first ELBO is not the ELBO at its first step: {direct}"
    assert agree >= B - 2, f"Mc = 160: the first ELBO disagrees with the CPU plain path: {elbo_check}"
    log(f"(t3) above n = 128 took {time.perf_counter() - t0:.1f} s (kernel checks and times {t_kernels:.1f} s)")
    return {"real_mc160": real, "solves": solves, "first_elbo": elbo_check}


def k2_envelope_phase(torch, sess, flush, cpu=None):
    """(t3) K2 above n = 32 and in float32: the four entries at n = 40, 64
    and 128 (KERNEL_BLOCK_MAX_N) in float64 and at n = 12, 26, 40, 64 and 128 in
    float32 against their plain versions, timed beside the library calls;
    then (a) a 20-step solve whose
    ``num_inducing`` is 38 (Mc = 40: the block design in the fused pair, its
    backward and the extraction's solves) and the same with
    ``jitter_escalations=1`` (the lone ``k2_chol`` and ``k2_trsm`` at n = 40);
    (b) the float32 island: a 20-step solve with ``solve_dtype`` float32
    (jitter 1e-6, escalation on, 3 retries) launching ``k2_chol`` and
    ``k2_trsm`` in float32, its first ELBO against the CPU plain path on the
    same draws; (c) above n = 128 (:func:`k2_streamed_phase`, with the CPU
    session ``cpu``: one is made where it is None)."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.session import PlanningSession

    dev = sess.device
    gen = torch.Generator(device=dev).manual_seed(23)
    checks, times = {}, {}
    for n in (40, 64, la.KERNEL_BLOCK_MAX_N):
        checks[f"f64_n{n}"] = k2_shapes_check(torch, n, torch.float64, dev, gen)
        times[f"f64_n{n}"] = k2_times(torch, n, torch.float64, dev, gen, flush)
    for n in (12, 26, 40, 64, la.KERNEL_BLOCK_MAX_N):
        checks[f"f32_n{n}"] = k2_shapes_check(torch, n, torch.float32, dev, gen)
        times[f"f32_n{n}"] = k2_times(torch, n, torch.float32, dev, gen, flush)
    log("(t3) K2 envelope check, largest absolute / relative error: "
        + ", ".join(f"{k} {a:.2e} / {r:.2e}" for k, (a, r) in checks.items()))
    for k, v in times.items():
        log(f"(t3) K2 {k} [252, n, n]: " + json.dumps(v))

    counters = (la.k2_chol, la.k2_trsm, la.k2_factor_solve, la.k2_factor_solve_bwd)
    starts, goals = sess.queries()
    pp = sess.planner_params
    wide = {}
    for name, esc in (("fused", 0), ("escalating", 1)):
        m = dataclasses.replace(sess.model, num_inducing=38, jitter_escalations=esc)
        params = planner.init_params_batch(m, starts, goals, [0] * len(starts), 0.5 * (starts + goals),
                                           pp["lengthscales"], pp["variance"], pp["sigma_obs"], pp["alpha"])
        for c in counters:
            c.launches, c.launches_by = 0, {}
        solve = solver.make_batch_solver(m, dataclasses.replace(sess.train_config, num_steps=20))
        _, res = solve(params, starts, goals, torch.Generator(device=dev).manual_seed(6))
        torch.cuda.synchronize()
        wide[name] = {"launches": {c.__name__: c.launches for c in counters},
                      "finite_rows": int(torch.isfinite(res.elbo_history).all(dim=1).sum()),
                      "elbo_first_mean": res.elbo_history[:, 0].mean().item(),
                      "elbo_last_mean": res.elbo_history[:, -1].mean().item()}
        log(f"(t3) 20-step solve at Mc = 40 ({name}): " + json.dumps(wide[name]))
        assert wide[name]["finite_rows"] == len(starts), f"Mc = 40 ({name}): non-finite rows"
    assert wide["fused"]["launches"]["k2_factor_solve"] > 0 and wide["fused"]["launches"]["k2_trsm"] > 0
    assert wide["escalating"]["launches"]["k2_chol"] > 0

    # The float32 island at the session's jitter of 1e-9 factors Grams of
    # condition up to ~1e9 in float32: the CPU's own float32 and float64
    # islands then differ by 13 % in the first ELBO, so no two float32
    # orderings agree better. At JAX's float32 Gram jitter (1e-6,
    # tools/gram_bench.py) the condition stays under ~1e6 and the CPU's two
    # islands agree to 3e-3: the solve runs there.
    t0 = time.perf_counter()
    ov = {"solve_dtype": torch.float32, "jitter": 1e-6}
    island = PlanningSession("franka", "industrial", overrides=ov)
    island_cpu = PlanningSession("franka", "industrial", overrides=ov, device="cpu")
    assert island.model.solve_dtype == torch.float32 and island.model.jitter_escalations == 3
    for c in counters:
        c.launches, c.launches_by = 0, {}
    # beside the CPU's float32 island, its float64 island on the same draws:
    # the float32 island's own error on these inputs
    cpu64 = copy.copy(island_cpu)
    cpu64.model = dataclasses.replace(island_cpu.model, solve_dtype=torch.float64, jitter_escalations=0)
    res_k, (res_p, res_64), _ = injected_solve(torch, island, [island_cpu, cpu64], 20, 12, seed=29)
    by = {c.__name__: dict(c.launches_by) for c in counters}
    e64 = res_64.elbo_history[:, 0]
    own = ((res_p.elbo_history[:, 0] - e64).abs() / e64.abs()).max().item()
    card_vs_64 = ((res_k.elbo_history[:12, 0].cpu() - e64).abs() / e64.abs()).max().item()
    # the same parameters and draws: the first step's ELBO agrees to 1e-2
    # relative on >= 10 of the 12 rows compared (float32 factors of Grams of
    # condition ~1e6 in two orders, the CPU's own float32 island `own` from
    # its float64 one; a Gram whose pivot lies within a rounding of zero
    # escalates its jitter on one side only); later steps compound it
    # through Adam and are reported
    agree, first_err, last_err = elbo_agreement(torch, res_k, res_p, 1e-2)
    log(f"(t3) float32 island (solve_dtype float32, jitter 1e-6, 3 escalations), 20 steps at B = 36: "
        f"K2 launches by dtype {by}; first-step ELBO within 1e-2 of the CPU plain path on {agree} / 12 "
        f"rows (largest {first_err:.2e}); from the CPU's float64 island: the card's {card_vs_64:.2e}, "
        f"the CPU's float32 island's {own:.2e}; last-step mean {last_err:.2e} apart; "
        f"{time.perf_counter() - t0:.1f} s with both sessions")
    assert by["k2_chol"].get("float32", 0) > 0 and by["k2_trsm"].get("float32", 0) > 0, by
    assert torch.isfinite(res_k.elbo_history).all(), "float32 island: non-finite ELBO"
    assert agree >= 10, "float32 island's first step disagrees with the CPU plain path"
    if cpu is None:
        cpu = PlanningSession("franka", "industrial", overrides=sess.overrides, device="cpu")
    streamed = k2_streamed_phase(torch, sess, cpu, flush, checks, times)
    return {"checks": checks, "times": times, "wide": wide, "streamed": streamed,
            "island": {"launches_by_dtype": by, "first_step_agree_rows": agree,
                       "first_step_max_rel_err": first_err, "cpu_float32_vs_float64": own,
                       "card_float32_vs_cpu_float64": card_vs_64,
                       "last_step_mean_rel_err": last_err}}


def float64_phase(torch, flush):
    """(t4) a float64 franka/industrial session (packed, the float64 island):
    K1 and both K3 entries against their plain float64 versions on the card,
    a 20-step solve on draws made on the CPU against the CPU float64 plain
    path, and one scored round (``make_round_solver``) whose verdicts are
    held against the CPU plain path on the same trajectories; K1 and both K3
    entries launched in float64."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.engine.validator import execute_and_validate
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.session import PlanningSession

    t0 = time.perf_counter()
    sess = PlanningSession("franka", "industrial", dtype=torch.float64)
    cpu = PlanningSession("franka", "industrial", dtype=torch.float64, device="cpu")
    t_sess = time.perf_counter() - t0
    k1 = k1_phase(torch, sess, flush, "[float64]")
    k3, k3p = k3_phase(torch, sess, flush, "[float64]")
    for c in (col.k3_min_clearance, col.k3_probe_clearance):
        c.launches_by = {}
    res_k, res_p, calls = injected_solve(torch, sess, cpu, 20, 12, seed=31)
    k1_f64 = sum(1 for c in calls if c == ("packed", "float64", True))
    agree_e, first_err, last_err = elbo_agreement(torch, res_k, res_p, 1e-6)

    starts, goals = sess.queries()
    pp = sess.planner_params
    B = len(starts)
    params = planner.init_params_batch(sess.model, starts, goals, [0] * B, 0.5 * (starts + goals),
                                       pp["lengthscales"], pp["variance"], pp["sigma_obs"], pp["alpha"])
    round_calls = []
    k1w, plain = _count_k1(round_calls)
    try:
        best, rep = solver.make_round_solver(sess.model, sess.train_config)(
            params, starts, goals, torch.Generator(device=sess.device).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        col.k1_loglik, col.log_prob_plain = k1w, plain
    k3_by = {"k3_min_clearance": dict(col.k3_min_clearance.launches_by),
             "k3_probe_clearance": dict(col.k3_probe_clearance.launches_by)}
    st = torch.as_tensor(starts, dtype=torch.float64)
    gl = torch.as_tensor(goals, dtype=torch.float64)
    with torch.no_grad():
        ref = execute_and_validate(cpu.model.collision, best.cpu(), st, gl, cpu.model.limits_low,
                                   cpu.model.limits_high)
    agree = {k: int((getattr(rep, k).cpu() == getattr(ref, k)).sum()) for k in ("executed", "success")}
    round_k1 = sum(1 for c in round_calls if c == ("packed", "float64", True))
    log(f"(t4) float64 session (sessions {t_sess:.1f} s): 20-step solve on CPU-made draws, K1 float64 "
        f"launches {k1_f64}; first-step ELBO within 1e-6 of the CPU float64 plain path on {agree_e} / 12 "
        f"rows (largest {first_err:.2e}), last-step mean within {last_err:.2e}; round: "
        f"{int(rep.executed.sum())} / {B} executed, verdicts equal to the CPU plain path {agree}, K1 "
        f"float64 launches {round_k1}, K3 by dtype {k3_by}; best trajectories {best.dtype}")
    assert best.dtype == torch.float64 and torch.isfinite(res_k.elbo_history).all()
    assert k1_f64 == 20 and round_k1 == sess.train_config.num_steps, (k1_f64, round_k1)
    assert all(v.get("float64", 0) >= 1 for v in k3_by.values()), k3_by
    assert agree_e >= 11 and last_err <= 1e-3, "float64 solve disagrees with the CPU plain path"
    assert min(agree.values()) >= B - 2, f"float64 verdicts disagree with the CPU plain path: {agree}"
    k1["launches"] = k1_f64 + round_k1
    k3["launches"] = k3_by["k3_min_clearance"]["float64"]
    k3p["launches"] = k3_by["k3_probe_clearance"]["float64"]
    return k1, k3, k3p, {"sessions_s": t_sess, "solve_first_agree_rows": agree_e,
                         "solve_first_max_rel_err": first_err, "solve_last_mean_rel_err": last_err,
                         "round_executed": int(rep.executed.sum()), "round_agree_with_cpu": agree,
                         "k1_float64_launches": {"solve": k1_f64, "round": round_k1}, "k3_launches": k3_by}


def envelope_phase(torch, sess, flush, profiled=None, cpu=None):
    """(t): (t1) K1's nearest and trilinear lookups and a trilinear solve,
    (t2) the parity protocol through K1-nearest, (t3) K2 above n = 32 and in
    float32, and above n = 128, (t4) a float64 session. Returns the kernel
    rows it adds and its record; ``profiled`` as :func:`grid_modes_phase`
    takes it, ``cpu`` as :func:`k2_envelope_phase`."""
    from vgpmp_torch.ops import linalg as la

    t0 = time.perf_counter()
    grid = grid_modes_phase(torch, sess, flush, profiled)
    trilinear_launches = trilinear_solve_phase(torch, sess)
    parity = parity_phase(torch)
    k2 = k2_envelope_phase(torch, sess, flush, cpu)
    k1_64, k3_64, k3p_64, f64 = float64_phase(torch, flush)
    grid["nearest"]["launches"] = parity["k1_nearest_launches"]
    grid["trilinear"]["launches"] = trilinear_launches
    rows = [grid["nearest"], grid["trilinear"], k1_64, k3_64, k3p_64]
    src, rep = "vgpmp_torch/csrc/k2_linalg.cuh", "vgpmp_tpu/ops/linalg.py:30"
    errs = k2["checks"]
    wide = k2["wide"]
    # the block design (panels of 32, the float64 products on the tensor
    # cores) at the driven path's n = 40 (times at 64 and 128 in the record)
    for name, launches, key, replaces in (
            ("k2_chol", wide["escalating"]["launches"]["k2_chol"], "chol", rep),
            ("k2_trsm", wide["fused"]["launches"]["k2_trsm"], "trsm", "vgpmp_tpu/ops/linalg.py:52"),
            ("k2_factor_solve", wide["fused"]["launches"]["k2_factor_solve"], "factor_solve", rep),
            ("k2_factor_solve_bwd", wide["fused"]["launches"]["k2_factor_solve_bwd"], "factor_solve_bwd", rep)):
        t = k2["times"]["f64_n40"][key]
        rows.append({"name": f"{name}[n=40]", "design": "blocked", "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches, "max_abs_err": errs["f64_n40"][0],
                     "max_rel_err": errs["f64_n40"][1], **t,
                     "by_n": {n: {**k2["times"][f"f64_n{n}"][key], "max_abs_err": errs[f"f64_n{n}"][0]}
                              for n in (64, la.KERNEL_BLOCK_MAX_N)}})
    # the streamed design (its tiles in device memory) at the solves' n = 160,
    # with the launches of (t3)'s Mc = 160 solves (n = 129 and 256 in the record)
    # (above n = 40 JAX calls jnp.linalg.cholesky and solve_triangular: `chol`
    # and `solve_lower` of vgpmp_tpu/ops/linalg.py)
    above = {nm: v["k2_launches_above_128"] for nm, v in k2["streamed"]["solves"].items()}
    jchol = "vgpmp_tpu/ops/linalg.py:91"
    for name, key, solve, replaces in (
            ("k2_chol", "chol", "mc160_escalating", jchol),
            ("k2_trsm", "trsm", "mc160_fused", "vgpmp_tpu/ops/linalg.py:107"),
            ("k2_factor_solve", "factor_solve", "mc160_fused", jchol),
            ("k2_factor_solve_bwd", "factor_solve_bwd", "mc160_fused", jchol)):
        t = k2["times"]["f64_n160"][key]
        rows.append({"name": f"{name}[n=160]", "design": "streamed", "route": "cuda", "source": src,
                     "replaces": replaces, "launches": above[solve].get(name, 0),
                     "max_abs_err": errs["f64_n160"][0], "max_rel_err": errs["f64_n160"][1], **t,
                     "by_n": {n: {**k2["times"][f"f64_n{n}"][key], "max_abs_err": errs[f"f64_n{n}"][0]}
                              for n in (129, 256)},
                     "float32_by_n": {n: {**k2["times"][f"f32_n{n}"][key], "max_abs_err": errs[f"f32_n{n}"][0]}
                                      for n in (160, 256)}})
    island = k2["island"]["launches_by_dtype"]
    for name, key, replaces in (("k2_chol", "chol", rep), ("k2_trsm", "trsm", "vgpmp_tpu/ops/linalg.py:52")):
        t = k2["times"]["f32_n12"][key]
        rows.append({"name": f"{name}[float32]", "route": "cuda", "source": src, "replaces": replaces,
                     "launches": island[name]["float32"], "max_abs_err": errs["f32_n12"][0],
                     "max_rel_err": errs["f32_n12"][1], **t,
                     "by_n": {n: {**k2["times"][f"f32_n{n}"][key], "max_abs_err": errs[f"f32_n{n}"][0]}
                              for n in (26, 40, 64, la.KERNEL_BLOCK_MAX_N)}})
    log(f"(t) took {time.perf_counter() - t0:.1f} s")
    return rows, {"grid_modes": {m: {k: v for k, v in r.items() if k != "name"} for m, r in grid.items()},
                  "parity": parity, "k2": k2, "float64": f64, "trilinear_solve_launches": trilinear_launches}


# (u) mesh -> SDF. The industrial scene's grid (vgpmp_tpu/assets/scenes/
# industrial.json): its voxel edge and, with a padding of 25 cells, 337 x 401
# x 205 cells for a mesh of 285.5 x 349.5 x 153.5 voxels; its mesh's 422
# triangles in 23 pieces. MESH_AT places the mesh's centre in the
# franka/industrial session as a grid object, at the arm's reach.
MESH_DELTA = 0.0046848233333333334
MESH_PADDING = 25
MESH_DIMS = (337, 401, 205)
MESH_PIECES, MESH_TRIS = 23, 422
MESH_AT = (1.1, 0.0, 0.45)
# the float64 operations that K5's bound counts: a (cell, triangle) pair at
# the cheapest of Ericson's regions (ab, ac, ap, two dot products, the
# squared length, the minimum), and a (column, triangle) ray test
K5_PAIR_OPS, K5_RAY_OPS = 25, 20


def synthetic_mesh(seed, pieces, tris, dims, delta, padding):
    """A union of ``pieces`` closed convex pieces with ``tris`` triangles in
    all: a third of them boxes (12 triangles), the rest prisms of 3 or more
    sides whose caps are fans from a corner (4k - 4 triangles; where the count
    needs it, the last prism's top cap a fan from its centre, 2 more), each
    turned and placed at random (every third piece overlapping the one before
    it), then scaled per axis so that the grid ``mesh_to_sdf`` sizes at
    ``delta`` and ``padding`` has ``dims`` cells, centred on 0. Returns
    ``(verts [V, 3] float64, tris [T, 3] int32, piece [T] int32)``."""
    import numpy as np

    from vgpmp_torch.sdf.gen import grid_dims

    rng = np.random.default_rng(seed)
    n_box = pieces // 3
    n_prism = pieces - n_box
    rest = tris - 12 * n_box
    centre_cap = rest % 4 == 2
    assert rest % 2 == 0 and n_prism >= 1, (pieces, tris)
    total_k = (rest - 2 * centre_cap + 4 * n_prism) // 4
    mean = round(total_k / n_prism)
    assert 3 <= mean, (pieces, tris)
    ks = rng.integers(max(3, mean - 2), mean + 3, size=n_prism)
    while ks.sum() != total_k:  # one side more or fewer on a random prism, never below 3
        i = rng.integers(n_prism)
        ks[i] += 1 if ks.sum() < total_k else (-1 if ks[i] > 3 else 0)
    sides = [0] * n_box + ks.tolist()
    ext = (np.asarray(dims) - 1 - 2 * padding - 0.5) * delta
    cube = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    quads = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3))
    verts, faces, piece = [], [], []
    centre = np.zeros(3)
    for i, k in enumerate(sides):
        size = rng.uniform(0.15, 0.4, 3) * ext
        centre = (centre + rng.uniform(-0.3, 0.3, 3) * size if i % 3 == 2
                  else rng.uniform(-0.5, 0.5, 3) * ext)
        if k == 0:
            v = cube
            f = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
        else:
            ang = rng.uniform(0, 2 * np.pi) + 2 * np.pi * np.arange(k) / k
            ring = 0.5 * np.stack([np.cos(ang), np.sin(ang)], axis=1)
            v = np.concatenate([np.c_[ring, np.full(k, -0.5)], np.c_[ring, np.full(k, 0.5)]])
            f = [t for j in range(k) for t in ((j, (j + 1) % k, k + (j + 1) % k), (j, k + (j + 1) % k, k + j))]
            f += [(0, j + 1, j) for j in range(1, k - 1)]
            if centre_cap and i == len(sides) - 1:
                v = np.concatenate([v, [[0.0, 0.0, 0.5]]])
                f += [(2 * k, k + j, k + (j + 1) % k) for j in range(k)]
            else:
                f += [(k, k + j, k + j + 1) for j in range(1, k - 1)]
        rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        faces += [[a + len(verts) for a in t] for t in f]
        verts += list((v * size) @ rot.T + centre)
        piece += [i] * len(f)
    verts = np.asarray(verts)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    verts = -0.5 * ext + (verts - lo) * (ext / (hi - lo))
    out = verts, np.asarray(faces, dtype=np.int32), np.asarray(piece, dtype=np.int32)
    assert len(out[1]) == tris and grid_dims(verts, delta, padding=padding)[2] == tuple(dims)
    return out


def mesh_sdf_phase(torch, sess, flush, dims=MESH_DIMS, steps: int = 20):
    """(u) the port's ``mesh_to_sdf`` on the card: a synthetic mesh with the
    industrial mesh's counts voxelized at its grid by K5 (the main path:
    ``launches`` counted over that call alone), held against
    ``sdf_grid_plain`` on the card (1e-6 m, the sign equal in every cell),
    timed beside the plain version and the bound; then the grid as an object
    in a franka/industrial session: a ``steps``-step solve and a scored round
    of as many steps, through the composed K1 and K3, every row finite."""
    import numpy as np

    from vgpmp_torch.engine import solver
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.scene import SceneBuilder
    from vgpmp_torch.sdf import gen
    from vgpmp_torch.sdf.grid import SdfGrid
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import time_ms

    t_phase = time.perf_counter()
    verts, tris, piece = synthetic_mesh(0, MESH_PIECES, MESH_TRIS, dims, MESH_DELTA, MESH_PADDING)
    gen.k5_mesh_sdf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, origin, delta = gen.mesh_to_sdf(verts, tris, piece, delta=MESH_DELTA, padding=MESH_PADDING)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = gen.k5_mesh_sdf.launches
    assert tuple(data.shape) == tuple(dims) and launches == 1, (tuple(data.shape), launches)

    dev = data.device
    args = (torch.as_tensor(verts, device=dev), torch.as_tensor(tris, device=dev),
            torch.as_tensor(piece, device=dev), origin, delta, dims)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    plain = gen.sdf_grid_plain(*args)
    e.record()
    e.synchronize()
    plain_ms = s.elapsed_time(e)
    err = (data - plain).abs().max().item()
    differ = int((data != plain).sum())
    signs = int((torch.signbit(data) != torch.signbit(plain)).sum())
    inside = int((data < 0).sum())
    ms = time_ms(lambda: gen.k5_mesh_sdf(*args), reps=5, flush=flush)
    cells, T = data.numel(), len(tris)
    pairs, rays = cells * T, (dims[1] * dims[2]) * T
    b_ms, b_by = bound_ms(cells * 4 + T * (9 * 8 + 4), pairs * K5_PAIR_OPS + rays * K5_RAY_OPS, F64_FLOPS)
    log(f"(u) mesh_to_sdf on the card: a synthetic mesh of {MESH_PIECES} convex pieces, {T} triangles, at "
        f"delta {delta} with padding {MESH_PADDING}: grid {tuple(data.shape)} ({cells} cells), inside "
        f"{inside}; K5 launches {launches}, the call {t_main:.3f} s")
    log(f"    K5 against sdf_grid_plain on the card: max |d| {err:.3e} m (<= 1e-6), cells that differ {differ}, "
        f"signs that differ {signs}; K5 {ms:.3f} ms (L2 flushed, 5 calls), plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.3f} ms by {b_by} ({pairs} pairs, every (cell, triangle) pair evaluated, at {K5_PAIR_OPS} "
        f"float64 operations a pair, and {rays} ray tests at {K5_RAY_OPS}; output {cells * 4} bytes)")
    assert err <= 1e-6 and signs == 0, (err, signs)
    assert 0 < inside < cells, inside

    # the generated grid as an object in a franka/industrial session
    grid = SdfGrid(data=data, origin=torch.as_tensor(origin, dtype=torch.float32, device=dev),
                   delta=torch.tensor(delta, dtype=torch.float32, device=dev))
    b = SceneBuilder(base=sess.sdf, base_offset=sess.scene_offset, dtype=torch.float32, device=dev)
    b.add_object("mesh", MESH_AT, grid=grid)
    sc = b.build()
    msess = PlanningSession("franka", "industrial", extra_grids=sc.extra_grids, extra_offsets=sc.extra_offsets,
                            device=dev, dtype=torch.float32)
    starts, goals = msess.queries()
    pp, B = msess.planner_params, len(starts)
    cfg = dataclasses.replace(msess.train_config, num_steps=steps)
    params = planner.init_params_batch(msess.model, starts, goals, [0] * B, 0.5 * (starts + goals),
                                       pp["lengthscales"], pp["variance"], pp["sigma_obs"], pp["alpha"])
    counters = (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res = solver.make_batch_solver(msess.model, cfg)(params, starts, goals,
                                                         torch.Generator(device=dev).manual_seed(5))
    best, rep = solver.make_round_solver(msess.model, cfg)(params, starts, goals,
                                                           torch.Generator(device=dev).manual_seed(6))
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    on_path = {c.__name__: c.launches for c in counters}
    executed = int(rep.executed.sum())
    e = res.elbo_history
    log(f"    the grid at {MESH_AT} in a franka/industrial session: a {steps}-step solve and a scored round "
        f"at B = {B} in {t_solve:.2f} s, launches {on_path}, ELBO mean {e[:, 0].mean().item():.4g} -> "
        f"{e[:, -1].mean().item():.4g}, executed {executed}/{B}, smallest clearance "
        f"{rep.min_clearance.min().item():.4f} m; (u) took {time.perf_counter() - t_phase:.1f} s")
    assert all(v > 0 for v in on_path.values()), f"a kernel was not launched: {on_path}"
    assert torch.isfinite(e).all() and torch.isfinite(res.best).all() and torch.isfinite(best).all()
    for name, v in rep._asdict().items():
        assert v.shape == (B,) and torch.isfinite(v.float()).all(), f"report field {name}: {v}"
    row = {"name": "k5_mesh_sdf", "route": "cuda", "source": "vgpmp_torch/csrc/k5_mesh_sdf.cuh",
           "replaces": "vgpmp_tpu/native/sdfgen.cpp:91", "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "shape": [*dims, T], "pairs": pairs, "ray_tests": rays}
    return row, {"grid": list(dims), "triangles": T, "pieces": MESH_PIECES, "delta": delta,
                 "origin": [float(o) for o in origin], "inside_cells": inside, "cells_differ": differ,
                 "signs_differ": signs, "mesh_to_sdf_s": t_main, "solve_and_round_s": t_solve,
                 "launches": on_path, "executed": executed, "phase_s": time.perf_counter() - t_phase}


# (v) K6 at the cells' round-0 shapes: rows, samples S, grid N, inducing
# inputs Mc (ny and Z); 7 latents, 1 024 bases
K6_SHAPES = {"wam": (1024, 7, 70, 26), "franka": (512, 20, 50, 12)}
K6_BASES, K6_LATENTS = 1024, 7
K6_STEPS = 3


def k6_inputs(torch, robot: str, device, lengthscales, variance: float, dtype=None, seed: int = 0):
    """K6's inputs at ``robot``'s round-0 shape (:data:`K6_SHAPES`), as the
    pathwise draw makes them: ``draw_noise``'s Student-t frequencies over the
    lengthscales ``[L]``, the scale of ``variance``, inducing inputs ``[ny;
    Z]`` with Z sorted in (0, 1), the grid, and an upstream gradient ``g``."""
    from vgpmp_torch.gp import pathwise

    dtype = dtype or torch.float32
    B, S, N, Mc = K6_SHAPES[robot]
    L, nb = K6_LATENTS, K6_BASES
    g = torch.Generator(device=device).manual_seed(seed)
    noise = pathwise.draw_noise((B,), L, Mc, S, nb, dtype, device, g)
    ls = torch.as_tensor(lengthscales, dtype=dtype, device=device).expand(B, L)
    Z = torch.sort(torch.rand(B, L, Mc - 2, dtype=dtype, device=device, generator=g), dim=-1).values
    ny = torch.tensor([0.0, 1.0], dtype=dtype, device=device).expand(B, L, 2)
    return {"x": torch.cat([ny, Z], dim=-1), "x_const": torch.linspace(0, 1, N, dtype=dtype, device=device),
            "omega": noise.t / ls[..., None], "phase": noise.phase,
            "scale": torch.full((B, L, 1), (2.0 * variance / nb) ** 0.5, dtype=dtype, device=device),
            "w": noise.w, "g": torch.randn(B, S, L, Mc + N, dtype=dtype, device=device, generator=g)}


def k6_reference(torch, t, rows: int = 128):
    """The plain chain in float64 with autograd on ``k6_inputs``' tensors
    ``t``, ``rows`` rows at a time (a float64 feature tensor of wam's 1 024
    rows takes 5.6 GB): (paths, d x, d omega, d scale)."""
    from vgpmp_torch.ops import rff

    parts = []
    for i in range(0, t["x"].shape[0], rows):
        d = {k: v.double() if k == "x_const" else v[i:i + rows].double() for k, v in t.items()}
        x, om, sc = (d[k].requires_grad_(True) for k in ("x", "omega", "scale"))
        out = rff.prior_paths_plain(x, om, d["phase"], sc, d["w"], x_const=d["x_const"])
        out.backward(d["g"])
        parts.append([out.detach(), x.grad, om.grad, sc.grad])
    return [torch.cat(p) for p in zip(*parts)]


def k6_bound(robot: str, backward: bool = False):
    """K6's least time at ``robot``'s round-0 shape: forward, the float32 part
    of ``benchmark/work/rff.py``'s count (a cosine at 8 operations, the
    contraction at 2 S a pair); ``backward`` adds a sine and a cosine, H's 2 S
    and the three sums' 6 a pair. Operations at the float32 peak."""
    B, S, N, Mc = K6_SHAPES[robot]
    pairs = B * K6_LATENTS * (N + Mc) * K6_BASES
    ops = pairs * (8 + 2 * S) + (pairs * (16 + 2 * S + 6) if backward else 0)
    return ops / F32_FLOPS * 1e3


def k6_phase(torch, flush, steps: int = K6_STEPS):
    """(v) K6, the RFF prior's paths, at both cells' round-0 shapes: the
    forward (one launch for the inducing inputs and the grid, as the draw
    makes it) and the forward with its backward, each against the plain chain
    on the card (L2 flushed, means of 20 calls) and its bound; the largest
    error of the paths against the float64 plain chain and of the gradients
    of x, ω and the scale against the plain chain's autograd in float64; then
    the card's peak memory over one step of each cell's configuration with
    the plain chain and with K6, and a ``steps``-step solve with extraction
    through K6: its launches by entry and dtype, none of the plain chain on
    the card."""
    import numpy as np

    from vgpmp_torch.engine import solver
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops import rff
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import time_ms

    t_phase = time.perf_counter()
    rows = {}
    for robot in K6_SHAPES:
        sess = PlanningSession(robot, "industrial", dtype=torch.float32, sdf_mode="packed", use_tuned=True)
        pp, dev = sess.planner_params, sess.device
        t = k6_inputs(torch, robot, dev, pp["lengthscales"], pp["variance"])
        args = (t["x"], t["omega"], t["phase"], t["scale"], t["w"])

        def fwd(plain=False, grad=False, a=args, d=t):
            a = [v.detach().requires_grad_(grad and i in (0, 1, 3)) for i, v in enumerate(a)]
            out = (rff.prior_paths_plain if plain else rff.prior_paths)(*a, x_const=d["x_const"])
            if grad:
                out.backward(d["g"])
                return out, a[0].grad, a[1].grad, a[3].grad
            return (out,)

        k6 = [v.detach() for v in fwd(grad=True)]
        errs = {n: ((a.double() - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(("paths", "d_x", "d_omega", "d_scale"), k6, k6_reference(torch, t))}
        ms = {"k6_fwd": time_ms(fwd, flush=flush), "k6_fwd_bwd": time_ms(lambda: fwd(grad=True), flush=flush),
              "plain_fwd": time_ms(lambda: fwd(plain=True), flush=flush),
              "plain_fwd_bwd": time_ms(lambda: fwd(plain=True, grad=True), flush=flush)}
        bound = {"fwd": k6_bound(robot), "fwd_bwd": k6_bound(robot, backward=True)}

        # one step (the ELBO and its gradient) of the cell's configuration at its
        # round-0 rows, plain chain then K6
        starts, goals = sess.queries()
        B = K6_SHAPES[robot][0]
        reps = -(-B // len(starts))
        starts, goals = np.tile(starts, (reps, 1))[:B], np.tile(goals, (reps, 1))[:B]
        params = planner.init_params_batch(sess.model, starts, goals, [0] * B, 0.5 * (starts + goals),
                                           pp["lengthscales"], pp["variance"], pp["sigma_obs"], pp["alpha"])
        st, gl = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (starts, goals))
        X = torch.linspace(0, 1, K6_SHAPES[robot][2], dtype=torch.float32, device=dev)
        peak = {}
        for name in ("plain", "k6"):
            saved = rff.prior_paths
            if name == "plain":
                rff.prior_paths = rff.prior_paths_plain
            try:
                p = params.map(lambda v: v.detach().requires_grad_(True))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                value = planner.elbo(p, sess.model, st, gl, X, torch.Generator(device=dev).manual_seed(4))
                torch.autograd.grad(-value.sum(), [p.q_mu, p.q_sqrt, p.lengthscales_u, p.variance_u, p.z_u])
                torch.cuda.synchronize()
                peak[name] = torch.cuda.max_memory_allocated()
                del p, value
            finally:
                rff.prior_paths = saved
        rff.k6_rff.launches, rff.k6_rff.launches_by, rff.k6_rff.plain_on_card = 0, {}, 0
        cfg = dataclasses.replace(sess.train_config, num_steps=steps)
        _, res = solver.make_batch_solver(sess.model, cfg)(params, starts, goals,
                                                           torch.Generator(device=dev).manual_seed(5))
        torch.cuda.synchronize()
        launches = {"launches": rff.k6_rff.launches, "plain_on_card": rff.k6_rff.plain_on_card,
                    "by": {f"{e}/{d}": n for (e, d), n in rff.k6_rff.launches_by.items()}}
        finite = bool(torch.isfinite(res.elbo_history).all() and torch.isfinite(res.best).all())
        B_, S, N, Mc = K6_SHAPES[robot]
        log(f"(v) K6 at {robot}'s round 0 ({B_} rows x {K6_LATENTS} latents x ({Mc} + {N}) points x "
            f"{K6_BASES} bases, S {S}): fwd {ms['k6_fwd']:.4f} ms (plain {ms['plain_fwd']:.3f}, bound "
            f"{bound['fwd']:.4f}: {100 * bound['fwd'] / ms['k6_fwd']:.1f} %), fwd + bwd {ms['k6_fwd_bwd']:.4f} ms "
            f"(plain {ms['plain_fwd_bwd']:.3f}, bound {bound['fwd_bwd']:.4f}); error against float64 {errs}")
        log(f"    peak memory over one step at {B} rows: plain {peak['plain'] / 2**30:.3f} GiB, K6 "
            f"{peak['k6'] / 2**30:.3f} GiB; a {steps}-step solve with extraction: K6 {launches}, finite {finite}")
        assert errs["paths"] <= 2e-5 and max(errs.values()) <= 5e-5, errs
        assert launches["plain_on_card"] == 0 and launches["launches"] >= 2 * steps + 1, launches
        assert finite and peak["k6"] < peak["plain"], (finite, peak)
        rows[robot] = {"shape": list(K6_SHAPES[robot]), "ms": ms, "bound_ms": bound, "errors": errs,
                       "peak_bytes_one_step": peak, "solve": launches}
        del t, args, k6, sess
    log(f"(v) took {time.perf_counter() - t_phase:.1f} s")
    w = rows["wam"]
    row = {"name": "k6_rff", "route": "cuda", "source": "vgpmp_torch/csrc/k6_rff.cuh",
           "replaces": "vgpmp_torch/gp/pathwise.py: the features and their einsum (plain chain)",
           "launches": w["solve"]["launches"], "max_rel_err": max(w["errors"].values()), "ms": w["ms"]["k6_fwd"],
           "plain_ms": w["ms"]["plain_fwd"], "bound_ms": w["bound_ms"]["fwd"], "bound_by": "operations",
           "library_ms": None}
    return row, rows


UR10_ROWS = 3520  # the ur10-bookshelves-b3520 cell's rows, its round 0


def ur10_kernels_against_plain(torch, model, starts, goals, S: int = 7, N: int = 70, T: int = 150):
    """(w)'s first part: K1 (likelihood and d/dq) and both K3 entries for the
    model's arm against their plain versions on the same card inputs, at
    ``test_k1_matches_plain_on_card``'s and the K3 card tests' tolerances;
    ``starts``, ``goals`` ``[B, 6]`` on the card. Returns the errors and the
    shares that show the inputs reach the scene."""
    import numpy as np

    from vgpmp_torch import sim
    from vgpmp_torch.likelihoods import collision as col

    B, dev = starts.shape[0], starts.device
    gen = torch.Generator(device=dev).manual_seed(7)
    frac = torch.linspace(0, 1, N, device=dev)[None, None, :, None]
    q = starts[:, None, None] + (goals - starts)[:, None, None] * frac
    q = q + torch.randn((B, S, N, starts.shape[1]), generator=gen, device=dev)
    sigma = torch.full((B, model.fk.sphere_radii.shape[0]), 5e-4, device=dev)
    qk = q.clone().requires_grad_()
    lik_k = model.log_prob(qk, sigma)
    lik_k.sum().backward()
    qp = q.clone().requires_grad_()
    lik_p = col.log_prob_plain(model, qp, sigma)
    lik_p.sum().backward()
    active = (lik_p < 0).float().mean().item()
    close = torch.isclose(lik_k, lik_p, rtol=1e-5, atol=1e-3)
    off = (~close).float().mean().item()
    gscale = qp.grad.abs().max().item()
    gerr = (qk.grad[close] - qp.grad[close]).abs().max().item()
    assert 0.01 < active < 0.9, active
    assert off <= 1e-3, off
    torch.testing.assert_close(qk.grad[close], qp.grad[close], rtol=1e-3, atol=1e-3 * gscale)
    del q, qk, qp, lik_k, lik_p

    w = torch.linspace(0, 1, T, device=dev)[None, :, None]
    traj = starts[:, None] * (1 - w) + goals[:, None] * w
    traj = traj + 0.6 * torch.randn((B, T, starts.shape[1]), generator=gen, device=dev) * torch.sin(np.pi * w)
    ends = torch.cat([starts, goals, traj[:, 0]])
    ends_err = (model.min_clearance_eval(ends) - col.min_clearance_eval_plain(model, ends)).abs().max().item()
    assert ends_err <= 1e-5, ends_err
    qs, visited, seg_idx, *_ = sim.pd_path_configs(traj)
    depth_s, depth_g = torch.clamp(-model.min_clearance_eval(torch.cat([starts, goals])), min=0.0).split(B)
    args = (starts, goals, depth_s, depth_g, visited[:, 0], seg_idx, T, 0.5, 5e-3)
    clear, count = model.probe_clearance(qs, *args)
    plain = lambda x: col.min_clearance_eval_plain(model, x)
    parts = [sim.probe_clearance_plain(plain, qs[r:r + 440], *(a[r:r + 440] for a in args[:6]), *args[6:])
             for r in range(0, B, 440)]
    want_clear, want_count = (torch.cat(x) for x in zip(*parts))
    probe_err = (clear - want_clear).abs().max().item()
    below = (want_clear < 0).float().mean().item()
    assert probe_err <= 1e-5, probe_err
    assert 0.01 < below < 0.99, below
    floor = sim._floor_from_depths(qs, starts, goals, depth_s, depth_g, 0.5, 5e-3)
    near = visited & ((want_clear - floor).abs() <= 1e-5)
    far = sim._segment_count(seg_idx, visited & (want_clear < floor) & ~near, T)
    counts_ok = bool(((far <= count) & (count <= far + sim._segment_count(seg_idx, near, T))).all())
    assert counts_ok and int(want_count.sum()) > 0
    return {"k1_configs": int(B * S * N), "k1_hinge_active_share": active, "k1_value_off_share": off,
            "k1_dq_max_abs_err": gerr, "k1_dq_scale": gscale, "k3_ends_max_abs_err": ends_err,
            "k3_probes": int(qs.shape[0] * qs.shape[1]), "k3_probe_max_abs_err": probe_err,
            "k3_probes_below_0_share": below, "k3_counts_within_bracket": counts_ok}


def ur10_phase(torch, steps: int = 3, rows: int = UR10_ROWS):
    """(w) The UR10 on the bookshelves at its cell's round-0 shape: the
    6-joint K1 and K3 against their plain versions
    (:func:`ur10_kernels_against_plain`), then a ``steps``-step round
    (``make_round_solver``: the steps, the extraction, the metric) on
    ``rows`` rows, the problemset's queries tiled. Asserts that the round
    ran K1 and both K3 entries for 6 joints and standard DH and for no
    other arm, that no plain K1, K3 or K6 ran on the card and that every row
    is finite; records the card's peak memory and the round's seconds."""
    import numpy as np

    from vgpmp_torch.engine import solver
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.ops import rff
    from vgpmp_torch.session import PlanningSession

    t_phase = time.perf_counter()
    sess = PlanningSession("ur10", "bookshelves", dtype=torch.float32, sdf_mode="packed", use_tuned=True)
    fk = sess.model.collision.fk
    starts, goals = sess.queries()
    idx = np.arange(rows) % len(starts)
    starts, goals = starts[idx], goals[idx]
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=sess.device)
    against_plain = ur10_kernels_against_plain(torch, sess.model.collision, as_t(starts), as_t(goals))
    log(f"(w) 6-joint K1 and K3 against their plain versions at {rows} rows: {against_plain}")
    torch.cuda.empty_cache()
    arm_kernels = (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance)
    plain_kernels = (col.k1_loglik, col.k3_min_clearance, rff.k6_rff)
    for f in arm_kernels:
        f.launches_by_arm = {}
    for f in plain_kernels:
        f.plain_on_card = 0
    k6_before = rff.k6_rff.launches
    cfg = dataclasses.replace(sess.train_config, num_steps=steps)
    params = solver.init_slots(sess.model, starts, goals, sess.planner_params, ["linear"] * rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    best, reps = solver.make_round_solver(sess.model, cfg)(params, starts, goals,
                                                           torch.Generator(device=sess.device).manual_seed(6))
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    arms = {f.__name__: {f"{d}/{'craig' if c else 'standard'}": n for (d, c), n in f.launches_by_arm.items()}
            for f in arm_kernels}
    plain = {f.__name__: f.plain_on_card for f in plain_kernels}
    finite = bool(torch.isfinite(best).all())
    rec = {"robot": "ur10", "problemset": "bookshelves", "rows": rows, "steps": steps,
           "dof": int(fk.dof), "craig": bool(fk.craig), "spheres": int(fk.sphere_radii.shape[0]),
           "against_plain": against_plain, "launches_by_arm": arms, "plain_on_card": plain,
           "k6_launches": rff.k6_rff.launches - k6_before,
           "executed": int(torch.as_tensor(reps.executed).sum()), "finite": finite, "round_s": secs,
           "peak_bytes": int(peak), "phase_s": time.perf_counter() - t_phase}
    log(f"(w) ur10/bookshelves, {rows} rows, a {steps}-step round in {secs:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB: launches by arm {arms}, plain on the card {plain}, finite {finite}")
    assert (fk.dof, fk.craig) == (6, False), (fk.dof, fk.craig)
    assert arms["k1_loglik"].keys() == {"6/standard"} and arms["k1_loglik"]["6/standard"] >= steps + 1, arms
    for name in ("k3_min_clearance", "k3_probe_clearance"):
        assert arms[name].keys() == {"6/standard"} and arms[name]["6/standard"] >= 1, arms
    assert not any(plain.values()) and rec["k6_launches"] >= 2 * steps + 1, (plain, rec["k6_launches"])
    assert finite
    del sess, best, reps, params
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]  # the package, and the port's tools
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
    adaptive = adaptive_phase(torch, sess, cpu)
    combos = combos_phase(torch)
    flush = l2_flush_buffer(sess.device)
    profiled = []  # (i)'s and (t1)'s cases for the last profiler window
    dsigma, k1_h2, trainable = trainable_phase(torch, flush, k1, profiled)
    del flush
    randomized = randomize_phase(torch, sess, cpu)
    flush = l2_flush_buffer(sess.device)
    velocity = velocity_phase(torch, sess, cpu, flush)
    del flush
    resumable = resumable_phase(torch, sess)
    replanned = replan_phase(torch, sess)
    ensemble = ensemble_phase(torch, sess, cpu)
    flush = l2_flush_buffer(sess.device)
    k1o, k3o, k3po, olaunch, objects = objects_phase(torch, sess, cpu, flush)
    del flush
    log("(p) the parallel layer")
    parallel = parallel_phase(torch, sess, cpu, adaptive)
    log("(t) the CUDA envelope")
    flush = l2_flush_buffer(sess.device)
    envelope_rows, envelope = envelope_phase(torch, sess, flush, profiled, cpu)
    del flush
    log("(u) mesh -> SDF on the card (K5)")
    flush = l2_flush_buffer(sess.device)
    k5, mesh_sdf = mesh_sdf_phase(torch, sess, flush)
    del flush
    log("(v) the RFF prior's paths on the card (K6)")
    flush = l2_flush_buffer(sess.device)
    k6, rff_prior = k6_phase(torch, flush)
    del flush
    log("(w) the UR10 on the bookshelves at its cell's round 0 (K1 and K3 for 6 joints)")
    ur10 = ur10_phase(torch)
    t0 = time.perf_counter()
    diagnosed = diagnose_phase(torch)
    scaling = scaling_phase(torch)
    t_qr = time.perf_counter() - t0

    # the profile comes last: once a profiler has traced the process, its
    # kernel launches stay slower, which would inflate the rounds' seconds
    prof = profile_phase(torch, sess)
    metric_prof = metric_profile_phase(torch, sess, best)
    kernel_prof = kernel_profile_phase(torch, sess, k2, k4, profiled=profiled)
    # (s) after them: once a child process has profiled on the card, this
    # process's later profiler windows drop kernel records
    # (tools/profiler_drops_torch.py)
    t0 = time.perf_counter()
    breakdown = breakdown_phase(torch)
    log(f"(q)-(s) took {t_qr + time.perf_counter() - t0:.1f} s")
    for rec in (velocity, resumable, replanned, ensemble, objects, parallel, ur10, diagnosed, scaling,
                breakdown):
        print(json.dumps(rec))

    k1["launches"] = launches["k1_loglik"]
    k2[0]["launches"] = escalating["launches"]["k2_chol"]
    k2[1]["launches"] = launches["k2_trsm"]
    k2[2]["launches"] = launches["k2_factor_solve"]
    k2[3]["launches"] = launches["k2_factor_solve_bwd"]
    # the fused pair on the velocity Grams of (k), with (k)'s launches
    k2[2]["velocity"] = {**velocity["k2_velocity_grams"],
                         "launches": velocity["launches"]["k2_factor_solve"]}
    k3["launches"] = scored["launches"]["k3_min_clearance"]
    k3p["launches"] = scored["launches"]["k3_probe_clearance"]
    # the composed K1 and K3 with (o)'s adaptive solve's launches
    k1o["launches"] = olaunch["k1_loglik"]
    k3o["launches"] = olaunch["k3_min_clearance"]
    k3po["launches"] = olaunch["k3_probe_clearance"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    keys = ("name", "design", "route", "source", "replaces", "launches", "max_abs_err", "max_rel_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "velocity")
    kernels = [{k: v for k, v in d.items() if k in keys}
               for d in [k1, k1_h2, dsigma, *k2, k3, k3p, k4, k1o, k3o, k3po, *envelope_rows, k5, k6]]
    assert all(k["launches"] > 0 for k in kernels), "a kernel of a driven path was not launched"
    record = {"card": smi, "build_s": secs,
              "kernels": [k1, k1_h2, dsigma, *k2, k3, k3p, k4, k1o, k3o, k3po, *envelope_rows, k5, k6],
              "objects": objects, "envelope": envelope, "mesh_sdf": mesh_sdf, "rff_prior": rff_prior,
              "ur10_round0": ur10,
              "k2_errors": k2_errs, "combos": combos, "trainable": trainable, "randomized": randomized,
              "escalation_path": escalating,
              "small_input_rel_errors": small, "main_path": summary, "extraction_s": t_ext,
              "peak_memory_bytes": peak, "launches": launches, "profile": prof,
              "metric_profile": metric_prof, "kernel_device_profile": kernel_prof,
              "scored_round": scored, "gather_bench": gather, "adaptive": adaptive,
              "velocity": velocity, "resumable": resumable, "replan": replanned, "ensemble": ensemble,
              "parallel": parallel, "diagnose": diagnosed, "scaling": scaling, "breakdown": breakdown,
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
    sys.exit(p2_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--p2-rank"] else main())
