#!/usr/bin/env python3
"""Stage breakdown of one Adam step of the batched solve on the card (the
port's ``tools/profile_breakdown.py``): device time per stage, beside the
stream time that the host's launches stretch it to.

    python tools/profile_breakdown_torch.py [--robot franka --env industrial] \\
        [--batch 36] [--reps 50] [--json-out PATH] [--device cpu]

The ten stages are the JAX tool's, with its names, at the bench's shapes
(the tuned float32 session; ``--batch`` rows replicate the problemset's
queries, ``np.arange(B) % Q``, where the JAX tool caps B at the query count):
the Gram, factorisation, pathwise draw and evaluation (the fused K2 pair on
the card); FK; FK + SDF + hinge ``log_prob`` (K1 without, then with d/dq);
SDF + hinge on fixed sphere positions; FK with a gather-free cost; the full
ELBO forward, and forward and backward (the gradient of every leaf the
solver trains: all but a frozen σ_obs).

The port is eager, so JAX's ``lax.scan`` amortisation has no counterpart:
each stage runs ``--reps`` back-to-back calls on inputs it holds, and
:func:`vgpmp_torch.timing.time_stages` reports stream ms per call (CUDA
events), device ms per call (kernel time summed in a ``torch.profiler``
window over as many calls) and device launches per call. Stream minus device
time is the host's share.

Writes the JAX tool's keys (``stages_ms`` holds stream ms) plus
``stages_device_ms``, ``stages_launches``, ``stages_kernels`` (the largest
kernels of each stage), ``kernel_launches`` (the port's kernel wrappers'
counts over the run) and ``card`` to ``--json-out``, by default
``chiprun_out/profile_breakdown_torch.json``. Runs on the CUDA device and
raises without one unless given ``--device cpu`` (host ms, no device fields).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 50
STEP = "full ELBO fwd+bwd (1 train step)"
STAGES = ("gram+chol+draw+eval paths fwd", "FK sphere rollout fwd [B,S,N]", "FK sphere rollout fwd+bwd",
          "FK+SDF+hinge log_prob fwd", "FK+SDF+hinge log_prob fwd+bwd",
          "SDF+hinge on fixed positions fwd", "SDF+hinge on fixed positions fwd+bwd",
          "FK+quad-cost (no SDF) fwd+bwd", "full ELBO fwd", STEP)


def stage_fns(sess, B: int) -> dict:
    """Each stage as a call on inputs it holds, in :data:`STAGES` order."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.kinematics.dh import sphere_positions
    from vgpmp_torch.models import vgpmp as planner

    model, cfg, dev = sess.model, sess.train_config, sess.device
    col, fk = model.collision, model.collision.fk
    starts, goals = sess.queries()
    idx = np.arange(B) % len(starts)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    sb, gb = as_t(starts[idx]), as_t(goals[idx])
    params = solver.init_batch(model, starts[idx], goals[idx], sess.planner_params)
    S, N, L = model.num_samples, cfg.time_spacing_X, model.num_latent
    P = int(fk.sphere_radii.shape[0])
    X = torch.linspace(0.0, 1.0, N, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand((B, S, N, L), generator=torch.Generator(device=dev).manual_seed(1),
                   dtype=torch.float32, device=dev)
    cfgs = model.limits_low + (model.limits_high - model.limits_low) * u
    sig = torch.full((P,), 0.005, dtype=torch.float32, device=dev)
    q = cfgs.clone().requires_grad_(True)
    with torch.no_grad():
        pos = sphere_positions(fk, cfgs)  # [B, S, N, P, 3], fixed
    p_pos = pos.clone().requires_grad_(True)
    radii = fk.sphere_radii
    # the leaves a train step differentiates (a frozen σ_obs is not among them)
    leaves = [k for k in planner.PlannerParams.names() if k != "sigma_obs_u"]
    p_train = params.map(lambda x: x.detach().clone())
    for k in leaves:
        getattr(p_train, k).requires_grad_(True)

    def grad_of(f, x):
        return lambda: torch.autograd.grad(f(x).sum(), x)[0]

    def no_grad(f):
        def run():
            with torch.no_grad():
                return f()
        return run

    def paths():
        c = planner.constrain(params, model.variance_lower)
        q_mu_full = planner._q_mu_full(model, c, planner.query_latent(model, sb, gb))
        return planner._draw_eval(model, c, q_mu_full, planner._kuf(model, c, X), X, S, gen, None)[2]

    def sdf_hinge(p):
        cost = torch.clamp(col.epsilon - (col.scene.distance(p) - radii), min=0.0)
        return -0.5 * (cost * cost / sig).sum(dim=-1)

    def quad_cost(x):
        p = sphere_positions(fk, x)
        c = torch.clamp(0.05 - (p * p).sum(dim=-1), min=0.0)
        return -0.5 * (c * c / sig).sum(dim=-1)

    def step():
        value = planner.elbo(p_train, model, sb, gb, X, gen)
        return torch.autograd.grad(-value.sum(), [getattr(p_train, k) for k in leaves])

    fns = (no_grad(paths), no_grad(lambda: sphere_positions(fk, cfgs)),
           grad_of(lambda x: sphere_positions(fk, x), q),
           no_grad(lambda: col.log_prob(cfgs, sig)), grad_of(lambda x: col.log_prob(x, sig), q),
           no_grad(lambda: sdf_hinge(pos)), grad_of(sdf_hinge, p_pos), grad_of(quad_cost, q),
           no_grad(lambda: planner.elbo(params, model, sb, gb, X, gen)), step)
    return dict(zip(STAGES, fns))


def run(robot: str = "franka", env: str = "industrial", batch: int = 36, reps: int = REPS,
        device=None) -> dict:
    """Time every stage; returns the record ``main`` writes."""
    from vgpmp_torch import _build, resolve_device
    from vgpmp_torch.likelihoods.collision import k1_dsigma, k1_loglik
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.session import PlanningSession
    from vgpmp_torch.timing import card, time_stages

    device = resolve_device(device)
    if device.type == "cuda":
        _build.build()
    sess = PlanningSession(robot, env, dtype=torch.float32, device=device)
    model, cfg = sess.model, sess.train_config
    shapes = {"S": model.num_samples, "N": cfg.time_spacing_X, "L": model.num_latent,
              "P": int(model.collision.fk.sphere_radii.shape[0]), "M": model.num_inducing,
              "bases": model.num_bases}
    print(f"{robot}/{env}: B={batch} {shapes} solve_dtype={model.solve_dtype} "
          f"sdf_mode={sess.sdf_mode} reps={reps}", flush=True)
    counters = (k1_loglik, k1_dsigma, la.k2_factor_solve, la.k2_factor_solve_bwd, la.k2_trsm,
                la.k2_chol)
    for c in counters:
        c.launches = 0
    times = time_stages(stage_fns(sess, batch), reps, device)
    for name, t in times.items():
        dev_ms = "not measured" if t["device_ms"] is None else f"{t['device_ms']:9.4f} ms device"
        launches = "" if t["launches"] is None else f", {t['launches']:7.1f} launches"
        clock = "stream" if device.type == "cuda" else "host"
        print(f"{name:<42s} {t['stream_ms']:9.4f} ms {clock}, {dev_ms}{launches}", flush=True)
    total = times[STEP]["stream_ms"]
    print(f"projected {cfg.num_steps}-step optimize: {total * cfg.num_steps / 1e3:.2f} s for B={batch}",
          flush=True)
    return {
        "robot": robot, "env": env, "batch": batch, "shapes": shapes, "device": str(device),
        "stages_ms": {k: t["stream_ms"] for k, t in times.items()},
        "projected_full_optimize_seconds": total * cfg.num_steps / 1e3,
        "stages_device_ms": {k: t["device_ms"] for k, t in times.items()},
        "stages_launches": {k: t["launches"] for k, t in times.items()},
        "stages_kernels": {k: t["kernels"] for k, t in times.items()},
        "kernel_launches": {c.__name__: c.launches for c in counters},
        "reps": reps, "card": card(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robot", default="franka")
    ap.add_argument("--env", default="industrial")
    ap.add_argument("--batch", type=int, default=36)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--json-out", default=str(ROOT / "chiprun_out" / "profile_breakdown_torch.json"))
    ap.add_argument("--device", default=None, help="'cpu' for the plain path; default: CUDA")
    args = ap.parse_args(argv)
    out = run(args.robot, args.env, args.batch, args.reps, args.device)
    path = Path(args.json_out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
