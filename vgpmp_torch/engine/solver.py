"""Batched planning engine: training, extraction and the scored round (port of
``vgpmp_tpu/engine/solver.py`` without the adaptive restart engine).

The JAX engine vmaps a single-problem ``lax.scan`` over the batch; here the
batch is an explicit leading axis ``B`` and the Adam loop is a Python loop.
The optimiser is written out (:class:`BatchedAdam`) because its divergence
guard must act per problem row, with a step count per row, exactly as
``_guarded_step`` does under ``vmap``. Each step is labelled for
``torch.profiler`` (``elbo_forward``, ``elbo_backward``, ``adam_update``,
then ``extract``); the labels cost nothing while no profiler runs.
:func:`make_round_solver` adds the metric of every solved row (label
``validate``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch
from torch.profiler import record_function

from vgpmp_torch.engine.validator import execute_and_validate
from vgpmp_torch.gp.pathwise import PathNoise
from vgpmp_torch.kinematics.dh import ee_positions
from vgpmp_torch.models import vgpmp as planner

__all__ = ["TrainConfig", "SolveResult", "SolveNoise", "BatchedAdam", "default_trainable",
           "lr_schedule", "make_single_solver", "make_batch_solver", "ensemble_score",
           "make_round_solver"]


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule (see the JAX ``TrainConfig`` for each field's origin)."""

    num_steps: int = 130
    learning_rate: float = 0.09
    beta1: float = 0.8
    beta2: float = 0.95
    # lr_peak > 0: warmup-cosine schedule 0 -> lr_peak (warmup_steps) -> learning_rate
    lr_peak: float = 0.0
    warmup_steps: int = 10
    # sigma_anneal > 1: σ_obs times a factor decaying geometrically sigma_anneal -> 1
    sigma_anneal: float = 1.0
    time_spacing_X: int = 70
    time_spacing_Xnew: int = 150
    num_posterior_samples: int = 150
    # 0: ELBO only; 1: also per-step KL / expected log-lik / min clearance / hinge
    log_level: int = 0
    # 2-sigma end-effector spread across the posterior samples
    ee_uncertainty: bool = True
    randomize_timesteps: bool = False


def default_trainable() -> dict:
    """Benchmark trainable mask."""
    return {"q_mu": True, "q_sqrt": True, "lengthscales_u": True, "variance_u": True,
            "z_u": False, "sigma_obs_u": False, "alpha_u": False}


def _mask_pytree(params: planner.PlannerParams, trainable: dict) -> planner.PlannerParams:
    return planner.PlannerParams(**{
        k: torch.full_like(getattr(params, k), 1.0 if trainable[k] else 0.0) for k in trainable
    })


def lr_schedule(cfg: TrainConfig, count: torch.Tensor) -> torch.Tensor:
    """Learning rate at integer step ``count``: constant, or optax's
    ``warmup_cosine_decay_schedule(0, lr_peak, warmup, num_steps, learning_rate)``."""
    count = count.to(torch.float64)
    if cfg.lr_peak <= 0.0:
        return torch.full_like(count, cfg.learning_rate)
    warmup = min(cfg.warmup_steps, max(cfg.num_steps - 1, 1))
    peak, end = cfg.lr_peak, cfg.learning_rate
    frac = 1.0 - torch.clamp(count, 0.0, float(warmup)) / warmup
    warm = (0.0 - peak) * frac + peak
    decay_steps = float(cfg.num_steps - warmup)
    alpha = end / peak
    c = torch.clamp(count - warmup, max=decay_steps)
    cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
    cos_lr = peak * ((1 - alpha) * cosine + alpha)
    return torch.where(count < warmup, warm, cos_lr)


class BatchedAdam:
    """optax.adam (b1, b2, eps 1e-8) with a per-row divergence guard.

    A row whose update has any non-finite entry keeps its parameters, its
    moments and its step count; every other row advances. Healthy rows are
    updated as ``optax.adam`` followed by ``optax.apply_updates`` would.
    """

    def __init__(self, cfg: TrainConfig, params: planner.PlannerParams, eps: float = 1e-8):
        self.cfg, self.eps = cfg, eps
        self.mu = params.map(torch.zeros_like)
        self.nu = params.map(torch.zeros_like)
        B = params.q_mu.shape[0]
        self.count = torch.zeros(B, dtype=torch.int64, device=params.q_mu.device)

    def step(self, params: planner.PlannerParams, grads: planner.PlannerParams) -> planner.PlannerParams:
        b1, b2 = self.cfg.beta1, self.cfg.beta2
        P, G = params.leaves(), grads.leaves()
        cnt = self.count + 1
        lr = lr_schedule(self.cfg, self.count)
        mu, nu, upd = {}, {}, {}
        finite = torch.ones_like(self.count, dtype=torch.bool)
        for k, p in P.items():
            g = G[k]
            mu[k] = (1 - b1) * g + b1 * getattr(self.mu, k)
            nu[k] = (1 - b2) * g * g + b2 * getattr(self.nu, k)
            shape = (-1,) + (1,) * (p.ndim - 1)
            bc1 = (1 - b1 ** cnt.to(torch.float64)).to(p.dtype).reshape(shape)
            bc2 = (1 - b2 ** cnt.to(torch.float64)).to(p.dtype).reshape(shape)
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            upd[k] = -lr.to(p.dtype).reshape(shape) * u
            finite &= torch.isfinite(upd[k]).reshape(p.shape[0], -1).all(dim=1)

        def keep(new, old):
            return torch.where(finite.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)

        self.mu = planner.PlannerParams(**{k: keep(mu[k], getattr(self.mu, k)) for k in P})
        self.nu = planner.PlannerParams(**{k: keep(nu[k], getattr(self.nu, k)) for k in P})
        self.count = torch.where(finite, cnt, self.count)
        return planner.PlannerParams(**{k: keep(P[k] + upd[k], P[k]) for k in P})


class SolveNoise(NamedTuple):
    """Injected draws for one batched solve: one :class:`PathNoise` per Adam
    step, and the posterior extraction's."""

    steps: List[PathNoise]
    posterior: PathNoise


class SolveResult(NamedTuple):
    best: torch.Tensor          # [B, Nnew, L] best posterior sample (constrained)
    mean: torch.Tensor          # [B, Nnew, L] analytic posterior mean (constrained)
    best_score: torch.Tensor    # [B] collision log-density of the best sample
    elbo_history: torch.Tensor  # [B, num_steps]
    failed: torch.Tensor        # [B] bool: non-finite best trajectory or final ELBO
    samples: Optional[torch.Tensor] = None   # [B, K, Nnew, L] first samples
    logs: Optional[dict] = None              # per-step metrics when log_level >= 1
    ee_uncertainty: Optional[torch.Tensor] = None  # [B, Nnew, 3]


def make_batch_solver(model: planner.PlannerModel, cfg: TrainConfig,
                      trainable: Optional[dict] = None, keep_samples: int = 0):
    """Build ``solve_batch(params0, starts, goals, generator=None, noise=None)
    -> (params, SolveResult)`` over a leading problem axis ``B``.

    Each Adam step draws fresh pathwise samples from ``generator`` (one stream
    for the whole batch), unless ``noise`` (:class:`SolveNoise`) supplies them.
    """
    if cfg.randomize_timesteps:
        raise NotImplementedError("randomize_timesteps is not ported yet")
    trainable = trainable or default_trainable()
    if trainable.get("sigma_obs_u") or trainable.get("alpha_u"):
        raise NotImplementedError("trainable sigma_obs/alpha (their log-priors) are not ported yet")
    dtype, dev = model.dtype, model.device
    X = torch.linspace(0.0, 1.0, cfg.time_spacing_X, dtype=dtype, device=dev)
    Xnew = torch.linspace(0.0, 1.0, cfg.time_spacing_Xnew, dtype=dtype, device=dev)
    # leaves whose gradient is taken: all but the frozen σ (K1 does not
    # differentiate σ); the mask then zeroes the frozen ones, NaN*0 included
    grad_leaves = [k for k in planner.PlannerParams.names() if k != "sigma_obs_u"]

    def sigma_scale(i: int) -> float:
        if cfg.sigma_anneal <= 1.0:
            return 1.0
        frac = i / max(cfg.num_steps - 1, 1)
        return float(cfg.sigma_anneal) ** (1.0 - frac)

    def solve_batch(params: planner.PlannerParams, starts, goals,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[SolveNoise] = None):
        starts = torch.as_tensor(starts, dtype=dtype, device=dev)
        goals = torch.as_tensor(goals, dtype=dtype, device=dev)
        params = params.map(lambda x: x.detach().clone())
        mask = _mask_pytree(params, trainable)
        opt = BatchedAdam(cfg, params)
        hist, logs = [], []
        for i in range(cfg.num_steps):
            p = params.map(lambda x: x.detach())
            for k in grad_leaves:
                getattr(p, k).requires_grad_(True)
            step_noise = noise.steps[i] if noise is not None else None
            with record_function("elbo_forward"):
                if cfg.log_level >= 1:
                    value, aux = planner.elbo_with_aux(p, model, starts, goals, X, generator,
                                                       step_noise, sigma_scale(i))
                    logs.append({k: v.detach() for k, v in aux.items()})
                else:
                    value = planner.elbo(p, model, starts, goals, X, generator, step_noise,
                                         sigma_scale(i))
            with record_function("elbo_backward"):
                gl = torch.autograd.grad(-value.sum(), [getattr(p, k) for k in grad_leaves])
            with record_function("adam_update"):
                g = dict(zip(grad_leaves, gl))
                grads = planner.PlannerParams(**{
                    k: (g[k] if k in g else torch.zeros_like(v)) * getattr(mask, k)
                    for k, v in p.leaves().items()
                })
                params = opt.step(params, grads)
            hist.append(value.detach())
        elbo_hist = torch.stack(hist, dim=1)

        with torch.no_grad(), record_function("extract"):
            mean, best, samples, scores = planner.sample_from_posterior(
                params, model, starts, goals, Xnew, cfg.num_posterior_samples, generator,
                noise.posterior if noise is not None else None)
            failed = ~(torch.isfinite(best).flatten(1).all(dim=1) & torch.isfinite(elbo_hist[:, -1]))
            ee_unc = None
            if cfg.ee_uncertainty:
                ee = ee_positions(model.collision.fk, samples)  # [B, S, Nnew, 3]
                ee_unc = 2.0 * ee.std(dim=1, unbiased=False)
        result = SolveResult(
            best=best, mean=mean, best_score=scores.max(dim=1).values, elbo_history=elbo_hist,
            failed=failed, samples=samples[:, :keep_samples] if keep_samples else None,
            logs={k: torch.stack([l[k] for l in logs], dim=1) for k in logs[0]} if logs else None,
            ee_uncertainty=ee_unc,
        )
        return params, result

    return solve_batch


def make_single_solver(model: planner.PlannerModel, cfg: TrainConfig,
                       trainable: Optional[dict] = None, keep_samples: int = 0):
    """Build ``solve(params0, start, goal, generator=None, noise=None)`` for one
    problem: :func:`make_batch_solver` at ``B = 1``, with the batch axis
    taken off the result (``params0`` and ``noise`` carry it, as
    :func:`planner.init_params` gives them)."""
    solve_batch = make_batch_solver(model, cfg, trainable, keep_samples)

    def solve(params, start, goal, generator=None, noise=None):
        dt, dev = model.dtype, model.device
        start = torch.as_tensor(start, dtype=dt, device=dev)[None]
        goal = torch.as_tensor(goal, dtype=dt, device=dev)[None]
        params, res = solve_batch(params, start, goal, generator, noise)
        first = lambda x: None if x is None else x[0]
        return params, SolveResult(
            best=res.best[0], mean=res.mean[0], best_score=res.best_score[0],
            elbo_history=res.elbo_history[0], failed=res.failed[0], samples=first(res.samples),
            logs={k: v[0] for k, v in res.logs.items()} if res.logs else None,
            ee_uncertainty=first(res.ee_uncertainty),
        )

    return solve


def ensemble_score(executed, success, min_clearance) -> torch.Tensor:
    """Restart-selection score: physical execution dominates, then the
    geometric verdict, then the worst clearance as the tie-breaker. Computed in
    float32 whatever the inputs' dtype, so that exact ties resolve the same
    everywhere: the clearance, clipped to +-8 m, maps into [-0.5, 0.5] under
    unit-scale tiers, where float32 spacing is about 1 um of clearance. A
    diverged (NaN) row scores ``-inf``."""
    f32 = lambda x: torch.as_tensor(x).to(torch.float32)
    score = (f32(executed) * 4.0 + f32(success) * 2.0
             + torch.clamp(f32(min_clearance), -8.0, 8.0) / 16.0)
    return torch.where(torch.isnan(score), torch.full_like(score, float("-inf")), score)


def make_round_solver(model: planner.PlannerModel, cfg: TrainConfig,
                      trainable: Optional[dict] = None):
    """One scored round: batch-solve ``[B]`` problems and score each row's best
    sample with the geometric validator and the physical execution metric
    (:func:`vgpmp_torch.engine.validator.execute_and_validate`).

    Returns ``solve(params0, starts, goals, generator=None, noise=None) ->
    (best [B, Nnew, L], reports)``, every report field ``[B]``.
    """
    # the round consumes only (best, reports): skip the EE-uncertainty FK pass
    solve_batch = make_batch_solver(model, dataclasses.replace(cfg, ee_uncertainty=False), trainable)

    def solve(params: planner.PlannerParams, starts, goals,
              generator: Optional[torch.Generator] = None, noise: Optional[SolveNoise] = None):
        starts = torch.as_tensor(starts, dtype=model.dtype, device=model.device)
        goals = torch.as_tensor(goals, dtype=model.dtype, device=model.device)
        _, res = solve_batch(params, starts, goals, generator, noise)
        with torch.no_grad(), record_function("validate"):
            reports = execute_and_validate(model.collision, res.best, starts, goals,
                                           model.limits_low, model.limits_high)
        return res.best, reports

    return solve
