"""Batched planning engine: training, extraction, the scored round and the
adaptive restart engine (port of ``vgpmp_tpu/engine/solver.py``).

The JAX engine vmaps a single-problem ``lax.scan`` over the batch; here the
batch is an explicit leading axis ``B`` and the Adam loop is a Python loop.
The optimiser is written out (:class:`BatchedAdam`) because its divergence
guard must act per problem row, with a step count per row, exactly as
``_guarded_step`` does under ``vmap``. Each step is labelled for
``torch.profiler`` (``elbo_forward``, ``elbo_backward``, ``adam_update``,
then ``extract``); the labels cost nothing while no profiler runs.
:func:`make_resumable_solver` splits a solve into ``init_state``, chunks of
steps on a checkpointable :class:`TrainState` and ``extract``;
:func:`make_batch_solver` is those three with one chunk, so both run one step
body. :func:`make_round_solver` adds the metric of every solved row (label
``validate``), :func:`make_ensemble_solver` keeps the best of K restarts per
problem, and :func:`solve_adaptive` drives rounds of the round solver, with
restarts only for the problems still unsolved.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from vgpmp_torch.convert import report_to_numpy
from vgpmp_torch.engine.validator import ValidationReport, _min_sphere_clearance, execute_and_validate
from vgpmp_torch.gp.pathwise import PathNoise
from vgpmp_torch.kinematics.dh import ee_positions
from vgpmp_torch.models import vgpmp as planner

__all__ = ["TrainConfig", "SolveResult", "SolveNoise", "BatchedAdam", "TrainState", "default_trainable",
           "lr_schedule", "random_timesteps", "make_single_solver", "make_batch_solver",
           "make_resumable_solver", "ensemble_score", "make_round_solver", "make_ensemble_solver",
           "solve_adaptive", "init_slots", "init_batch", "init_ensemble",
           "restart_waypoints", "restart_candidates", "pick_via_points", "min_clearance_probe",
           "worst_violation_configs"]


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
    step, the posterior extraction's and, under ``randomize_timesteps``, each
    row's training grid ``[B, N]`` (sorted, on ``[X[0], X[-1]]``)."""

    steps: List[PathNoise]
    posterior: PathNoise
    timesteps: Optional[torch.Tensor] = None


def random_timesteps(X: torch.Tensor, B: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One sorted uniform training grid per row, ``[B, N]`` on ``[X[0], X[-1])``:
    what the JAX solver draws once per solve from each row's own key (the
    reference's ``training_loop(randomize=True)``). The endpoints are not
    pinned."""
    u = torch.rand((B, X.shape[0]), dtype=X.dtype, device=X.device, generator=generator)
    return torch.sort(X[0] + (X[-1] - X[0]) * u, dim=1).values


def _normal_log_prob(x: torch.Tensor, mu: torch.Tensor, s: float) -> torch.Tensor:
    """Elementwise ``log N(x; mu, s²)``."""
    return -0.5 * ((x - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(2 * math.pi)


class SolveResult(NamedTuple):
    best: torch.Tensor          # [B, Nnew, L] best posterior sample (constrained)
    mean: torch.Tensor          # [B, Nnew, L] analytic posterior mean (constrained)
    best_score: torch.Tensor    # [B] collision log-density of the best sample
    elbo_history: torch.Tensor  # [B, num_steps]
    failed: torch.Tensor        # [B] bool: non-finite best trajectory or final ELBO
    samples: Optional[torch.Tensor] = None   # [B, K, Nnew, L] first samples
    logs: Optional[dict] = None              # per-step metrics when log_level >= 1
    ee_uncertainty: Optional[torch.Tensor] = None  # [B, Nnew, 3]


class TrainState(NamedTuple):
    """A batched solve between two Adam steps, checkpointable with
    :func:`vgpmp_torch.utils.checkpoint.save_train_state`: the parameters,
    :class:`BatchedAdam`'s moments and per-row step counts (which set the
    learning rate), the absolute step (which anneals σ_obs), each row's
    training grid and the log-prior anchors of a trainable σ_obs or alpha."""

    params: planner.PlannerParams
    mu: planner.PlannerParams
    nu: planner.PlannerParams
    count: torch.Tensor                   # [B] int64 Adam steps taken per row
    step: int                             # absolute step index
    X_train: torch.Tensor                 # [N], or [B, N] under randomize_timesteps
    anchors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (σ_obs [B, P], alpha [B])


def make_resumable_solver(model: planner.PlannerModel, cfg: TrainConfig,
                          trainable: Optional[dict] = None, keep_samples: int = 0,
                          sample_group=None):
    """The batched solve split into chunks that can be checkpointed mid-run
    (port of JAX's ``make_resumable_solver``), as three functions:

    - ``init_state(params0, generator=None, noise=None) -> TrainState``; under
      ``cfg.randomize_timesteps`` it draws each row's grid
      (:func:`random_timesteps`) from ``generator``, or takes
      ``noise.timesteps``;
    - ``train_chunk(state, starts, goals, generator=None, noise=None, n=None)
      -> (TrainState, elbo_history [B, n], logs)`` runs ``n`` Adam steps, by
      default ``len(noise.steps)``, drawing each step's paths from
      ``generator`` unless ``noise.steps`` gives them; ``logs`` holds the
      per-step metrics ``[B, n]`` when ``cfg.log_level >= 1``, else ``None``;
    - ``extract(state, starts, goals, generator=None, noise=None,
      elbo_history=None) -> SolveResult``, the posterior extraction (from
      ``noise.posterior`` when given); a row fails where its best trajectory,
      or the last entry of ``elbo_history``, is not finite.

    :func:`make_batch_solver` is these three with one chunk of
    ``cfg.num_steps`` steps, so the chunked and the one-shot solve run the
    same step: chunks of one run, with the same draws in the same order,
    give the one-shot result bit for bit.

    A trainable σ_obs or alpha adds its log-prior to the ELBO (as GPflow adds
    ``log_prior_density`` to the training loss): Normal(init, 1e-4) on the
    constrained σ_obs, Normal(init, 5) on alpha, anchored at each row's
    initial constrained value.

    ``sample_group``: a process group whose ranks cooperate on the Monte-Carlo
    samples of the same problems (``vgpmp_torch.parallel``). ``model.num_samples``
    and ``cfg.num_posterior_samples`` are then per-rank counts; the ELBO's
    likelihood mean and the best-sample selection are the group's
    (:func:`planner.elbo`, :func:`planner.select_best`), and each rank's
    parameters follow the gradient of its own samples, as in JAX.
    """
    trainable = trainable or default_trainable()
    prior_sigma, prior_alpha = bool(trainable.get("sigma_obs_u")), bool(trainable.get("alpha_u"))
    dtype, dev = model.dtype, model.device
    X = torch.linspace(0.0, 1.0, cfg.time_spacing_X, dtype=dtype, device=dev)
    Xnew = torch.linspace(0.0, 1.0, cfg.time_spacing_Xnew, dtype=dtype, device=dev)
    # leaves whose gradient is taken: all but a frozen σ (whose gradient only
    # the mask would zero); the mask then zeroes the other frozen leaves,
    # NaN*0 included, so that a NaN gradient skips the row's step as in JAX
    grad_leaves = [k for k in planner.PlannerParams.names()
                   if k != "sigma_obs_u" or prior_sigma]
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)

    def log_prior(p: planner.PlannerParams, anchors) -> torch.Tensor:
        """``[B]`` log-priors of the trainable σ_obs and alpha."""
        c = planner.constrain(p, model.variance_lower)
        lp = torch.zeros(p.q_mu.shape[0], dtype=dtype, device=dev)
        if prior_sigma:
            lp = lp + _normal_log_prob(c["sigma_obs"], anchors[0], 1e-4).sum(dim=-1)
        if prior_alpha:
            lp = lp + _normal_log_prob(c["alpha"], anchors[1], 5.0)
        return lp

    def sigma_scale(i: int) -> float:
        if cfg.sigma_anneal <= 1.0:
            return 1.0
        frac = i / max(cfg.num_steps - 1, 1)
        return float(cfg.sigma_anneal) ** (1.0 - frac)

    def init_state(params: planner.PlannerParams, generator: Optional[torch.Generator] = None,
                   noise: Optional[SolveNoise] = None) -> TrainState:
        params = params.map(lambda x: x.detach().clone())
        opt = BatchedAdam(cfg, params)
        anchors = None
        if prior_sigma or prior_alpha:
            c0 = planner.constrain(params, model.variance_lower)
            anchors = (c0["sigma_obs"], c0["alpha"])
        X_train = X
        if cfg.randomize_timesteps:
            if noise is not None:
                if noise.timesteps is None:
                    raise ValueError("randomize_timesteps: the injected noise has no timesteps")
                X_train = as_t(noise.timesteps)
            else:
                X_train = random_timesteps(X, params.q_mu.shape[0], generator)
        return TrainState(params, opt.mu, opt.nu, opt.count, 0, X_train, anchors)

    def train_chunk(state: TrainState, starts, goals, generator: Optional[torch.Generator] = None,
                    noise: Optional[SolveNoise] = None, n: Optional[int] = None):
        if n is None:
            if noise is None:
                raise ValueError("train_chunk: pass n, the number of steps, or noise.steps")
            n = len(noise.steps)
        starts, goals = as_t(starts), as_t(goals)
        params = state.params
        mask = _mask_pytree(params, trainable)
        opt = BatchedAdam(cfg, params)
        opt.mu, opt.nu, opt.count = state.mu, state.nu, state.count
        hist, logs = [], []
        for j in range(n):
            i = state.step + j
            p = params.map(lambda x: x.detach())
            for k in grad_leaves:
                getattr(p, k).requires_grad_(True)
            step_noise = noise.steps[j] if noise is not None else None
            with record_function("elbo_forward"):
                if cfg.log_level >= 1:
                    value, aux = planner.elbo_with_aux(p, model, starts, goals, state.X_train,
                                                       generator, step_noise, sigma_scale(i),
                                                       sample_group)
                    logs.append({k: v.detach() for k, v in aux.items()})
                else:
                    value = planner.elbo(p, model, starts, goals, state.X_train, generator,
                                         step_noise, sigma_scale(i), sample_group)
                if state.anchors is not None:
                    value = value + log_prior(p, state.anchors)
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
        state = state._replace(params=params, mu=opt.mu, nu=opt.nu, count=opt.count,
                               step=state.step + n)
        logs = {k: torch.stack([l[k] for l in logs], dim=1) for k in logs[0]} if logs else None
        return state, torch.stack(hist, dim=1), logs

    def extract(state: TrainState, starts, goals, generator: Optional[torch.Generator] = None,
                noise: Optional[SolveNoise] = None,
                elbo_history: Optional[torch.Tensor] = None) -> SolveResult:
        starts, goals = as_t(starts), as_t(goals)
        with torch.no_grad(), record_function("extract"):
            mean, best, samples, scores = planner.sample_from_posterior(
                state.params, model, starts, goals, Xnew, cfg.num_posterior_samples, generator,
                noise.posterior if noise is not None else None, sample_group=sample_group)
            ok = torch.isfinite(best).flatten(1).all(dim=1)
            if elbo_history is not None:
                ok = ok & torch.isfinite(elbo_history[:, -1])
            ee_unc = None
            if cfg.ee_uncertainty:
                ee = ee_positions(model.collision.fk, samples)  # [B, S, Nnew, 3]
                ee_unc = 2.0 * ee.std(dim=1, unbiased=False)
        if elbo_history is None:
            elbo_history = torch.zeros((best.shape[0], 0), dtype=dtype, device=dev)
        return SolveResult(
            best=best, mean=mean, best_score=scores.max(dim=1).values, elbo_history=elbo_history,
            failed=~ok, samples=samples[:, :keep_samples] if keep_samples else None,
            ee_uncertainty=ee_unc,
        )

    return init_state, train_chunk, extract


def make_batch_solver(model: planner.PlannerModel, cfg: TrainConfig,
                      trainable: Optional[dict] = None, keep_samples: int = 0,
                      sample_group=None):
    """Build ``solve_batch(params0, starts, goals, generator=None, noise=None)
    -> (params, SolveResult)`` over a leading problem axis ``B``: the
    resumable solver's three functions (:func:`make_resumable_solver`) with
    one chunk of ``cfg.num_steps`` steps.

    Each Adam step draws fresh pathwise samples from ``generator`` (one stream
    for the whole batch), unless ``noise`` (:class:`SolveNoise`) supplies them.
    With ``cfg.randomize_timesteps`` each row trains on its own sorted uniform
    grid (:func:`random_timesteps`), drawn once per solve before the steps'
    draws, or ``noise.timesteps``. ``sample_group`` is
    :func:`make_resumable_solver`'s.
    """
    init_state, train_chunk, extract = make_resumable_solver(model, cfg, trainable, keep_samples,
                                                             sample_group)

    def solve_batch(params: planner.PlannerParams, starts, goals,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[SolveNoise] = None):
        state = init_state(params, generator, noise)
        state, hist, logs = train_chunk(state, starts, goals, generator, noise, n=cfg.num_steps)
        res = extract(state, starts, goals, generator, noise, hist)
        return state.params, res._replace(logs=logs)

    return solve_batch


def make_single_solver(model: planner.PlannerModel, cfg: TrainConfig,
                       trainable: Optional[dict] = None, keep_samples: int = 0,
                       sample_group=None):
    """Build ``solve(params0, start, goal, generator=None, noise=None)`` for one
    problem: :func:`make_batch_solver` at ``B = 1``, with the batch axis
    taken off the result (``params0`` and ``noise`` carry it, as
    :func:`planner.init_params` gives them)."""
    solve_batch = make_batch_solver(model, cfg, trainable, keep_samples, sample_group)

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


def _flatten_noise(noise: SolveNoise, K: int, B: int) -> SolveNoise:
    """``[K, B, ...]`` draws as ``[K·B, ...]`` rows, member-major."""
    flat = lambda x: None if x is None else x.reshape((K * B,) + tuple(x.shape[2:]))
    path = lambda pn: PathNoise(*(flat(x) for x in pn))
    return SolveNoise(steps=[path(n) for n in noise.steps], posterior=path(noise.posterior),
                      timesteps=flat(noise.timesteps))


def make_ensemble_solver(model: planner.PlannerModel, cfg: TrainConfig,
                         trainable: Optional[dict] = None, keep_member_reports: bool = False):
    """Multi-restart solver: K inits per problem, the best *executed* one wins.

    Returns ``solve(params_kb, starts, goals, generator=None, noise=None) ->
    (best [B, Nnew, L], reports, chosen_init [B])``, where ``params_kb`` has a
    leading ``[K, B]`` axis (:func:`init_ensemble`) and ``noise`` (optional)
    a :class:`SolveNoise` whose draws lead with ``[K, B]`` too. The K·B rows
    are one batch solve, one :func:`execute_and_validate` and one
    :func:`ensemble_score` (float32); each problem keeps the member of
    highest score, the first init on a tie (as ``jnp.argmax``).
    ``reports`` are the chosen members', every field ``[B]``. With
    ``keep_member_reports`` the members' reports, every field ``[K, B]``, are
    appended to the returned tuple.
    """
    solve_batch = make_batch_solver(model, dataclasses.replace(cfg, ee_uncertainty=False), trainable)

    def solve(params_kb: planner.PlannerParams, starts, goals,
              generator: Optional[torch.Generator] = None, noise: Optional[SolveNoise] = None):
        K, B = params_kb.q_mu.shape[:2]
        starts = torch.as_tensor(starts, dtype=model.dtype, device=model.device).repeat(K, 1)
        goals = torch.as_tensor(goals, dtype=model.dtype, device=model.device).repeat(K, 1)
        params = params_kb.map(lambda x: x.reshape((K * B,) + tuple(x.shape[2:])))
        if noise is not None:
            noise = _flatten_noise(noise, K, B)
        _, res = solve_batch(params, starts, goals, generator, noise)
        with torch.no_grad(), record_function("validate"):
            reps = execute_and_validate(model.collision, res.best, starts, goals,
                                        model.limits_low, model.limits_high)
        score = ensemble_score(reps.executed, reps.success, reps.min_clearance).reshape(K, B)
        chosen = torch.argmax(score, dim=0)
        rows = chosen * B + torch.arange(B, device=chosen.device)
        pick = lambda fn: ValidationReport(**{k: None if v is None else fn(v)
                                              for k, v in reps._asdict().items()})
        out = (res.best[rows], pick(lambda v: v[rows]), chosen)
        if keep_member_reports:
            return out + (pick(lambda v: v.reshape(K, B)),)
        return out

    return solve


def min_clearance_probe(collision, flat: torch.Tensor) -> torch.Tensor:
    """Worst sphere clearance per configuration, ``[n, L] -> [n]``, by the
    session's training lookup (``collision.sphere_clearance``: the packed
    nearest cell on a packed session), not the metric's trilinear one."""
    with torch.no_grad():
        return _min_sphere_clearance(collision)(flat)


def worst_violation_configs(collision, trajs: np.ndarray) -> np.ndarray:
    """Deepest-violation configuration along each trajectory, ``[n, T, L] ->
    [n, L]`` float64: the config at the ``argmin`` over ``T`` of the worst
    sphere clearance. A NaN clearance counts as the minimum, as in
    ``jnp.argmin``."""
    fk = collision.fk
    q = torch.as_tensor(np.asarray(trajs), dtype=fk.sphere_radii.dtype, device=fk.sphere_radii.device)
    n, T, L = q.shape
    clear = min_clearance_probe(collision, q.reshape(n * T, L)).reshape(n, T)
    worst = q[torch.arange(n, device=q.device), clear.argmin(dim=1)]
    return worst.cpu().numpy().astype(np.float64)


def restart_candidates(model: planner.PlannerModel, starts: np.ndarray, goals: np.ndarray,
                       interp: str, n_cand: int = 64, anchors: Optional[np.ndarray] = None):
    """The numpy draws of via-point mode ``interp`` (see :func:`restart_waypoints`).

    ``rand<i>``: ``(via-points [B, L], None)``. ``frand<i>`` and ``detour<i>``:
    ``(candidates [B, n_cand, L], ref [B, L])``, where ``ref`` is the
    configuration the pick stays close to (the midpoint, or the anchor of a
    detour). ``None`` for a mode that is not a via-point mode.
    """
    detour = False
    if interp.startswith("detour"):
        suffix, biased, detour = interp[6:], True, anchors is not None
    elif interp.startswith("frand"):
        suffix, biased = interp[5:], True
    elif interp.startswith("rand"):
        suffix, biased = interp[4:], False
    else:
        return None
    if suffix and not suffix.isdigit():
        raise ValueError(
            f"via-point init mode {interp!r}: expected 'rand<i>'/'frand<i>'/"
            f"'detour<i>' with an integer suffix (e.g. 'rand0', 'frand3'), "
            f"got suffix {suffix!r}"
        )
    seed = int(suffix or 0)
    rng = np.random.default_rng((0xF00D if biased else 0xC0FFEE) + seed)
    lo = model.limits_low.cpu().numpy().astype(np.float64)
    hi = model.limits_high.cpu().numpy().astype(np.float64)
    pad = 0.15 * (hi - lo)
    B, L = len(starts), lo.shape[0]
    if not biased:
        return rng.uniform(lo + pad, hi - pad, size=(B, L)), None
    if detour:
        anc = np.asarray(anchors, np.float64)
        # successive detour restarts explore progressively wider deviations
        sigma = 0.35 + 0.1 * (seed % 5)
        cand = np.clip(anc[:, None, :] + rng.normal(scale=sigma, size=(B, n_cand, L)),
                       lo + pad, hi - pad)
        cand[:, 0] = np.clip(anc, lo + pad, hi - pad)  # keep the anchor itself
        return cand, anc
    cand = rng.uniform(lo + pad, hi - pad, size=(B, n_cand, L))
    return cand, 0.5 * (np.asarray(starts, np.float64) + np.asarray(goals, np.float64))


def pick_via_points(cand: np.ndarray, clear: np.ndarray, ref: np.ndarray,
                    margin: float = 0.03) -> np.ndarray:
    """One candidate per row, ``[B, n, L] -> [B, L]``: among candidates whose
    clearance ``clear [B, n]`` reaches ``margin``, the one closest to ``ref``;
    where none does, the clearest."""
    dist = np.linalg.norm(cand - ref[:, None, :], axis=-1)
    score = np.where(clear >= margin, -dist, -1e6 + clear)
    return np.take_along_axis(cand, np.argmax(score, axis=1)[:, None, None], axis=1)[:, 0, :]


def restart_waypoints(model: planner.PlannerModel, starts: np.ndarray, goals: np.ndarray,
                      interp: str, n_cand: int = 64, margin: float = 0.03,
                      anchors: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Per-problem via-points ``[B, L]`` (float64) for restart init mode ``interp``.

    - ``"rand<i>"``: uniform draw inside the 15 %-shrunk joint box, seeded by i;
    - ``"frand<i>"``: free-space-biased: ``n_cand`` uniform candidates per
      problem, their clearance in one :func:`min_clearance_probe` call, then
      :func:`pick_via_points` from the midpoint;
    - ``"detour<i>"``: Gaussian perturbations of ``anchors`` (the incumbent's
      deepest-violation configs, :func:`worst_violation_configs`), the anchor
      itself kept as candidate 0, picked from the anchor; without anchors
      it is ``frand``;
    - anything else: ``None``.

    The draws are numpy's (``default_rng``), so one suffix gives the same
    candidates in every package and on every device.
    """
    drawn = restart_candidates(model, starts, goals, interp, n_cand, anchors)
    if drawn is None:
        return None
    cand, ref = drawn
    if ref is None:
        return cand
    B, n, L = cand.shape
    flat = torch.as_tensor(cand.reshape(B * n, L), dtype=model.dtype, device=model.device)
    clear = min_clearance_probe(model.collision, flat).cpu().numpy().astype(np.float64)
    return pick_via_points(cand, clear.reshape(B, n), ref, margin)


def init_slots(model: planner.PlannerModel, starts: np.ndarray, goals: np.ndarray,
               planner_params: dict, modes: list,
               anchors: Optional[np.ndarray] = None) -> planner.PlannerParams:
    """Initial state with the q_mu init mode per row (``modes[j]`` for problem
    ``j``): ``linear``, ``zeros``, ``waypoint`` (the midpoint) or a via-point
    mode of :func:`restart_waypoints`, which draws once per distinct mode.
    ``anchors [B, L]`` feed the ``detour<i>`` rows. One
    :func:`planner.init_params_batch` call builds the batch."""
    starts = np.asarray(starts)
    goals = np.asarray(goals)
    mode_ids = np.zeros(len(starts), dtype=np.int64)
    wps = 0.5 * (starts + goals)  # an in-box via-point for the rows that need none
    groups: dict = {}
    for j, m in enumerate(modes):
        groups.setdefault(m, []).append(j)
    for m, idxs in groups.items():
        if m in planner.INIT_MODES:
            mode_ids[idxs] = planner.INIT_MODES[m]
            continue
        w = restart_waypoints(model, starts[idxs], goals[idxs], m,
                              anchors=None if anchors is None else anchors[idxs])
        if w is None:
            raise ValueError(f"unknown q_mu init mode {m!r}")
        mode_ids[idxs] = planner.INIT_MODES["waypoint"]
        wps[idxs] = w
    return planner.init_params_batch(
        model, starts, goals, mode_ids, wps,
        np.asarray(planner_params["lengthscales"], np.float64), float(planner_params["variance"]),
        float(planner_params["sigma_obs"]), float(planner_params["alpha"]))


def init_batch(model: planner.PlannerModel, starts: np.ndarray, goals: np.ndarray,
               planner_params: dict) -> planner.PlannerParams:
    """:func:`init_slots` with the linear q_mu init on every row."""
    return init_slots(model, starts, goals, planner_params, ["linear"] * len(np.asarray(starts)))


def init_ensemble(model: planner.PlannerModel, starts: np.ndarray, goals: np.ndarray,
                  planner_params: dict, inits: Tuple[str, ...] = ("linear", "zeros")
                  ) -> planner.PlannerParams:
    """:func:`init_slots` once per q_mu init mode of ``inits``, stacked:
    every leaf ``[K, B, ...]`` for :func:`make_ensemble_solver`."""
    B = len(np.asarray(starts))
    members = [init_slots(model, starts, goals, planner_params, [m] * B) for m in inits]
    return planner.PlannerParams(**{k: torch.stack([getattr(p, k) for p in members])
                                    for k in planner.PlannerParams.names()})


def _round_seed(seed: int, rnd: int) -> int:
    """The generator seed of round ``rnd`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence((seed, rnd)).generate_state(1)[0])


def solve_adaptive(model: planner.PlannerModel, cfg: TrainConfig, starts: np.ndarray,
                   goals: np.ndarray, planner_params: dict,
                   inits: Tuple[str, ...] = ("linear", "zeros"), max_rounds: int = 6,
                   seed: int = 0, trainable: Optional[dict] = None, solve=None,
                   round_sizes: Optional[Tuple[int, ...]] = None, slots_per_unsolved: int = 1):
    """Adaptive restart engine: rounds of one scored round solver
    (:func:`make_round_solver`), restarts only for problems still unsolved.

    - round 0 solves every problem from ``inits[0]``;
    - each later round fills a bucket of slots with restarts of the unsolved
      problems (the smallest of ``round_sizes`` that gives each of them
      ``slots_per_unsolved`` slots, capped at the largest; the packing offset
      rotates per round so that every unsolved problem gets slots): first the
      next of the first four configured inits, then failure-informed
      ``detour`` via-points around the incumbent's deepest violation in turn
      with the remaining inits and fresh ``frand`` draws;
    - per problem the best restart under :func:`ensemble_score` is kept; the
      loop ends once every problem has an executed trajectory.

    ``round_sizes`` defaults to ``(B, max(16, B // 4))``; every size is
    rounded up to a multiple of ``solve.dp_size`` where the solver has one.
    Round ``rnd`` draws from one generator on the model's device seeded from
    ``(seed, rnd)``, so one seed gives one result.

    Returns ``(best [B, Nnew, L] np.ndarray, reports, info)``: a
    :class:`ValidationReport` of numpy fields, and ``info = {"rounds",
    "spent", "k_eff", "restarts_per_problem"}``.
    """
    starts = np.asarray(starts)
    goals = np.asarray(goals)
    B = len(starts)
    if solve is None:
        solve = make_round_solver(model, cfg, trainable)
    mult = int(getattr(solve, "dp_size", 1) or 1)
    if round_sizes is None:
        tail = min(B, max(16, B // 4))
        round_sizes = (B, -(-tail // mult) * mult)
    else:
        round_sizes = tuple(min(-(-c // mult) * mult, -(-B // mult) * mult) for c in round_sizes)
    round_sizes = tuple(sorted(set(round_sizes), reverse=True))

    counters = np.zeros(B, dtype=int)  # restarts consumed per problem
    best_traj = best_score = merged = None
    spent = rounds = 0
    for rnd in range(max_rounds):
        anchors = None
        if rnd == 0:
            slot_prob = np.arange(B)
            modes = [inits[0]] * B
            counters[:] = 1
        else:
            unsolved = np.nonzero(~merged["executed"])[0]
            if unsolved.size == 0:
                break
            want = min(unsolved.size * slots_per_unsolved, round_sizes[0])
            C = next((c for c in sorted(round_sizes) if c >= want), round_sizes[0])
            slot_prob = unsolved[(np.arange(C) + rnd * C) % unsolved.size]
            modes = []
            need_anchor = False
            # the first few configured inits, then detours in turn with the rest
            head = min(len(inits), 4)
            for p_idx in slot_prob:
                r = int(counters[p_idx])
                if r < head:
                    modes.append(inits[r])
                else:
                    extra = r - head
                    if extra % 2 == 0:
                        # unique per (restart index, run seed)
                        modes.append(f"detour{1000 + 101 * seed + r}")
                        need_anchor = True
                    else:
                        rest = head + extra // 2
                        modes.append(inits[rest] if rest < len(inits)
                                     else f"frand{1000 + 101 * seed + r}")
                counters[p_idx] += 1
            if need_anchor:
                anchors = worst_violation_configs(model.collision, best_traj[slot_prob])
        params = init_slots(model, starts[slot_prob], goals[slot_prob], planner_params, modes,
                            anchors=anchors)
        gen = torch.Generator(device=model.device).manual_seed(_round_seed(seed, rnd))
        best_r, reps_r = solve(params, starts[slot_prob], goals[slot_prob], gen)
        spent += len(slot_prob)
        rounds += 1
        reps_r = report_to_numpy(reps_r)
        best_r = best_r.detach().cpu().numpy()
        score_r = ensemble_score(reps_r["executed"], reps_r["success"],
                                 reps_r["min_clearance"]).numpy().astype(np.float64)
        if merged is None:
            best_traj, best_score = best_r.copy(), score_r
            merged = {k: None if v is None else v.copy() for k, v in reps_r.items()}
            continue
        # ascending score, so that each problem's best slot lands last
        prob_best: dict = {}
        for j in np.argsort(score_r, kind="stable"):
            prob_best[int(slot_prob[j])] = int(j)
        probs = np.fromiter(prob_best.keys(), dtype=int)
        slots = np.fromiter(prob_best.values(), dtype=int)
        improve = score_r[slots] > best_score[probs]
        up, us = probs[improve], slots[improve]
        if up.size:
            best_score[up] = score_r[us]
            best_traj[up] = best_r[us]
            for k, m in merged.items():
                if m is not None:
                    m[up] = reps_r[k][us]
    info = {"rounds": rounds, "spent": spent, "k_eff": spent / B,
            "restarts_per_problem": counters.tolist()}
    return best_traj, ValidationReport(**merged), info
