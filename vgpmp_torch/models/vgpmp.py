"""vGPMP planner model: variational state, MC-ELBO, posterior extraction.

Port of ``vgpmp_tpu/models/vgpmp.py``. Where the JAX functions take one
problem and the engine vmaps them, these take an explicit leading problem
axis ``B`` on every parameter leaf and query: ``elbo`` returns ``[B]``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from vgpmp_torch.gp import conditioned, kl, pathwise, posterior, velocity
from vgpmp_torch.gp.pathwise import PathNoise
from vgpmp_torch.likelihoods.collision import CollisionModel, joint_sigmoid, joint_sigmoid_inverse
from vgpmp_torch.ops import kernels as kernel_ops
from vgpmp_torch.ops import linalg
from vgpmp_torch.ops import transforms as tf_ops
from vgpmp_torch.ops.transforms import (
    ALPHA_LOWER, SIGMA_OBS_LOWER, VARIANCE_LOWER, Z_HIGH, Z_LOW,
)
from vgpmp_torch.utils.profiling import span

__all__ = ["PlannerParams", "PlannerModel", "constrain", "init_params", "init_params_batch",
           "query_latent", "elbo", "elbo_with_aux", "sample_from_posterior", "sample_mean",
           "select_best", "INIT_MODES"]

INIT_MODES = {"linear": 0, "zeros": 1, "waypoint": 2}


@dataclass
class PlannerParams:
    """Unconstrained trainable state, one row per problem."""

    q_mu: torch.Tensor            # [B, M, L]
    q_sqrt: torch.Tensor          # [B, L, M, M] lower-tri via tril projection
    lengthscales_u: torch.Tensor  # [B, L] softplus
    variance_u: torch.Tensor      # [B, L] softplus + variance_lower
    z_u: torch.Tensor             # [B, M, L] sigmoid box (0.09, 0.91)
    sigma_obs_u: torch.Tensor     # [B, P] softplus + 1e-5
    alpha_u: torch.Tensor         # [B] softplus + 1e-4

    @staticmethod
    def names() -> Tuple[str, ...]:
        return tuple(f.name for f in fields(PlannerParams))

    def leaves(self) -> dict:
        return {k: getattr(self, k) for k in self.names()}

    def map(self, fn) -> "PlannerParams":
        return PlannerParams(**{k: fn(v) for k, v in self.leaves().items()})


@dataclass
class PlannerModel:
    """Static configuration + per-(robot, scene) constants."""

    collision: CollisionModel
    ny: torch.Tensor           # [C] conditioned timesteps (0, 1)
    limits_low: torch.Tensor   # [L]
    limits_high: torch.Tensor  # [L]
    num_samples: int = 7
    num_bases: int = 1024
    num_inducing: int = 14
    jitter: float = 1e-6
    solve_dtype: Optional[torch.dtype] = None  # island dtype; None -> the bulk dtype
    jitter_escalations: int = 0
    kernel: str = "matern52"
    antithetic: bool = False
    variance_lower: float = VARIANCE_LOWER
    # clamp the endpoint velocities to 0 beside the positions (gp/velocity.py)
    velocity_constrained: bool = False

    @property
    def num_latent(self) -> int:
        return self.limits_low.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.limits_low.dtype

    @property
    def device(self) -> torch.device:
        return self.limits_low.device


def constrain(params: PlannerParams, variance_lower: float = VARIANCE_LOWER) -> dict:
    """Apply all bijectors: unconstrained leaves -> model-space values."""
    return {
        "q_mu": params.q_mu,
        "q_sqrt": torch.tril(params.q_sqrt),
        "lengthscales": tf_ops.positive(params.lengthscales_u),
        "variance": tf_ops.positive(params.variance_u, variance_lower),
        "Z": tf_ops.sigmoid_box(params.z_u, Z_LOW, Z_HIGH),
        "sigma_obs": tf_ops.positive(params.sigma_obs_u, SIGMA_OBS_LOWER),
        "alpha": tf_ops.positive(params.alpha_u, ALPHA_LOWER),
    }


def init_params_batch(model: PlannerModel, starts, goals, mode_ids, waypoints, lengthscales,
                      variance, sigma_obs, alpha) -> PlannerParams:
    """Initial variational state for a batch, with the q_mu init mode per row
    (``mode_ids [B]``: 0 linear, 1 zeros, 2 waypoint; see :data:`INIT_MODES`).

    ``starts``, ``goals``, ``waypoints`` are ``[B, L]`` joint configurations.
    """
    L, M = model.num_latent, model.num_inducing
    P = model.collision.fk.sphere_radii.shape[0]
    lo, hi = model.limits_low, model.limits_high
    dt, dev = model.dtype, model.device
    as_t = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    starts, goals, waypoints = as_t(starts), as_t(goals), as_t(waypoints)
    mode_ids = torch.as_tensor(mode_ids, device=dev)
    B = starts.shape[0]

    ar = torch.arange(M, dtype=dt, device=dev)[None, :, None]
    lin = starts[:, None, :] + (goals - starts)[:, None, :] * (ar / M)
    frac_wp = ar / max(M - 1, 1)
    first = starts[:, None, :] + (waypoints - starts)[:, None, :] * torch.clamp(frac_wp * 2, max=1.0)
    second = waypoints[:, None, :] + (goals - waypoints)[:, None, :] * torch.clamp(frac_wp * 2 - 1.0, min=0.0)
    way = torch.where(frac_wp < 0.5, first, second)
    mid = mode_ids[:, None, None].expand(B, M, L)
    q_mu_c = torch.where(mid == 0, lin, way)
    q_mu = torch.where(mid == 1, torch.zeros_like(q_mu_c), joint_sigmoid_inverse(q_mu_c, lo, hi))

    z_grid = torch.linspace(0.1, 0.9, M, dtype=dt, device=dev)[:, None].repeat(1, L)
    rep = lambda x: x.expand((B,) + x.shape).clone()
    return PlannerParams(
        q_mu=q_mu,
        q_sqrt=rep(torch.eye(M, dtype=dt, device=dev)[None].repeat(L, 1, 1)),
        lengthscales_u=rep(tf_ops.positive_inverse(as_t(lengthscales))),
        variance_u=rep(tf_ops.positive_inverse(torch.full((L,), float(variance), dtype=dt, device=dev),
                                               model.variance_lower)),
        z_u=rep(tf_ops.sigmoid_box_inverse(z_grid, Z_LOW, Z_HIGH)),
        sigma_obs_u=rep(tf_ops.positive_inverse(torch.full((P,), float(sigma_obs), dtype=dt, device=dev),
                                                SIGMA_OBS_LOWER)),
        alpha_u=rep(tf_ops.positive_inverse(as_t(float(alpha)), ALPHA_LOWER)),
    )


def init_params(model: PlannerModel, start, goal, lengthscales, variance: float, sigma_obs: float,
                alpha: float, interpolation: str = "linear", waypoint=None) -> PlannerParams:
    """One problem's initial state, as a batch of one; ``interpolation`` is
    ``'linear'``, ``'zeros'`` or ``'waypoint'`` (default via-point: the midpoint)."""
    if interpolation not in INIT_MODES:
        raise ValueError(f"unknown q_mu interpolation {interpolation!r}")
    dt, dev = model.dtype, model.device
    start = torch.as_tensor(start, dtype=dt, device=dev)[None]
    goal = torch.as_tensor(goal, dtype=dt, device=dev)[None]
    wp = 0.5 * (start + goal) if waypoint is None else torch.as_tensor(waypoint, dtype=dt, device=dev)[None]
    return init_params_batch(model, start, goal, [INIT_MODES[interpolation]], wp, lengthscales,
                             variance, sigma_obs, alpha)


def query_latent(model: PlannerModel, start: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """Start/goal rows in latent space: ``[B, L] x 2 -> [B, C, L]``."""
    q = torch.stack([start, goal], dim=-2)
    return joint_sigmoid_inverse(q, model.limits_low, model.limits_high)


def _kuu(model: PlannerModel, c: dict) -> torch.Tensor:
    """The conditioned Gram with jitter, ``[B, L, Mc, Mc]``: the velocity-
    constrained one (``Mc = 2C + M``) where the model asks for it."""
    if not model.velocity_constrained:
        return conditioned.kuu(kernel_ops.KERNELS[model.kernel], model.ny, c["Z"], c["lengthscales"],
                               c["variance"], jitter=model.jitter, solve_dtype=model.solve_dtype)
    if model.kernel != "matern52":
        raise ValueError("velocity conditioning supports matern52 only")
    return velocity.kuu_velocity(model.ny, c["Z"], c["lengthscales"], c["variance"],
                                 jitter=model.jitter, solve_dtype=model.solve_dtype)


def _gram(model: PlannerModel, c: dict, with_info: bool = False):
    if model.velocity_constrained:
        # factored once, with no jitter escalation, as JAX does
        Kuu = _kuu(model, c)
        chol = linalg.chol(Kuu)
        if with_info:
            return Kuu, chol, torch.zeros(Kuu.shape[:-3], dtype=torch.int32, device=Kuu.device)
        return Kuu, chol
    return conditioned.cholesky_kuu(
        kernel_ops.KERNELS[model.kernel], model.ny, c["Z"], c["lengthscales"], c["variance"],
        jitter=model.jitter, solve_dtype=model.solve_dtype,
        escalations=model.jitter_escalations, with_info=with_info,
    )


def _kuf(model: PlannerModel, c: dict, X: torch.Tensor) -> torch.Tensor:
    if model.velocity_constrained:
        return velocity.kuf_velocity(model.ny, c["Z"], X, c["lengthscales"], c["variance"],
                                     solve_dtype=model.solve_dtype)
    return conditioned.kuf(kernel_ops.KERNELS[model.kernel], model.ny, c["Z"], X,
                           c["lengthscales"], c["variance"], solve_dtype=model.solve_dtype)


def _draw_eval(model: PlannerModel, c: dict, q_mu_full, Kuf, X, num_samples, generator, noise,
               antithetic: bool = False):
    """``(chol, escalation count [B], latent samples [B, S, N, L], whitened
    mean L⁻¹ q_mu_fullᵀ [B, L, Mc, 1])`` on the grid ``X`` with ``Kuf =
    _kuf(model, c, X)``. Without jitter escalation the factorisation and every
    solve that shares it (the draw, ``Kuf``, the variational mean for the KL)
    are one fused call; with it the factor may be replaced per row after the
    first attempt, so the calls stay apart. The velocity-constrained Gram never
    escalates (as in JAX), so it always takes the fused call."""
    deriv_mask = (velocity.deriv_mask(model.ny.shape[0], model.num_inducing, model.device)
                  if model.velocity_constrained else None)
    draw = dict(num_samples=num_samples, num_bases=model.num_bases, jitter=model.jitter,
                kernel=model.kernel, antithetic=antithetic, generator=generator, noise=noise,
                deriv_mask=deriv_mask)
    if model.jitter_escalations == 0 or model.velocity_constrained:
        with span("model.gram"):
            Kuu = _kuu(model, c)
        chol, _, f, m_w = pathwise.draw_and_eval_paths(
            model.ny, c["Z"], c["lengthscales"], c["variance"], Kuu, Kuf, X, q_mu_full, c["q_sqrt"],
            **draw)
        return chol, torch.zeros(Kuu.shape[:-3], dtype=torch.int32, device=Kuu.device), f, m_w
    _, chol, esc = _gram(model, c, with_info=True)
    state = pathwise.draw_paths(model.ny, c["Z"], c["lengthscales"], c["variance"], chol, q_mu_full,
                                c["q_sqrt"], **draw)
    with span("model.k2"):
        m_w = linalg.solve_lower(chol, q_mu_full.transpose(-1, -2)[..., None].to(chol.dtype))
    return chol, esc, pathwise.eval_paths(state, Kuf, X), m_w


def _q_mu_full(model: PlannerModel, c: dict, q_lat: torch.Tensor) -> torch.Tensor:
    """The full mean ``[B, Mc, L]``: the clamped rows (the zero endpoint
    velocities in velocity mode, then the query states) and ``q_mu``."""
    if model.velocity_constrained:
        return velocity.extend_q_mu(torch.zeros_like(q_lat), q_lat, c["q_mu"])
    return torch.cat([q_lat, c["q_mu"]], dim=-2)


def _sample_configs(params, model, start, goal, X, num_samples, generator, noise, antithetic):
    """``(constrained leaves, KL [B], escalation count [B], configurations
    [B, S, N, L])``, each stage under its ``torch.profiler`` label:
    ``model.gram`` (the Gram and Kuf builds), ``model.rff`` (the pathwise
    draw and evaluation), ``model.k2`` (the factor and its solves),
    ``model.collision`` (from here on the likelihood) and ``model.kl``."""
    with span("model.gram"):
        c = constrain(params, model.variance_lower)
        q_lat = query_latent(model, start, goal)
        q_mu_full = _q_mu_full(model, c, q_lat)
        Kuf = _kuf(model, c, X)
    chol, esc, f, m_w = _draw_eval(model, c, q_mu_full, Kuf, X, num_samples, generator, noise,
                                   antithetic)
    with span("model.collision"):
        g = joint_sigmoid(f, model.limits_low, model.limits_high)  # [B, S, N, L]
    with span("model.kl"):
        kl_term = kl.prior_kl_whitened(m_w, c["q_sqrt"].to(chol.dtype))
    return c, kl_term, esc, g


class _SampleMean(torch.autograd.Function):
    """The mean over a sample group's ranks: ``all_reduce(SUM) / n`` forward,
    the gradient unchanged backward. That is what JAX's ``pmean`` under
    ``shard_map(..., check_vma=False)`` computes: each shard's parameters
    receive the gradient of its own samples only, not of the mean."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)  # NCCL takes contiguous tensors only
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sample_mean(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` averaged over the ranks of the sample group ``group`` (identity
    without one); see :class:`_SampleMean` for its gradient."""
    return x if group is None else _SampleMean.apply(x, group)


def elbo(params: PlannerParams, model: PlannerModel, start: torch.Tensor, goal: torch.Tensor,
         X: torch.Tensor, generator: Optional[torch.Generator] = None,
         noise: Optional[PathNoise] = None, sigma_scale: float = 1.0,
         sample_group=None) -> torch.Tensor:
    """Monte-Carlo ELBO per problem, ``[B]``.

    ``start``/``goal [B, L]``, ``X [N]`` or one grid per problem ``[B, N]``
    (``randomize_timesteps``); the sample draws come from
    ``generator`` unless ``noise`` gives them. ``sigma_scale`` multiplies
    σ_obs (the solver's annealing factor; 1.0 is the exact objective).

    ``sample_group``: a process group whose ranks each draw
    ``model.num_samples`` samples of the same problems; the likelihood's
    sample mean is averaged over it (:func:`sample_mean`) before the sum over
    the grid, as JAX's ``sample_axis`` does.
    """
    c, kl_term, _, g = _sample_configs(params, model, start, goal, X, model.num_samples,
                                       generator, noise, model.antithetic)
    with span("model.collision"):
        lik = model.collision.log_prob(g, c["sigma_obs"] * sigma_scale)  # [B, S, N]
        lik_sum = sample_mean(lik.mean(dim=1), sample_group).sum(dim=-1)
        return lik_sum * c["alpha"] - kl_term.to(lik.dtype)


def elbo_with_aux(params: PlannerParams, model: PlannerModel, start, goal, X,
                  generator: Optional[torch.Generator] = None, noise: Optional[PathNoise] = None,
                  sigma_scale: float = 1.0, sample_group=None):
    """ELBO plus per-problem metrics: KL, expected log-likelihood, min
    clearance, mean hinge cost and the jitter-escalation count. Under
    ``sample_group`` (see :func:`elbo`) the clearance and the hinge cost stay
    this rank's own."""
    c, kl_term, esc, g = _sample_configs(params, model, start, goal, X, model.num_samples,
                                         generator, noise, model.antithetic)
    with span("model.collision"):
        clearance = model.collision.sphere_clearance(g)  # [B, S, N, P]
        cost = torch.clamp(model.collision.epsilon - clearance, min=0.0)
        sigma = (c["sigma_obs"] * sigma_scale)[:, None, None, :]
        lik = -0.5 * (cost * cost / sigma).sum(dim=-1)
        lik_total = sample_mean(lik.mean(dim=1), sample_group).sum(dim=-1)
        kl_term = kl_term.to(lik.dtype)
        value = lik_total * c["alpha"] - kl_term
        aux = {
            "kl": kl_term,
            "expected_log_lik": lik_total,
            "min_clearance": clearance.flatten(1).min(dim=1).values,
            "mean_hinge_cost": cost.flatten(1).mean(dim=1),
            "jitter_escalations": esc,
        }
    return value, aux


def sample_from_posterior(params: PlannerParams, model: PlannerModel, start, goal,
                          Xnew: torch.Tensor, num_samples: int = 150,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[PathNoise] = None, chunk: int = 16, sample_group=None):
    """Posterior extraction per problem.

    Returns (mean ``[B, Nnew, L]``, best sample ``[B, Nnew, L]``, samples
    ``[B, S, Nnew, L]``, per-sample collision log-density ``[B, S]``); best is
    the argmax of the summed log-density, scored ``chunk`` samples at a time.
    Under ``sample_group`` ``num_samples`` is this rank's count and the best
    sample is the group's (:func:`select_best`).
    """
    c = constrain(params, model.variance_lower)
    q_lat = query_latent(model, start, goal)
    q_mu_full = _q_mu_full(model, c, q_lat)
    Kuf = _kuf(model, c, Xnew)
    chol, _, f, _ = _draw_eval(model, c, q_mu_full, Kuf, Xnew, num_samples, generator, noise)
    sd = chol.dtype
    kff = c["variance"].to(sd)[..., None].expand(Kuf.shape[:-2] + Kuf.shape[-1:])
    mean_lat, _ = posterior.predict_f(chol, Kuf, kff, q_mu_full.to(sd), c["q_sqrt"].to(sd),
                                      jitter=model.jitter)
    mean = joint_sigmoid(mean_lat.to(q_lat.dtype), model.limits_low, model.limits_high)

    samples = joint_sigmoid(f, model.limits_low, model.limits_high)
    scores = torch.cat([
        model.collision.log_prob(samples[:, i:i + chunk], c["sigma_obs"]).sum(dim=-1)
        for i in range(0, num_samples, chunk)
    ], dim=1)
    return mean, select_best(scores, samples, sample_group), samples, scores


def select_best(scores: torch.Tensor, samples: torch.Tensor, group=None) -> torch.Tensor:
    """Each row's sample of highest score, ``[B, S] x [B, S, ...] -> [B, ...]``,
    the first on a tie and the first NaN where there is one (``jnp.argmax``).

    Under a sample group ``group`` every rank takes its own winner, and the
    group's winner is the rank of highest winning score, the lowest rank on a
    tie, as JAX's all-gather and argmax over the sample axis pick it. Three
    all-reduces find it: MAX of (any NaN, score), MIN of the candidate ranks,
    then SUM of the winner's sample and zeros elsewhere, which is exact and
    keeps the losing ranks' NaN out. Every rank returns the same rows.
    """
    rows = torch.arange(samples.shape[0], device=samples.device)
    idx = torch.argmax(scores, dim=1)
    best = samples[rows, idx]
    if group is None:
        return best
    score = scores[rows, idx]
    nan = torch.isnan(score)
    top = torch.stack([nan.to(score.dtype), torch.where(nan, float("-inf"), score)], dim=1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    mine = torch.where(top[:, 0] > 0, nan, score == top[:, 1])
    k, n = dist.get_rank(group), dist.get_world_size(group)
    winner = torch.where(mine, float(k), float(n)).to(score.dtype)
    dist.all_reduce(winner, op=dist.ReduceOp.MIN, group=group)
    win = (winner == k).reshape((-1,) + (1,) * (best.ndim - 1))
    best = torch.where(win, best, torch.zeros_like(best)).contiguous()
    dist.all_reduce(best, group=group)
    return best
