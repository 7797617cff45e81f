"""Decoupled (pathwise) posterior sampling — port of ``vgpmp_tpu/gp/pathwise.py``.

    f(x) = Φ(x) w  +  k(x, Zy) Kuu⁻¹ (u − Φ(Zy) w)

with random Fourier features Φ of the Matérn-5/2 prior and
``u ~ N(q_mu_full, Λ Λᵀ)``, ``Λ = chol(Kuu) pad(q_sqrt) + jitter-pad``. The
update coefficients are stored half-whitened (``a = L⁻¹(u − Φ(Z)w)``), so only
the small triangular solves run in the float64 island.

Randomness comes from an explicit ``torch.Generator``; every draw can instead
be passed in through :class:`PathNoise`, which is how the tests feed both
packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vgpmp_torch.gp.conditioned import zy as zy_fn
from vgpmp_torch.ops import linalg

__all__ = ["PathNoise", "PathState", "student_t", "whitened_scale", "draw_paths", "eval_paths",
           "draw_and_eval_paths"]

TWO_PI = 6.283185307179586


class PathNoise(NamedTuple):
    """The draws behind one :func:`draw_paths` call (leading batch axes ``...``).

    ``t [..., L, B]``: the spectral draw before the lengthscale division
    (Student-t for Matérn, normal for SE); ``phase [..., L, B]``;
    ``w [..., S, L, B]``; ``eps [..., S, L, Mc]`` (after any antithetic pairing).
    """

    t: torch.Tensor
    phase: torch.Tensor
    w: torch.Tensor
    eps: torch.Tensor


class PathState(NamedTuple):
    omega: torch.Tensor      # [..., L, B] RFF frequencies
    phase: torch.Tensor      # [..., L, B]
    w: torch.Tensor          # [..., S, L, B] prior basis weights
    a: torch.Tensor          # [..., S, L, Mc] half-whitened update coefficients
    rff_scale: torch.Tensor  # [..., L, 1] sqrt(2 s2 / B)
    chol: torch.Tensor       # [..., L, Mc, Mc] chol(Kuu), island dtype


def student_t(df: float, shape, dtype, device, generator: Optional[torch.Generator] = None,
              u: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Student-t(df) draws by Bailey's polar method,
    ``T = sqrt(df (U^(-2/df) − 1)) cos(2π V)`` with ``U`` in (0, 1] and
    ``V`` in [0, 1). ``u``/``v`` replace the uniform draws when given."""
    if u is None:
        u = 1.0 - torch.rand(shape, dtype=dtype, device=device, generator=generator)
    if v is None:
        v = torch.rand(shape, dtype=dtype, device=device, generator=generator)
    r = torch.sqrt(df * (u ** (-2.0 / df) - 1.0))
    return r * torch.cos(TWO_PI * v)


def whitened_scale(chol_kuu: torch.Tensor, q_sqrt: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """Conditioned covariance factor ``Λ = chol(Kuu) pad(q_sqrt) + jitter-pad``."""
    Mc = chol_kuu.shape[-1]
    M = q_sqrt.shape[-1]
    C = Mc - M
    pad = torch.zeros(chol_kuu.shape, dtype=chol_kuu.dtype, device=chol_kuu.device)
    pad[..., C:, C:] = torch.tril(q_sqrt).to(chol_kuu.dtype)
    cond = (torch.arange(Mc, device=chol_kuu.device) < C).to(chol_kuu.dtype)
    jitter_pad = jitter * torch.eye(Mc, dtype=chol_kuu.dtype, device=chol_kuu.device) * cond
    return chol_kuu @ pad + jitter_pad


def _rff_features(x: torch.Tensor, omega: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """cos features: ``x [..., L, A], omega/phase [..., L, B] -> [..., L, A, B]``."""
    return torch.cos(x[..., :, None] * omega[..., None, :] + phase[..., None, :])


def draw_noise(batch: tuple, L: int, Mc: int, num_samples: int, num_bases: int, dtype, device,
               generator: Optional[torch.Generator] = None, kernel: str = "matern52",
               antithetic: bool = False, df: float = 5.0) -> PathNoise:
    """Draw the :class:`PathNoise` of one :func:`draw_paths` call."""
    shape = batch + (L, num_bases)
    if kernel == "matern52":
        t = student_t(df, shape, dtype, device, generator)
    elif kernel == "se":
        t = torch.randn(shape, dtype=dtype, device=device, generator=generator)
    else:
        raise ValueError(f"no spectral sampler for kernel {kernel!r}")
    phase = TWO_PI * torch.rand(shape, dtype=dtype, device=device, generator=generator)

    def normal(trailing):
        if not antithetic:
            return torch.randn(batch + (num_samples,) + trailing, dtype=dtype, device=device,
                               generator=generator)
        # paired +g/-g draws; an odd sample count keeps one unpaired draw
        half = torch.randn(batch + ((num_samples + 1) // 2,) + trailing, dtype=dtype,
                           device=device, generator=generator)
        return torch.cat([half, -half], dim=len(batch)).narrow(len(batch), 0, num_samples)

    return PathNoise(t=t, phase=phase, w=normal((L, num_bases)), eps=normal((L, Mc)))


class _Draw(NamedTuple):
    """What :func:`draw_paths` knows before its solve."""

    omega: torch.Tensor
    noise: PathNoise
    rff_scale: torch.Tensor
    rhs: torch.Tensor  # [..., L, Mc, S], island dtype: the solve's right-hand side


def _draw_rhs(ny, Z, lengthscales, variance, Mc: int, solve_dtype, q_mu_full, q_sqrt,
              num_samples: int, num_bases: int, df: float, jitter: float, kernel: str,
              antithetic: bool, generator, noise) -> _Draw:
    L = Z.shape[-1]
    bulk = Z.dtype
    if noise is None:
        noise = draw_noise(tuple(Z.shape[:-2]), L, Mc, num_samples, num_bases, bulk, Z.device,
                           generator, kernel, antithetic, df)
    omega = noise.t / lengthscales[..., None]
    rff_scale = torch.sqrt(2.0 * variance[..., None] / num_bases).to(bulk)

    zy_ = zy_fn(ny, Z).to(bulk)
    phi_z = _rff_features(zy_, omega, noise.phase) * rff_scale[..., None]
    f_prior_z = torch.einsum("...lmb,...slb->...slm", phi_z, noise.w)  # [..., S, L, Mc]

    C = Mc - q_sqrt.shape[-1]
    cond_rows = (torch.arange(Mc, device=Z.device) < C).to(bulk)
    rhs = (
        q_mu_full.transpose(-1, -2)[..., None].to(bulk)
        - f_prior_z.movedim(-3, -1)
        + jitter * (noise.eps * cond_rows).movedim(-3, -1)
    )  # [..., L, Mc, S]
    return _Draw(omega=omega, noise=noise, rff_scale=rff_scale, rhs=rhs.to(solve_dtype))


def _draw_state(d: _Draw, a_solve: torch.Tensor, chol_kuu: torch.Tensor, q_sqrt) -> PathState:
    """The drawn paths from ``a_solve = L⁻¹ rhs [..., L, Mc, S]``."""
    bulk = d.omega.dtype
    eps = d.noise.eps
    C = chol_kuu.shape[-1] - q_sqrt.shape[-1]
    pad_eps = torch.einsum("...lmn,...sln->...slm", torch.tril(q_sqrt).to(bulk), eps[..., C:])
    pad_eps = torch.cat([torch.zeros(pad_eps.shape[:-1] + (C,), dtype=bulk, device=eps.device),
                         pad_eps], dim=-1)
    a = a_solve.movedim(-1, -3).to(bulk) + pad_eps  # [..., S, L, Mc]
    return PathState(omega=d.omega, phase=d.noise.phase, w=d.noise.w, a=a,
                     rff_scale=d.rff_scale, chol=chol_kuu)


def draw_paths(ny, Z, lengthscales, variance, chol_kuu, q_mu_full, q_sqrt, num_samples: int,
               num_bases: int, df: float = 5.0, jitter: float = 1e-6, kernel: str = "matern52",
               antithetic: bool = False, generator: Optional[torch.Generator] = None,
               noise: Optional[PathNoise] = None) -> PathState:
    """Draw S function samples.

    ``ny [C]``, ``Z [..., M, L]``, ``lengthscales``/``variance [..., L]``,
    ``chol_kuu [..., L, Mc, Mc]``, ``q_mu_full [..., Mc, L]``,
    ``q_sqrt [..., L, M, M]``. ``noise`` replaces the generator's draws.
    """
    d = _draw_rhs(ny, Z, lengthscales, variance, chol_kuu.shape[-1], chol_kuu.dtype, q_mu_full,
                  q_sqrt, num_samples, num_bases, df, jitter, kernel, antithetic, generator, noise)
    return _draw_state(d, linalg.solve_lower(chol_kuu, d.rhs), chol_kuu, q_sqrt)


def _eval_whitened(state: PathState, A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """:func:`eval_paths` from ``A = L⁻¹ kuf [..., L, Mc, N]``."""
    bulk = state.omega.dtype
    Xb = X.to(bulk).expand(state.omega.shape[:-1] + (X.shape[0],))
    phi_x = _rff_features(Xb, state.omega, state.phase) * state.rff_scale[..., None]
    f_prior = torch.einsum("...lnb,...slb->...sln", phi_x, state.w)
    update = torch.einsum("...lmn,...slm->...sln", A.to(bulk), state.a)
    return (f_prior + update).transpose(-1, -2)


def eval_paths(state: PathState, kuf: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Evaluate drawn paths on the grid ``X [N]``: ``kuf [..., L, Mc, N]`` ->
    latent samples ``[..., S, N, L]``."""
    return _eval_whitened(state, linalg.solve_lower(state.chol, kuf.to(state.chol.dtype)), X)


def draw_and_eval_paths(ny, Z, lengthscales, variance, kuu, kuf, X, q_mu_full, q_sqrt,
                        num_samples: int, num_bases: int, df: float = 5.0, jitter: float = 1e-6,
                        kernel: str = "matern52", antithetic: bool = False,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[PathNoise] = None):
    """:func:`draw_paths` and :func:`eval_paths` from the Gram ``kuu
    [..., L, Mc, Mc]`` itself: the draw's right-hand side, ``kuf`` and the
    variational mean ``q_mu_full`` share the factor and depend on neither it
    nor each other, so they go through one
    :func:`vgpmp_torch.ops.linalg.factor_solve` side by side. Columns are
    solved independently, so the result is that of the separate calls.

    Returns ``(chol(kuu), PathState, latent samples [..., S, N, L], whitened
    mean L⁻¹ q_mu_fullᵀ [..., L, Mc, 1])``.
    """
    d = _draw_rhs(ny, Z, lengthscales, variance, kuu.shape[-1], kuu.dtype, q_mu_full, q_sqrt,
                  num_samples, num_bases, df, jitter, kernel, antithetic, generator, noise)
    mean = q_mu_full.transpose(-1, -2)[..., None].to(kuu.dtype)
    chol_kuu, sol = linalg.factor_solve(kuu, torch.cat([d.rhs, kuf.to(kuu.dtype), mean], dim=-1))
    a_solve, A, m_w = torch.split(sol, [d.rhs.shape[-1], kuf.shape[-1], 1], dim=-1)
    state = _draw_state(d, a_solve, chol_kuu, q_sqrt)
    return chol_kuu, state, _eval_whitened(state, A, X), m_w
