"""Velocity-conditioned (first-derivative) inducing structure.

Port of ``vgpmp_tpu/gp/velocity.py``. The extended inducing set is

    rows = [ f'(ny) (C rows) ; f(ny) (C rows) ; f(Z) (M rows) ]

so that the endpoint velocities (0 at rest) are clamped beside the
positions. The Gram blocks are the exact covariances of a differentiated GP:
``cov(f'(s), f'(t)) = ∂²k/∂s∂t`` (``matern52_grad_grad``) and
``cov(f'(s), f(t)) = ∂k/∂s`` (the negative of ``matern52_grad``). Shapes
carry the port's leading batch axes, as ``gp/conditioned.py`` does:
``Z [..., M, L]``, hyperparameters ``[..., L]``, Grams
``[..., L, 2C+M, 2C+M]``.
"""

from __future__ import annotations

import torch

from vgpmp_torch.gp.conditioned import grid_rows, zy as zy_fn
from vgpmp_torch.ops import kernels as K

__all__ = ["deriv_mask", "kuu_velocity", "kuf_velocity", "extend_q_mu"]


def _cast(solve_dtype, *tensors):
    if solve_dtype is None:
        return tensors
    return tuple(t.to(solve_dtype) for t in tensors)


def deriv_mask(C: int, M: int, device=None) -> torch.Tensor:
    """``[2C + M]`` bool mask of the derivative rows (the first C)."""
    return torch.arange(2 * C + M, device=device) < C


def _ny_rows(ny: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``ny`` per latent row, ``[..., L, C]``."""
    return ny.expand(Z.shape[:-2] + (Z.shape[-1], ny.shape[0]))


def kuu_velocity(ny, Z, lengthscales, variance, jitter: float = 1e-6,
                 solve_dtype=None) -> torch.Tensor:
    """Extended conditioned Gram ``[..., L, 2C+M, 2C+M]`` with jitter on the
    diagonal: ``[[K_dd(ny, ny), K_d(ny, Zy)], [K_d(ny, Zy)ᵀ, K(Zy, Zy)]]``."""
    ny, Z, lengthscales, variance = _cast(solve_dtype, ny, Z, lengthscales, variance)
    zy_ = zy_fn(ny, Z)      # [..., L, C+M]
    ny_b = _ny_rows(ny, Z)  # [..., L, C]
    k_vv = K.matern52(zy_, zy_, lengthscales, variance)
    k_dd = K.matern52_grad_grad(ny_b, ny_b, lengthscales, variance)
    k_dv = -K.matern52_grad(ny_b, zy_, lengthscales, variance)  # cov(f'(ny), f(Zy))
    top = torch.cat([k_dd, k_dv], dim=-1)
    bottom = torch.cat([k_dv.transpose(-1, -2), k_vv], dim=-1)
    Kmm = torch.cat([top, bottom], dim=-2)
    return Kmm + jitter * torch.eye(Kmm.shape[-1], dtype=Kmm.dtype, device=Kmm.device)


def kuf_velocity(ny, Z, X, lengthscales, variance, solve_dtype=None) -> torch.Tensor:
    """Extended cross-covariance ``[..., L, 2C+M, N]``, the derivative rows on
    top, for the grid ``X [N]`` or one grid per problem ``X [B, N]``
    (:func:`vgpmp_torch.gp.conditioned.grid_rows`)."""
    ny, Z, X, lengthscales, variance = _cast(solve_dtype, ny, Z, X, lengthscales, variance)
    Xb = grid_rows(X, Z.shape[:-2], Z.shape[-1])
    k_df = -K.matern52_grad(_ny_rows(ny, Z), Xb, lengthscales, variance)  # cov(f'(ny), f(X))
    k_vf = K.matern52(zy_fn(ny, Z), Xb, lengthscales, variance)
    return torch.cat([k_df, k_vf], dim=-2)


def extend_q_mu(velocities: torch.Tensor, query_states: torch.Tensor,
                q_mu: torch.Tensor) -> torch.Tensor:
    """``[..., C, L], [..., C, L], [..., M, L] -> [..., 2C+M, L]``: the full
    mean with the clamped rows in front."""
    return torch.cat([velocities, query_states, q_mu], dim=-2)
