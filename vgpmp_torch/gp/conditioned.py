"""Conditioned-inducing-set covariance assembly.

Port of ``vgpmp_tpu/gp/conditioned.py``: the inducing inputs are
``Zy = [ny; Z]``, with ``ny`` the two clamped timesteps (t=0, t=1). Shapes
carry any leading batch axes: ``Z [..., M, L]``, hyperparameters ``[..., L]``,
Grams ``[..., L, Mc, Mc]`` with ``Mc = C + M``.
"""

from __future__ import annotations

from typing import Callable

import torch

from vgpmp_torch.ops import linalg
from vgpmp_torch.utils.profiling import span

__all__ = ["zy", "grid_rows", "kuu", "kuf", "cholesky_kuu"]

KernelFn = Callable[..., torch.Tensor]


def zy(ny: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Conditioned inducing inputs per latent: ``[C], [..., M, L] -> [..., L, C+M]``."""
    L = Z.shape[-1]
    ny_b = ny.expand(Z.shape[:-2] + (L, ny.shape[0]))
    return torch.cat([ny_b, Z.transpose(-1, -2)], dim=-1)


def grid_rows(X: torch.Tensor, batch: tuple, L: int) -> torch.Tensor:
    """The time grid per latent row, ``[..., L, N]``: ``X [N]`` is shared by
    every problem; ``X [B, N]`` gives each problem (the leading axis of
    ``batch``) its own grid."""
    if X.ndim > 1:
        X = X[..., None, :]
    return X.expand(batch + (L, X.shape[-1]))


def kuu(kernel: KernelFn, ny, Z, lengthscales, variance, jitter: float = 1e-6,
        solve_dtype=None) -> torch.Tensor:
    """Conditioned Gram ``[..., L, Mc, Mc]`` with jitter on the diagonal,
    assembled in ``solve_dtype`` (default: the input dtype)."""
    if solve_dtype is not None:
        ny, Z = ny.to(solve_dtype), Z.to(solve_dtype)
        lengthscales, variance = lengthscales.to(solve_dtype), variance.to(solve_dtype)
    zy_ = zy(ny, Z)
    K = kernel(zy_, zy_, lengthscales, variance)
    return K + jitter * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def kuf(kernel: KernelFn, ny, Z, X, lengthscales, variance, solve_dtype=None) -> torch.Tensor:
    """Cross-covariance ``k(Zy, X)``: ``[..., L, Mc, N]`` for the time grid
    ``X [N]`` or one grid per problem, ``X [B, N]`` (:func:`grid_rows`)."""
    if solve_dtype is not None:
        ny, Z, X = ny.to(solve_dtype), Z.to(solve_dtype), X.to(solve_dtype)
        lengthscales, variance = lengthscales.to(solve_dtype), variance.to(solve_dtype)
    return kernel(zy(ny, Z), grid_rows(X, Z.shape[:-2], Z.shape[-1]), lengthscales, variance)


def cholesky_kuu(kernel: KernelFn, ny, Z, lengthscales, variance, jitter: float = 1e-6,
                 solve_dtype=None, escalations: int = 0, with_info: bool = False):
    """``(Kuu, chol(Kuu))``, both ``[..., L, Mc, Mc]``.

    ``escalations``: where a factor comes out non-finite, retry with 10x
    (then 100x, ...) jitter, selected per latent row. ``with_info`` also
    returns, per problem (int32 ``[...]``), the number of latent rows that
    needed at least one escalation. The Gram's build runs under the
    ``torch.profiler`` label ``model.gram``, its factor under ``model.k2``.
    """
    with span("model.gram"):
        K = kuu(kernel, ny, Z, lengthscales, variance, jitter=jitter, solve_dtype=solve_dtype)
    with span("model.k2"):
        chol = linalg.chol(K)
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        ever_bad = torch.zeros(K.shape[:-2], dtype=torch.bool, device=K.device)
        for e in range(escalations):
            bad = ~torch.isfinite(chol).all(dim=-1).all(dim=-1)
            ever_bad = ever_bad | bad
            K_retry = K + (10.0 ** (e + 1)) * jitter * eye
            chol_retry = linalg.chol(K_retry)
            chol = torch.where(bad[..., None, None], chol_retry, chol)
            K = torch.where(bad[..., None, None], K_retry, K)
        if with_info:
            return K, chol, ever_bad.to(torch.int32).sum(dim=-1)
    return K, chol
