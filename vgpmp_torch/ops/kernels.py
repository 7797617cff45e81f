"""Stationary kernels over scalar time, batched per latent GP.

Port of ``vgpmp_tpu/ops/kernels.py``: inputs ``[..., L, A] x [..., L, B]``
with per-latent hyperparameters ``[..., L]`` give a Gram ``[..., L, A, B]``.
:data:`KERNELS` maps a name to the kernel itself; :data:`KERNEL_DERIVATIVES`
maps it to the pair ``(d/dx1, d²/dx1dx2)`` that the velocity-constrained
inducing set needs, with JAX's sign conventions.
"""

from __future__ import annotations

import torch

__all__ = ["matern52", "matern52_grad", "matern52_grad_grad", "squared_exponential", "se_grad",
           "se_grad_grad", "KERNELS", "KERNEL_DERIVATIVES"]

SQRT_5 = 2.2360679774997898
FIVE_THIRDS = 5.0 / 3.0


def _pairwise_diff(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return x1[..., :, None] - x2[..., None, :]


def _bcast_hyp(h):
    """Per-latent hyperparameter ``[..., L]`` (or a scalar) -> ``[..., L, 1, 1]``."""
    if not torch.is_tensor(h) or h.ndim == 0:
        return h
    return h[..., None, None]


def matern52(x1, x2, lengthscales, variance) -> torch.Tensor:
    """Matérn-5/2: ``k(r) = s2 (1 + √5 r/l + 5 r²/(3 l²)) exp(-√5 r/l)``."""
    l = _bcast_hyp(lengthscales)
    s2 = _bcast_hyp(variance)
    r = torch.abs(_pairwise_diff(x1, x2)) / l
    s5r = SQRT_5 * r
    return s2 * (1.0 + s5r + (5.0 / 3.0) * r * r) * torch.exp(-s5r)


def matern52_grad(x1, x2, lengthscales, variance) -> torch.Tensor:
    """The reference's negated slope of Matérn-5/2,
    ``s2 5/3 (1 + √5 r/l) exp(-√5 r/l) (x1 - x2) / l²``: positive for
    ``x1 > x2``, so ``dk/dx1`` is its negative."""
    l = _bcast_hyp(lengthscales)
    s2 = _bcast_hyp(variance)
    diff = _pairwise_diff(x1, x2)
    s5r = SQRT_5 * torch.abs(diff) / l
    return s2 * FIVE_THIRDS * (1.0 + s5r) * torch.exp(-s5r) * diff / (l * l)


def matern52_grad_grad(x1, x2, lengthscales, variance) -> torch.Tensor:
    """``∂²k/∂x1∂x2`` of Matérn-5/2, ``-s2 5/3 (5 r² - √5 r - 1) exp(-√5 r) / l²``
    with ``r = |x1 - x2| / l``; at ``r = 0`` this is the exact limit
    ``s2 5/(3 l²)``."""
    l = _bcast_hyp(lengthscales)
    s2 = _bcast_hyp(variance)
    r = torch.abs(_pairwise_diff(x1, x2)) / l
    s5r = SQRT_5 * r
    return -s2 * FIVE_THIRDS * (5.0 * r * r - s5r - 1.0) * torch.exp(-s5r) / (l * l)


def squared_exponential(x1, x2, lengthscales, variance) -> torch.Tensor:
    l = _bcast_hyp(lengthscales)
    s2 = _bcast_hyp(variance)
    diff = _pairwise_diff(x1, x2)
    return s2 * torch.exp(-0.5 * (diff / l) ** 2)


def se_grad(x1, x2, lengthscales, variance) -> torch.Tensor:
    """``∂k/∂x1`` of the squared exponential, ``-(x1 - x2)/l² k`` (the true
    derivative; the reference returns its negative)."""
    l = _bcast_hyp(lengthscales)
    diff = _pairwise_diff(x1, x2)
    return -(diff / (l * l)) * squared_exponential(x1, x2, lengthscales, variance)


def se_grad_grad(x1, x2, lengthscales, variance) -> torch.Tensor:
    """``∂²k/∂x1∂x2`` of the squared exponential, ``(l² - diff²)/l⁴ k``."""
    l = _bcast_hyp(lengthscales)
    diff = _pairwise_diff(x1, x2)
    return (l * l - diff * diff) / (l ** 4) * squared_exponential(x1, x2, lengthscales, variance)


KERNELS = {"matern52": matern52, "se": squared_exponential}
KERNEL_DERIVATIVES = {"matern52": (matern52_grad, matern52_grad_grad), "se": (se_grad, se_grad_grad)}
